"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of the JAX package's ``launch/train.py``).

It trains the smoke config (``get_smoke_config``) by default and the full
config with ``--full``, from the port's seeded weights, on the synthetic
``train_batches`` stream; an encoder-decoder's batches also carry seeded
audio frames (``data.with_audio``).  It prints the reference's lines: the
arch, its parameter count and the devices, then the loss at step 1 and
every tenth of the run; ``--ckpt PATH`` writes the parameters and the
step there at the end, in the reference's checkpoint format.

It runs on the card and raises without one; ``--device cpu`` runs on the
CPU.  Every family trains, the SSM (mamba2-130m) and the hybrid
(hymba-1.5b) included; theirs need ``--seq`` to be a multiple of
``ssm_chunk``, as the reference asserts.  Not ported: the reference's mesh
(one card).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import train_batches, with_audio
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, train


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train a model on the synthetic causal-LM stream.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the card)")
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    n = sum(p.numel() for p in params.parameters())
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} params={n / 1e6:.1f}M devices={devices}")

    data = train_batches(batch=args.batch, seq=args.seq,
                         vocab=cfg.vocab_size, d_model=cfg.d_model)
    if cfg.is_encoder_decoder:
        data = with_audio(data, encoder_seq=cfg.encoder_seq,
                          d_model=cfg.d_model)
    tc = TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                     ckpt_every=args.steps if args.ckpt else 0,
                     **({"ckpt_path": args.ckpt} if args.ckpt else {}))
    return train(model, params, data, tc)


if __name__ == "__main__":
    main()
