"""The training loop (port of the JAX package's ``training/train_loop.py``):
a train step, logging and checkpoints.

The step runs eagerly where the reference jits it and donates the
parameters and the optimizer state: the gradients come from
``torch.autograd.grad`` through :meth:`~repro_torch.models.model.Model.
loss`, and the update is added to each parameter in place under
``torch.no_grad()`` (what donation buys the reference: no second copy of
the parameters).  Parameters carry ``requires_grad`` only inside a step.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import (
    AdamW,
    AdamWState,
    apply_updates,
    cosine_warmup,
)
from repro_torch.weights import reference_tree


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_path: str = os.path.join(tempfile.gettempdir(),
                                  "repro_torch_ckpt.msgpack")
    peak_lr: float = 3e-4
    warmup: int = 20


def value_and_grad(model: Model, params, batch):
    """(the loss, detached; {parameter name: its gradient}) of
    ``model.loss(params, batch)``, as ``jax.value_and_grad`` gives them."""
    named = dict(params.named_parameters())
    leaves = list(named.values())
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), dict(zip(named, grads))


def make_train_step(model: Model, opt: AdamW):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    loss)``: ``params`` (a ``Transformer``) is updated in place and
    returned; ``batch`` is a dict of tensors on the parameters' device."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(model, params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def train(model: Model, params, data: Iterator[dict],
          cfg: TrainConfig = TrainConfig(), *, opt: Optional[AdamW] = None):
    """``cfg.steps`` steps over ``data`` (dicts of numpy arrays, moved to
    the parameters' device), logging the loss at step 1 and every
    ``log_every`` steps as the reference does, and writing
    ``{"params": reference_tree(params), "step": step}`` every
    ``ckpt_every`` steps.  Returns (params, opt_state, [(step, loss)])."""
    opt = opt or AdamW(lr=cosine_warmup(cfg.peak_lr, cfg.warmup, cfg.steps))
    device = params.embed.device
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    history = []
    t0 = time.perf_counter()
    for step in range(1, cfg.steps + 1):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if step % cfg.log_every == 0 or step == 1:
            loss_f = float(loss)
            history.append((step, loss_f))
            print(f"step {step:5d}  loss {loss_f:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if cfg.ckpt_every and step % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_path, {"params": reference_tree(params),
                                            "step": step})
    return params, opt_state, history
