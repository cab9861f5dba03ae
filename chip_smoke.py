#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``: the kernels are
built from ``src/repro_torch/csrc`` at first use), and no JAX.  Phases, each
timed on its own line:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build the four CUDA kernels (one ``nvcc`` per source, in parallel);
3. serve full-width llava-1.6-7b (seeded random weights) on a bf16 page
   pool: four two-image MMDU-style dialogues (576-token images, mpic k=32,
   8 new tokens each) plus one MRAG-linked image, through the engine a user
   calls; the prefill and decode kernels must have launched;
4. the same traffic on an int8 page pool, through the int8 kernels;
5. each kernel against its plain PyTorch version on the pool state that
   phases 3 and 4 wrote (layer 0, live page tables and lengths), and on a
   synthetic GQA shape (32 query heads on 8 kv heads, window 64), then
   timed beside its plain version, a PyTorch yardstick and its bound;
   the limit is per element (``repro_torch/kernels/check.py``): one bf16
   ulp of the value for bf16 outputs, 1e-4 for fp32 ones;
6. a small fp32 model served by the same engine on the card and on the CPU
   (plain versions): same greedy tokens, first-token logits within 1e-3.

It prints one JSON line ``{"kernels": [...]}``, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before the last line.  Without a card it exits 2.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
K_MPIC = 32
MAX_NEW = 8
KERNEL_FILES = {
    "sel_attn_paged": ("src/repro_torch/csrc/selective_attn.cu",
                       "src/repro/kernels/selective_attn/selective_attn.py:77"),
    "sel_attn_paged_q8": ("src/repro_torch/csrc/selective_attn.cu",
                          "src/repro/kernels/selective_attn/selective_attn.py:127"),
    "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                   "src/repro/kernels/paged_attn/paged_attn.py:22"),
    "paged_attn_q8": ("src/repro_torch/csrc/paged_attn.cu",
                      "src/repro/kernels/paged_attn/paged_attn.py:70"),
}
TOLERANCE = ("per element: bf16 one ulp of max(|out|,|ref|) + 2^-17 max|V|, "
             "fp32 1e-4 (repro_torch/kernels/check.py)")
LIBRARY_CALL = ("torch.nn.functional.scaled_dot_product_attention over K/V "
                "gathered (and dequantized) beforehand, gather excluded")


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.linker import bucket
    from repro_torch.core.select import mpic_selection, selection_indices
    from repro_torch.data import image_embeds, make_dialogues
    from repro_torch.device import resolve_device
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.check import compare, v_absmax
    from repro_torch.kernels.paged_attn.ops import paged_attention
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    from repro_torch.kernels.selective_attn.ops import (
        selective_attention_paged,
    )
    from repro_torch.kernels.selective_attn.ref import (
        selective_attention_paged_ref,
    )
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MPICEngine, Request, State

    # fp32 products in full fp32 on the card (the CPU reference has no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"built {sorted(secs)} in {secs}")
    phase("build", t0)

    # -- 3/4. serve full-width llava-1.6-7b -----------------------------------
    cfg = get_config("llava-1.6-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{nbytes / 2**30:.2f} GiB of seeded weights")
    phase("init", t0)

    def serve(pool_dtype: str):
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=2048, decode_slots=4, page_size=16,
            pool_dtype=pool_dtype))
        samples = make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                                 media_len=cfg.media_token_len, style="mmdu")
        t_up = time.perf_counter()
        for s in samples:
            for _, seg in s.prompt.media_segments():
                eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
        rag = image_embeds("rag-0", cfg.media_token_len, cfg.d_model)
        eng.upload("*", "rag-0", rag, dynamic=True)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t_up
        reqs = [Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                        policy_kwargs={"k": K_MPIC}) for s in samples]
        reqs[-1].retrieval_query = rag.mean(0)

        firsts, nonfinite = {}, []
        finalize, decode_step = eng._finalize_prefill, eng._decode_paged_step

        def record_first(req, result):
            firsts[req.req_id] = result.first_logits
            if not np.isfinite(result.first_logits).all():
                nonfinite.append(f"first logits of {req.req_id}")
            return finalize(req, result)

        def checked_decode(live):
            live, logits = decode_step(live)
            if logits is not None and not np.isfinite(
                    logits[[r.slot for r in live]]).all():
                nonfinite.append("decode logits")
            return live, logits

        eng._finalize_prefill = record_first
        eng._decode_paged_step = checked_decode
        snap = None
        _build.reset_launches(KERNELS.values())     # count the main path only
        t_serve = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        steps = 0
        while eng.queue or any(eng.running):
            eng.step()
            steps += 1
            if steps > 10 * MAX_NEW * len(reqs):
                raise RuntimeError("engine made no progress")
            if snap is None and all(r is not None and r.state is State.RUNNING
                                    for r in eng.running):
                snap = snapshot(eng)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        launches = {k: v.launches for k, v in KERNELS.items()}

        if nonfinite:
            raise RuntimeError(f"non-finite logits: {nonfinite}")
        for r in reqs:
            if not r.done or len(r.output_tokens) != MAX_NEW:
                raise RuntimeError(f"{r.req_id} did not finish: {r.state}")
        if "rag-0" not in reqs[-1].linked_media:
            raise RuntimeError("MRAG did not link its image")
        if snap is None:
            raise RuntimeError("never saw all slots running")
        rep = eng.report()
        tokens = rep["total_tokens"]
        print(f"  prompts {[r.prompt.total_len for r in reqs]} tokens, "
              f"recomputed {[r.prefill_stats['n_recomputed'] for r in reqs]}, "
              f"linked {reqs[-1].linked_media}")
        print(f"  uploads {upload_s:.3f} s for 9 images; served {len(reqs)} "
              f"requests in {serve_s:.3f} s ({steps} steps)")
        print(f"  TTFT mean {rep['mean_ttft_s'] * 1e3:.2f} ms (p90 "
              f"{rep['p90_ttft_s'] * 1e3:.2f} ms, prefill alone "
              f"{rep['mean_prefill_s'] * 1e3:.2f} ms); decode step mean "
              f"{rep['mean_decode_step_s'] * 1e3:.2f} ms over "
              f"{rep['decode_steps']} steps; {tokens / serve_s:.1f} tokens/s")
        print(f"  launches {launches}", flush=True)
        return reqs, firsts, launches, snap, eng

    def snapshot(eng):
        """Layer 0 of the pool and the live decode / newest prefill shapes."""
        pool, ps = eng.pool, eng.cfg.page_size
        lengths = np.asarray([r.cur_len for r in eng.running], np.int32)
        mp = bucket(max(pool.pages_for(int(n)) for n in lengths), 1)
        last = max(eng.running, key=lambda r: r.t_admitted)
        sel = selection_indices(mpic_selection(last.prompt, K_MPIC))
        q_pos = np.zeros((bucket(len(sel), 16),), np.int32)
        q_pos[:len(sel)] = sel
        row = eng._page_tables[last.slot]
        pmp = min(bucket(pool.pages_for(last.prompt.total_len)), len(row))
        q8 = pool.quantized
        return {
            "k": pool.k[0].clone(), "v": pool.v[0].clone(),
            "ks": pool.k_scale[0].clone() if q8 else None,
            "vs": pool.v_scale[0].clone() if q8 else None,
            "decode_pt": torch.as_tensor(eng._page_tables[:, :mp].copy(),
                                         device=dev),
            "decode_len": torch.as_tensor(lengths, device=dev),
            "prefill_pt": torch.as_tensor(row[None, :pmp].copy(), device=dev),
            "q_pos": torch.as_tensor(q_pos[None], device=dev),
            "prefill_len": torch.tensor([last.prompt.total_len],
                                        dtype=torch.int32, device=dev),
            "n_sel": len(sel), "ps": ps,
        }

    t0 = time.perf_counter()
    print("serve, bf16 pool:")
    reqs16, firsts16, launches16, snap16, eng = serve("")
    del eng                 # its pool: the wrapped methods make a cycle
    gc.collect()
    torch.cuda.empty_cache()
    phase("serve_bf16", t0)
    t0 = time.perf_counter()
    print("serve, int8 pool:")
    reqs8, firsts8, launches8, snap8, eng = serve("int8")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    agree = sum(a.output_tokens[0] == b.output_tokens[0]
                for a, b in zip(reqs16, reqs8))
    print(f"  first tokens equal to the bf16 pool's: {agree}/{len(reqs8)} "
          "(information only)")
    phase("serve_int8", t0)
    for name, launches in (("sel_attn_paged", launches16),
                           ("paged_attn", launches16),
                           ("sel_attn_paged_q8", launches8),
                           ("paged_attn_q8", launches8)):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} never launched on the main path")

    # -- 5. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, dh = cfg.num_heads, cfg.head_dim

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def events_ms(fn, iters: int) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def gather(pool, scale, pt, ps, dtype):
        """(B, mp*ps, Hkv, Dh) in ``dtype``: the pages of ``pt`` in order."""
        b, mp = pt.shape
        g = pool[pt.long()].reshape(b, mp * ps, *pool.shape[2:]).float()
        if scale is not None:
            g = g * scale[pt.long()].repeat_interleave(ps, dim=1)[..., None]
        return g.to(dtype)

    def valid_keys_decode(lens, ps, mp, window):
        hi = np.minimum(lens, mp * ps)
        lo = np.maximum(0, lens - window) if window > 0 else 0
        return np.maximum(hi - lo, 0)

    def valid_keys_prefill(q_pos, length, window):
        n = np.minimum(q_pos + 1, length)
        if window > 0:
            n = n - np.maximum(0, q_pos - window + 1)
        return np.maximum(n, 0)

    def bound(nbytes, flops, dtype):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["bfloat16" if dtype == torch.bfloat16
                                   else "float32"]
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def decode_case(q, k, v, ks, vs, pt, lens, window):
        out = paged_attention(q, k, v, pt, lens, k_scale=ks, v_scale=vs,
                              window=window)
        ref = paged_attention_ref(q, k, v, pt, lens, ks, vs, window=window)
        return compare(out, ref, v_absmax(v, vs), rows=lens > 0), out

    def prefill_case(q, k, v, ks, vs, pt, q_pos, lens, window):
        out = selective_attention_paged(q, k, v, pt, q_pos, lens,
                                        k_scale=ks, v_scale=vs, window=window)
        ref = selective_attention_paged_ref(
            q.transpose(1, 2), k, v, pt, q_pos, lens, ks, vs,
            window=window).transpose(1, 2)
        return compare(out, ref, v_absmax(v, vs)), out

    results = {}
    window = cfg.sliding_window
    for name, snap in (("paged_attn", snap16), ("paged_attn_q8", snap8)):
        k, v, ks, vs, ps = snap["k"], snap["v"], snap["ks"], snap["vs"], \
            snap["ps"]
        pt, lens = snap["decode_pt"], snap["decode_len"]
        b, mp = pt.shape
        q = randn(b, hq, dh, dtype=torch.bfloat16)
        check, _ = decode_case(q, k, v, ks, vs, pt, lens, window)
        if not check["worst"] <= 1.0:
            raise RuntimeError(f"{name}: main-path error {check}")
        kg = gather(k, ks, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        vg = gather(v, vs, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        idx = torch.arange(mp * ps, device=dev)[None]
        mask = idx < lens[:, None]
        if window > 0:
            mask &= idx > lens[:, None] - 1 - window
        q4 = q[:, :, None, :]
        n_keys = valid_keys_decode(lens.cpu().numpy(), ps, mp, window)
        kv_item = k.element_size()
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * int(n_keys.sum()) * k.shape[2] * dh * kv_item
                  + pt.numel() * 4 + lens.numel() * 4
                  + (2 * int(np.ceil(n_keys / ps).sum()) * k.shape[2] * 4
                     if ks is not None else 0))
        flops = 4 * dh * hq * int(n_keys.sum())
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        results[name] = {
            **check, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": events_ms(lambda: paged_attention(
                q, k, v, pt, lens, k_scale=ks, v_scale=vs, window=window), 50),
            "plain_ms": events_ms(lambda: paged_attention_ref(
                q, k, v, pt, lens, ks, vs, window=window), 10),
            "library_ms": events_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask[:, None, None, :]), 50),
            "shape": f"q {tuple(q.shape)} bf16, pool layer 0 {k.dtype}, "
                     f"page table {tuple(pt.shape)}, lengths "
                     f"{lens.tolist()}, window {window}"}

    for name, snap in (("sel_attn_paged", snap16),
                       ("sel_attn_paged_q8", snap8)):
        k, v, ks, vs, ps = snap["k"], snap["v"], snap["ks"], snap["vs"], \
            snap["ps"]
        pt, q_pos, lens = snap["prefill_pt"], snap["q_pos"], \
            snap["prefill_len"]
        n_sel = snap["n_sel"]
        b, sq = q_pos.shape
        mp = pt.shape[1]
        q = randn(b, sq, hq, dh, dtype=torch.bfloat16)
        check, _ = prefill_case(q, k, v, ks, vs, pt, q_pos, lens, window)
        if not check["worst"] <= 1.0:
            raise RuntimeError(f"{name}: main-path error {check}")
        kg = gather(k, ks, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        vg = gather(v, vs, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        idx = torch.arange(mp * ps, device=dev)[None, None, :]
        qp = q_pos[:, :, None]
        mask = (idx < lens[:, None, None]) & (idx <= qp)
        if window > 0:
            mask &= idx > qp - window
        qt = q.transpose(1, 2).contiguous()
        length = int(lens[0])
        qp_np = q_pos[0].cpu().numpy()
        n_keys = valid_keys_prefill(qp_np, length, window)
        read_keys = min(length, int(qp_np.max()) + 1)
        nbytes = (2 * q.numel() * q.element_size() + q_pos.numel() * 4
                  + 2 * read_keys * k.shape[2] * dh * k.element_size()
                  + pt.numel() * 4 + 4
                  + (2 * -(-read_keys // ps) * k.shape[2] * 4
                     if ks is not None else 0))
        flops = 4 * dh * hq * int(n_keys.sum())
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        results[name] = {
            **check, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": events_ms(lambda: selective_attention_paged(
                q, k, v, pt, q_pos, lens, k_scale=ks, v_scale=vs,
                window=window), 20),
            "plain_ms": events_ms(lambda: selective_attention_paged_ref(
                qt, k, v, pt, q_pos, lens, ks, vs, window=window), 5),
            "library_ms": events_ms(lambda: F.scaled_dot_product_attention(
                qt, kg, vg, attn_mask=mask[:, None]), 20),
            "shape": f"q {tuple(q.shape)} bf16 ({n_sel} selected), "
                     f"pool layer 0 "
                     f"{k.dtype}, page table {tuple(pt.shape)}, length "
                     f"{length}, window {window}"}
    del snap16, snap8
    for name, r in results.items():
        print(f"  {name}: main path max |err| {r['max_abs_err']:.3e}, "
              f"max |ref| {r['max_abs_ref']:.3e}, err/limit "
              f"{r['worst']:.3f}")

    # synthetic shape: GQA group 4 with a window that bites, fp32 q, a
    # ragged query count, an idle row and scratch-padded page tables
    syn_hq, syn_hkv, syn_win, syn_ps, syn_p = 32, 8, 64, 16, 160
    syn_lens = [0, 300, 1000]
    perm = torch.randperm(syn_p - 1, generator=gen, device=dev) + 1
    syn_pt = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(syn_lens):
        npg = -(-n // syn_ps)
        syn_pt[i, :npg] = perm[used:used + npg]
        used += npg
    lens = torch.tensor(syn_lens, dtype=torch.int32, device=dev)
    shape = (syn_p, syn_ps, syn_hkv, dh)
    pools = {
        False: (randn(*shape, dtype=torch.float32),
                randn(*shape, dtype=torch.float32), None, None),
        True: (torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8),
               torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8),
               torch.rand((syn_p, syn_hkv), generator=gen,
                          device=dev) * 0.02 + 1e-3,
               torch.rand((syn_p, syn_hkv), generator=gen,
                          device=dev) * 0.02 + 1e-3),
    }
    sq = 101
    q_pos = torch.stack([torch.sort(torch.randperm(
        max(n, sq), generator=gen, device=dev)[:sq])[0]
        for n in syn_lens]).to(torch.int32)
    for q8 in (False, True):
        k, v, ks, vs = pools[q8]
        qd = randn(3, syn_hq, dh, dtype=torch.float32)
        check_d, out_d = decode_case(qd, k, v, ks, vs, syn_pt, lens, syn_win)
        if out_d.is_cuda and not torch.all(out_d[0] == 0):
            raise RuntimeError("decode kernel: idle row is not zero")
        qp = randn(3, sq, syn_hq, dh, dtype=torch.float32)
        check_p, _ = prefill_case(qp, k, v, ks, vs, syn_pt, q_pos, lens,
                                  syn_win)
        for name, check in (
                (("paged_attn_q8" if q8 else "paged_attn"), check_d),
                (("sel_attn_paged_q8" if q8 else "sel_attn_paged"), check_p)):
            if not check["worst"] <= 1.0:
                raise RuntimeError(f"{name}: synthetic GQA error {check}")
            results[name]["synthetic_err"] = check["max_abs_err"]
    torch.cuda.synchronize()
    phase("kernels", t0)

    # -- 6. small reference: the engine on the card against the CPU ---------
    t0 = time.perf_counter()
    small = dataclasses.replace(get_smoke_config("llava-1.6-7b"),
                                param_dtype="float32", compute_dtype="float32")
    smodel = build_model(small)
    p_cpu = smodel.init(seed=1, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    for pool_dtype, logit_tol in (("", 1e-3), ("int8", 5e-2)):
        outs = {}
        for where, p in (("cpu", p_cpu), (None, p_gpu)):
            eng = MPICEngine(smodel, p, EngineConfig(
                max_seq_len=320, decode_slots=2, pool_dtype=pool_dtype),
                device=where)
            firsts = {}
            finalize = eng._finalize_prefill

            def record(req, result, firsts=firsts, finalize=finalize):
                firsts[req.req_id] = result.first_logits
                return finalize(req, result)

            eng._finalize_prefill = record
            samples = make_dialogues(n=3, n_images=2, d_model=small.d_model,
                                     media_len=small.media_token_len, seed=3)
            for s in samples:
                for _, seg in s.prompt.media_segments():
                    eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            rs = [eng.submit(Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                                     policy_kwargs={"k": 8}))
                  for s in samples]
            eng.run()
            outs[where] = ([r.output_tokens for r in rs],
                           np.stack([firsts[r.req_id] for r in rs]))
        diff = float(np.abs(outs["cpu"][1] - outs[None][1]).max())
        same = outs["cpu"][0] == outs[None][0]
        print(f"small fp32 model, pool {pool_dtype or 'fp32'}: card vs CPU "
              f"first-logit max diff {diff:.2e}, tokens identical {same}")
        if not diff <= logit_tol or (pool_dtype == "" and not same):
            raise RuntimeError("the card's engine disagrees with the CPU's")
    phase("small_reference", t0)

    # -- report ------------------------------------------------------------
    launches = {**{k: launches16[k] for k in ("sel_attn_paged", "paged_attn")},
                **{k: launches8[k] for k in ("sel_attn_paged_q8",
                                             "paged_attn_q8")}}
    rows = []
    for name in ("sel_attn_paged", "sel_attn_paged_q8", "paged_attn",
                 "paged_attn_q8"):
        r = results[name]
        source, replaces = KERNEL_FILES[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_abs_ref": r["max_abs_ref"],
            "err_over_limit": r["worst"], "tolerance": TOLERANCE,
            "synthetic_err": r["synthetic_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library": LIBRARY_CALL,
            "shape": r["shape"], "card": card})
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
