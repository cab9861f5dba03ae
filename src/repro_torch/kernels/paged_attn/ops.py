"""Dispatch for paged decode attention: the CUDA kernels on the card, the
plain version on the CPU.

``paged_attention`` takes the JAX package's layouts: q (B, Hq, Dh); pools
(P, page_size, Hkv, Dh) of one layer; page_table (B, mp) int32; lengths
(B,) int32; optional k_scale/v_scale (P, Hkv) fp32 for the int8 pool.
It returns (B, Hq, Dh) in q's dtype.

A CPU tensor goes to :func:`paged_attention_ref`, as does a ``meta`` one
(the dry run's shapes; it launches nothing).  A CUDA tensor launches
``csrc/paged_attn.cu`` (``paged_attn`` for a 16-bit or fp32 pool,
``paged_attn_q8`` for an int8 pool) or raises: there is no fallback on the
card.  The C entry runs the split-key kernel, which writes one fp32 partial
per (sequence, query head, split of :data:`CHUNK` keys) into a workspace
allocated here, and then the kernel that merges the splits; the wrapper
counts the pair as one launch.  The card takes head dims 64 and 128, up to
8 query heads per kv head, and q and pools on 16-byte boundaries (it reads
them as 16-byte vectors).  A row with ``lengths == 0`` gives zeros from the
kernel and the uniform mean of the gathered values from the plain version;
callers discard such rows.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels._build import Kernel, library, ptr
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
PAGED_ATTN = Kernel("paged_attn", "paged_attn", _ARGS)
PAGED_ATTN_Q8 = Kernel("paged_attn_q8", "paged_attn", _ARGS)
KERNELS = (PAGED_ATTN, PAGED_ATTN_Q8)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
CHUNK = 256             # keys per split: csrc/paged_attn.cu's CHUNK
HEAD_DIMS = (64, 128)
MAX_GROUP = 8           # query heads per kv head


@dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts each row's keys: ``n_splits`` chunks of
    :data:`CHUNK` keys counted from the row's first valid key, and the fp32
    workspace of ``workspace_numel`` values that holds one partial
    ``(acc[Dh], m, l)`` per (sequence, query head, split)."""
    n_splits: int
    workspace_numel: int
    mp: int
    ps: int
    window: int

    def split_keys(self, length: int, split: int) -> range:
        """The keys split ``split`` of a row with ``length`` cached tokens
        attends to, as the kernel computes them: valid keys are
        ``[lo, hi)``, ``lo = max(0, length - window)`` (0 without a window)
        and ``hi = min(length, mp * ps)``."""
        lo = max(0, length - self.window) if self.window > 0 else 0
        hi = min(length, self.mp * self.ps)
        start = lo + split * CHUNK
        return range(start, min(start + CHUNK, hi))


def plan_splits(b: int, hq: int, dh: int, mp: int, ps: int,
                window: int = 0) -> SplitPlan:
    """The split plan of a call, from shapes the host knows (never from
    ``lengths``, which live on the card): a row's valid keys span at most
    ``mp * ps`` keys, and at most ``window`` with a window."""
    reach = mp * ps if window <= 0 else min(mp * ps, window)
    n_splits = max(1, -(-reach // CHUNK))
    return SplitPlan(n_splits, b * hq * n_splits * (dh + 2), mp, ps, window)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {what}")


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    k_scale=None, v_scale=None, window: int = 0):
    # meta runs no kernel: the plain version computes its shapes
    if q.device.type in ("cpu", "meta"):
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   k_scale, v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    quantized = k_scale is not None
    b, hq, dh = q.shape
    p, ps, hkv, dh_k = k_pool.shape
    tensors = [q, k_pool, v_pool, page_table, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    _check(q.dtype in _SUFFIX, f"q dtype {q.dtype} not float32/bfloat16")
    _check(dh_k == dh and v_pool.shape == k_pool.shape,
           "pool shapes must be (P, page_size, Hkv, Dh) matching q")
    _check(hq % hkv == 0, f"Hq {hq} not a multiple of Hkv {hkv}")
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == b, "page_table must be int32 (B, mp)")
    _check(lengths.dtype == torch.int32 and lengths.shape == (b,),
           "lengths must be int32 (B,)")
    if quantized:
        _check(v_scale is not None, "k_scale and v_scale go together")
        _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
               "scaled pools must be int8")
        _check(k_scale.dtype == torch.float32 and k_scale.shape == (p, hkv)
               and v_scale.shape == (p, hkv) and v_scale.dtype == torch.float32,
               "scales must be float32 (P, Hkv)")
        kernel, scales = PAGED_ATTN_Q8, (ptr(k_scale), ptr(v_scale))
    else:
        _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
               "a 16-bit pool must have q's dtype")
        kernel, scales = PAGED_ATTN, (None, None)
    _check(dh in HEAD_DIMS, f"head dim {dh} not 64 or 128 (the kernel's)")
    _check(hq // hkv <= MAX_GROUP,
           f"group {hq // hkv} query heads per kv head, more than "
           f"{MAX_GROUP}")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
           "q and the pools must be 16-byte aligned")
    mp = page_table.shape[1]
    plan = plan_splits(b, hq, dh, mp, ps, window)
    ws = torch.empty(plan.workspace_numel, dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    kernel.launch(_SUFFIX[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), *scales,
                  ptr(page_table), ptr(lengths), ptr(ws), ptr(out), b, hq,
                  hkv, dh, ps, mp, int(window), plan.n_splits)
    return out


def decode_resources(q_dtype, quantized: bool, dh: int, group: int) -> dict:
    """Registers, local memory per thread (bytes: spills and stack, 0 when
    nothing spills), static and dynamic shared memory (bytes), resident
    blocks per SM, threads per block and query heads per block of the
    split-key kernel that serves a ``q_dtype`` query on a 16-bit/fp32
    (``quantized`` False) or int8 pool at head dim ``dh`` and ``group``
    query heads per kv head, as the card reports them
    (``cudaFuncGetAttributes`` and the occupancy calculator)."""
    fn = library("paged_attn").paged_attn_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 7)()
    err = fn(int(quantized), int(q_dtype == torch.bfloat16), dh, group, info)
    if err != 0:
        raise RuntimeError(f"paged_attn_info failed (cudaError {err})")
    keys = ("registers", "local_bytes", "static_smem_bytes", "smem_bytes",
            "blocks_per_sm", "threads", "heads_per_block")
    return dict(zip(keys, info))
