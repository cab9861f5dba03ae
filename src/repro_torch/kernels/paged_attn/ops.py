"""Dispatch for paged decode attention: the CUDA kernel on the card, the
plain version on the CPU.

``paged_attention`` takes the JAX package's layouts: q (B, Hq, Dh); pools
(P, page_size, Hkv, Dh) of one layer; page_table (B, mp) int32; lengths
(B,) int32; optional k_scale/v_scale (P, Hkv) fp32 for the int8 pool.
It returns (B, Hq, Dh) in q's dtype.

A CPU tensor goes to :func:`paged_attention_ref`.  A CUDA tensor launches
``csrc/paged_attn.cu`` (``paged_attn`` for a 16-bit pool, ``paged_attn_q8``
for an int8 pool) or raises: there is no fallback on the card.  A row with
``lengths == 0`` gives zeros from the kernel and the uniform mean of the
gathered values from the plain version; callers discard such rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, ptr
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
PAGED_ATTN = Kernel("paged_attn", "paged_attn", _ARGS)
PAGED_ATTN_Q8 = Kernel("paged_attn_q8", "paged_attn", _ARGS)
KERNELS = (PAGED_ATTN, PAGED_ATTN_Q8)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {what}")


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    k_scale=None, v_scale=None, window: int = 0):
    if q.device.type == "cpu":
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
    out = torch.empty_like(q)
    kernel.launch(_SUFFIX[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), *scales,
                  ptr(page_table), ptr(lengths), ptr(out), b, hq, hkv, dh, ps,
                  page_table.shape[1], int(window))
    return out
