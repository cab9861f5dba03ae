"""Dispatch for paged selective-prefill attention: the CUDA kernel on the
card, the plain version on the CPU.

``selective_attention_paged`` takes the model's layout: q (B, Sq, Hq, Dh);
pools (P, page_size, Hkv, Dh) of one layer; page_table (B, mp) int32; q_pos
(B, Sq) int32; lengths (B,) int32; optional k_scale/v_scale (P, Hkv) fp32
for the int8 pool.  It returns (B, Sq, Hq, Dh) in q's dtype.

A CPU tensor goes to :func:`selective_attention_paged_ref` (whose layout is
(B, Hq, Sq, Dh), as in the JAX package).  A CUDA tensor launches
``csrc/selective_attn.cu`` (``sel_attn_paged`` for a 16-bit pool,
``sel_attn_paged_q8`` for an int8 pool), which reads q and writes the
output in the model's layout and masks the ragged Sq edge itself, or
raises: there is no fallback on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, ptr
from repro_torch.kernels.selective_attn.ref import (
    selective_attention_paged_ref,
)

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
SEL_ATTN_PAGED = Kernel("sel_attn_paged", "selective_attn", _ARGS)
SEL_ATTN_PAGED_Q8 = Kernel("sel_attn_paged_q8", "selective_attn", _ARGS)
KERNELS = (SEL_ATTN_PAGED, SEL_ATTN_PAGED_Q8)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"selective_attention_paged: {what}")


def selective_attention_paged(q, k_pool, v_pool, page_table, q_pos, lengths,
                              *, k_scale=None, v_scale=None, window: int = 0):
    if q.device.type == "cpu":
        out = selective_attention_paged_ref(
            q.transpose(1, 2), k_pool, v_pool, page_table, q_pos, lengths,
            k_scale, v_scale, window=window)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(
            f"selective_attention_paged: unsupported device {q.device}")
    quantized = k_scale is not None
    b, sq, hq, dh = q.shape
    p, ps, hkv, dh_k = k_pool.shape
    tensors = [q, k_pool, v_pool, page_table, q_pos, lengths]
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
    _check(q_pos.dtype == torch.int32 and q_pos.shape == (b, sq),
           "q_pos must be int32 (B, Sq)")
    _check(lengths.dtype == torch.int32 and lengths.shape == (b,),
           "lengths must be int32 (B,)")
    if quantized:
        _check(v_scale is not None, "k_scale and v_scale go together")
        _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
               "scaled pools must be int8")
        _check(k_scale.dtype == torch.float32 and k_scale.shape == (p, hkv)
               and v_scale.shape == (p, hkv) and v_scale.dtype == torch.float32,
               "scales must be float32 (P, Hkv)")
        kernel, scales = SEL_ATTN_PAGED_Q8, (ptr(k_scale), ptr(v_scale))
    else:
        _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
               "a 16-bit pool must have q's dtype")
        kernel, scales = SEL_ATTN_PAGED, (None, None)
    out = torch.empty_like(q)
    if sq == 0:
        return out
    kernel.launch(_SUFFIX[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), *scales,
                  ptr(page_table), ptr(q_pos), ptr(lengths), ptr(out), b, sq,
                  hq, hkv, dh, ps, page_table.shape[1], int(window))
    return out
