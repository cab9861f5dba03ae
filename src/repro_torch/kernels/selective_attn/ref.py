"""Plain PyTorch version of paged selective-prefill attention (mirror of
``selective_attention_paged_ref`` in the JAX package's
``kernels/selective_attn/ref.py``).

q          (B, Hq, Sq, Dh)         selected (recomputed) tokens
k/v pool   (P, page_size, Hkv, Dh) one layer's page pool
page_table (B, max_pages) int32    pages owned per sequence
q_pos      (B, Sq) int32           original positions of the queries
lengths    (B,) int32              valid token slots per sequence
k_scale/v_scale (P, Hkv) fp32      int8-pool page scales (optional)

Slot ``i`` of a sequence holds the token at original position ``i``, so a
key is kept iff ``i < length``, ``i <= q_pos`` and, with a window,
``i > q_pos - window``.  A query row with no valid key gives zeros.
Returns (B, Hq, Sq, Dh) in q's dtype.
"""
from __future__ import annotations

import math

import torch


def selective_attention_paged_ref(q, k_pool, v_pool, page_table, q_pos,
                                  lengths, k_scale=None, v_scale=None, *,
                                  window: int = 0):
    b, hq, sq, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    rep = hq // hkv
    pt = page_table.long()

    k = k_pool[pt].reshape(b, max_pages * ps, hkv, dh).float()
    v = v_pool[pt].reshape(b, max_pages * ps, hkv, dh).float()
    if k_scale is not None:
        k = k * torch.repeat_interleave(k_scale[pt], ps, dim=1)[..., None]
        v = v * torch.repeat_interleave(v_scale[pt], ps, dim=1)[..., None]
    k = torch.repeat_interleave(k, rep, dim=2).transpose(1, 2)  # (B,Hq,S,Dh)
    v = torch.repeat_interleave(v, rep, dim=2).transpose(1, 2)

    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    idx = torch.arange(max_pages * ps, device=q.device)[None, None, None, :]
    qp = q_pos.long()[:, None, :, None]
    mask = (idx < lengths.long()[:, None, None, None]) & (idx <= qp)
    if window > 0:
        mask = mask & (idx > qp - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)
