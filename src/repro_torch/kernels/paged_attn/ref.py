"""Plain PyTorch version of paged decode attention (mirror of the JAX
package's ``kernels/paged_attn/ref.py``).

q          (B, Hq, Dh)              one new token per sequence
k/v pool   (P, page_size, Hkv, Dh)  one layer's page pool
page_table (B, max_pages) int32     pages owned by each sequence
lengths    (B,) int32               tokens cached per sequence
k_scale/v_scale (P, Hkv) fp32       int8-pool page scales (optional)

Like the JAX oracle, a row with ``lengths == 0`` has no valid key and
returns the uniform mean of the gathered values; the CUDA kernel returns
zeros there (as the Pallas kernel does).  Callers discard such rows.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                        k_scale=None, v_scale=None, *, window: int = 0):
    b, hq, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    rep = hq // hkv
    pt = page_table.long()

    k = k_pool[pt].reshape(b, max_pages * ps, hkv, dh).float()
    v = v_pool[pt].reshape(b, max_pages * ps, hkv, dh).float()
    if k_scale is not None:
        # tokens of one page share its (page, kv-head) scale
        k = k * torch.repeat_interleave(k_scale[pt], ps, dim=1)[..., None]
        v = v * torch.repeat_interleave(v_scale[pt], ps, dim=1)[..., None]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)

    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    idx = torch.arange(max_pages * ps, device=q.device)[None, :]
    length = lengths.long()[:, None]
    mask = idx < length
    if window > 0:
        # decode: the query sits at position length-1
        mask = mask & (idx > length - 1 - window)
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", probs, v).to(q.dtype)
