"""Page-granular int8 quantization for the paged KV pool (port of the JAX
package's ``cache/pagequant.py``).

One running symmetric scale per ``(layer, page, kv_head)`` lives beside the
int8 pages.  :func:`quant_scatter` writes fp tokens: a scatter-max grows
each touched page's scale to ``max(s_old, amax/QMAX)``, the touched pages'
resident int8 rows are rescaled from the old scale to the grown one
(``q' = round(q * s_old/s_new)``, a ratio <= 1 that never clips), and the
new tokens quantize at the final scale.  A page whose scale is 0 (fresh or
reset on free) rescales to zero, which also wipes a previous tenant's bytes.

The JAX version returns new buffers from a donated jit; this one updates
the given tensors in place.

Shapes (the layer axis leads, matching the pool buffers):
  pools       (L, P, page_size, H, Dh) int8
  scales      (L, P, H) fp32
  pages/offs  (N,) pool coordinates per token (duplicates allowed)
  k_new/v_new (L, N, H, Dh) fp
Rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch

# symmetric int8 grid shared with the JAX package's cache/quant.py
QMAX = 127.0


def _quant(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Quantize fp ``x (L,N,H,Dh)`` at per-token scales ``s (L,N,H)``."""
    s = torch.where(s > 0, s, torch.ones_like(s))[..., None]
    return torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)


def _requant_pages(pool, s_old, s_new, pages) -> None:
    """Rescale the int8 rows of ``pages`` (distinct) from ``s_old`` to
    ``s_new`` (both gathered at ``pages``: (L, U, H)), in place."""
    safe = torch.where(s_new > 0, s_new, torch.ones_like(s_new))
    ratio = torch.where(s_new > 0, s_old / safe, torch.ones_like(s_new))
    rows = pool[:, pages].float() * ratio[:, :, None, :, None]
    pool[:, pages] = torch.clamp(torch.round(rows), -QMAX, QMAX).to(torch.int8)


def quant_scatter(pool_k, pool_v, k_scale, v_scale, pages, offs,
                  k_new, v_new) -> None:
    """Quantizing scatter of fp tokens into int8 pools with running
    per-(layer, page, kv-head) scales, in place.  Each touched page is
    requantized once (the JAX version requantizes it once per token that
    lands on it, with identical results)."""
    pages = pages.long()
    offs = offs.long()
    touched = torch.unique(pages)
    for pool, scale, new in ((pool_k, k_scale, k_new), (pool_v, v_scale, v_new)):
        new = new.float()
        amax = new.abs().amax(dim=-1) / QMAX        # (L, N, H)
        s_old = scale[:, touched]                   # gathered before the max
        scale.scatter_reduce_(1, pages[None, :, None].expand_as(amax), amax,
                              "amax", include_self=True)
        _requant_pages(pool, s_old, scale[:, touched], touched)
        pool[:, pages, offs] = _quant(new, scale[:, pages])
