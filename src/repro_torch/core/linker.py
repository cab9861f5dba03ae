"""The MPIC **Linker**, paged target (port of the JAX package's
``core/linker.py``).

Stored segment caches are computed at canonical position 0; at link time
each is relocated to its offset in the prompt (an exact RoPE rotation by
the offset) and written straight into the request's reserved pool pages.
The selected (recomputed) tokens' K/V are written into their pages by the
selective prefill that follows, so no dense blended cache exists.

Not ported yet: the dense ``link_prompt`` target and the spool-to-pool
int8 direct link.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.segments import Prompt
from repro_torch.core.select import selection_indices


@dataclasses.dataclass
class PagedLinkResult:
    """Reused KV already sits in the request's pages; ``sel_*`` are the
    per-selected-token inputs of the prefill."""
    sel_idx: np.ndarray
    sel_tokens: np.ndarray
    sel_media_embeds: np.ndarray
    sel_media_mask: np.ndarray
    n_reused: int
    n_recomputed: int
    misses: list
    total: int


def selection_arrays(prompt: Prompt, d_model: int, sel_idx: np.ndarray):
    """Gather the per-selected-token inputs (ids, media embeds, media mask)."""
    flat_tokens = prompt.flat_tokens()
    media_mask = prompt.media_mask()
    media_embeds = prompt.flat_media_embeds(d_model)
    return (flat_tokens[sel_idx], media_embeds[sel_idx],
            media_mask[sel_idx])


def precompute_media_kv(model, params, embeds: torch.Tensor):
    """KV of a media segment on its own, at canonical position 0.

    embeds (length, D) on the model's device -> (k, v), each
    (L, length, Hkv, Dh) in the compute dtype.  This is what the library
    stores when a user uploads a file."""
    length = embeds.shape[0]
    tokens = torch.zeros((1, length), dtype=torch.int32, device=embeds.device)
    mask = torch.ones((1, length), dtype=torch.bool, device=embeds.device)
    _, cache = model.prefill(params, tokens, media_embeds=embeds[None],
                             media_mask=mask)
    return cache["k"][:, 0], cache["v"][:, 0]


def _gather_placements(prompt: Prompt, library, selection: np.ndarray):
    """Resolve each media segment to a library entry, or force its
    recompute.  Returns (selection grown by misses, [(offset, entry,
    length)], miss ids)."""
    sel = selection.copy()
    misses = []
    placed = []
    for off, seg in prompt.media_segments():
        entry = library.get(prompt.user_id, seg.media_id) if library else None
        if entry is None:
            # expired or missing: recompute the whole segment
            sel[off:off + seg.length] = True
            misses.append(seg.media_id)
        else:
            placed.append((off, entry, seg.length))
    return sel, placed, misses


def bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= max(n, lo): the shape buckets of the link
    write, the prefill step and the decode page table (the keys a later
    CUDA-graph cache will use)."""
    b = max(lo, 1)
    while b < n:
        b *= 2
    return b


def link_paged(model, prompt: Prompt, library, selection: np.ndarray, pool,
               page_row: np.ndarray, *, scratch_page: int) -> PagedLinkResult:
    """Link a prompt's reused segments directly into its reserved pages.

    All placed segments are relinked with one ``rope_relink`` and written
    with one :meth:`~repro_torch.cache.paged.PagedKVPool.link_write`.  The
    placed-token axis pads to a power-of-two bucket whose pad rows land on
    ``scratch_page``.  Selected slots are not zeroed: the prefill writes
    them before any layer's attention reads the pool.
    """
    cfg = model.cfg
    total = prompt.total_len
    ps = pool.cfg.page_size
    sel, placed, misses = _gather_placements(prompt, library, selection)
    sel_idx = selection_indices(sel)

    if placed:
        idx = np.concatenate([np.arange(off, off + n)
                              for off, _, n in placed])
        delta = np.concatenate([np.full(n, off, np.int32)
                                for off, _, n in placed])
        n_placed = len(idx)
        b = min(bucket(n_placed), max(ps, 8) * max(len(page_row), 1))
        pad = b - n_placed
        pages = np.full((b,), scratch_page, np.int32)
        offs = np.zeros((b,), np.int32)
        pages[:n_placed] = np.asarray(page_row)[idx // ps]
        offs[:n_placed] = idx % ps
        k_cat = torch.cat([e.k for _, e, _ in placed], dim=1)
        v_cat = torch.cat([e.v for _, e, _ in placed], dim=1)
        if pad > 0:
            delta = np.concatenate([delta, np.zeros(pad, np.int32)])
            zeros = k_cat.new_zeros(
                (k_cat.shape[0], pad) + tuple(k_cat.shape[2:]))
            k_cat = torch.cat([k_cat, zeros], dim=1)
            v_cat = torch.cat([v_cat, zeros], dim=1)
        dev = pool.device
        pool.link_write(torch.as_tensor(pages, device=dev),
                        torch.as_tensor(offs, device=dev), k_cat, v_cat,
                        torch.as_tensor(delta, device=dev),
                        theta=cfg.rope_theta, relink=bool(cfg.rope_theta))

    sel_tokens, sel_media_embeds, sel_media_mask = selection_arrays(
        prompt, cfg.d_model, sel_idx)
    return PagedLinkResult(
        sel_idx=sel_idx,
        sel_tokens=sel_tokens,
        sel_media_embeds=sel_media_embeds,
        sel_media_mask=sel_media_mask,
        n_reused=int(total - sel.sum()),
        n_recomputed=int(sel.sum()),
        misses=misses,
        total=total,
    )
