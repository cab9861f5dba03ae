"""The MPIC **Linker** (port of the JAX package's ``core/linker.py``).

Stored segment caches are computed at canonical position 0; at link time
each is relocated to its offset in the prompt (an exact RoPE rotation by
the offset) and placed into the request's KV cache.  Two targets:

* :func:`link_prompt` builds a dense per-request blended cache (the
  baselines' path, and the engine without a page pool): placed segments at
  their offsets, and the **dummy cache** (zero K/V, ``INVALID_POS``) in the
  selected slots, which the single-step selective prefill fills;
* :func:`link_paged` writes the same segments straight into the request's
  reserved pool pages; the selected tokens' K/V are written into their
  pages by the paged selective prefill, so no dense blended cache exists.
  On an int8 pool, when every placed entry is stored int8 (a
  ``quantize=True`` library), the int8 bytes go straight onto the page grid
  (``PagedKVPool.link_write_q8``), with no fp copy of any block.

Both take ``entries=``, a per-media source of library entries (a
:class:`~repro_torch.cache.transfer.PrefetchHandle`): each entry is then
gathered at link time, blocking only on a fetch still running.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.segments import Prompt
from repro_torch.core.select import selection_indices
from repro_torch.models.layers import INVALID_POS, rope_relink


@dataclasses.dataclass
class LinkResult:
    cache: dict                   # dense blended cache (batch 1)
    sel_idx: np.ndarray           # (S_sel,) positions of recomputed tokens
    sel_tokens: np.ndarray        # (S_sel,) token ids (media slots: pad 0)
    sel_media_embeds: np.ndarray  # (S_sel, D)
    sel_media_mask: np.ndarray    # (S_sel,)
    n_reused: int
    n_recomputed: int
    misses: list                  # media ids absent from the library


@dataclasses.dataclass
class PagedLinkResult:
    """Reused KV already sits in the request's pages; ``sel_*`` are the
    per-selected-token inputs of the prefill.  ``forced`` marks tokens whose
    segment missed the library: a re-selection (cacheblend's deviation
    pass) must keep them selected."""
    sel_idx: np.ndarray
    sel_tokens: np.ndarray
    sel_media_embeds: np.ndarray
    sel_media_mask: np.ndarray
    n_reused: int
    n_recomputed: int
    misses: list
    total: int
    forced: np.ndarray            # (total,) bool


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
    stores when a user uploads a file; a tensor-parallel rank gathers
    every rank's kv heads into it, so the entry is the whole model's.

    A hybrid stores its K/V only (the SSM state depends on the whole
    prefix).  Its prefill pads the segment to ``ssm_chunk`` and parks the
    pads' K/V in the cache's last slot, so when it pads, the cache gets one
    slot past the segment for them.  (The JAX package's cache of exactly
    ``length`` slots parks them on the last token's K/V.)"""
    length = embeds.shape[0]
    scratch = 1 if model.chunk_pad(length) else 0
    cache = model.make_cache(1, length + scratch, device=embeds.device)
    tokens = torch.zeros((1, length), dtype=torch.int32, device=embeds.device)
    mask = torch.ones((1, length), dtype=torch.bool, device=embeds.device)
    _, cache = model.prefill(params, tokens, cache, media_embeds=embeds[None],
                             media_mask=mask, logits=False)
    k, v = cache["k"][:, 0], cache["v"][:, 0]
    if scratch:
        k, v = k[:, :length].contiguous(), v[:, :length].contiguous()
    if params.sharding is not None:
        # a tensor-parallel rank computed its kv heads: the entry is whole
        k, v = (params.sharding.gather_heads(t) for t in (k, v))
    return k, v


def scale_row_ids(n: int, qkv) -> np.ndarray:
    """Token -> scale-row map of one int8 segment: row 0 for whole-sequence
    scales, a step every ``block_tokens`` tokens for block scales."""
    if qkv.block_tokens is None:
        return np.zeros(n, np.int32)
    return (np.arange(n) // qkv.block_tokens).astype(np.int32)


def _gather_placements(prompt: Prompt, library, selection: np.ndarray,
                       entries=None, sharding=None):
    """Resolve each media segment to a library entry (from ``entries`` when
    given; with a tensor-parallel rank's ``sharding``, its view of the
    rank's kv heads), or force its recompute.  Returns (selection grown
    by misses, [(offset, entry, length)], miss ids).  Each placed entry is
    made ready for this thread's stream (``Entry.wait_loaded``); none is
    dequantized here."""
    sel = selection.copy()
    misses = []
    placed = []
    for off, seg in prompt.media_segments():
        if entries is not None:
            entry = entries.get(seg.media_id)
        else:
            entry = library.get(prompt.user_id, seg.media_id) if library \
                else None
        if entry is None:
            # expired or missing: recompute the whole segment
            sel[off:off + seg.length] = True
            misses.append(seg.media_id)
        else:
            entry.wait_loaded()
            if sharding is not None:
                entry = sharding.entry(entry)
            placed.append((off, entry, seg.length))
    return sel, placed, misses


def link_prompt(model, prompt: Prompt, library, selection: np.ndarray, *,
                kv_len: Optional[int] = None, device=None,
                entries=None, sharding=None) -> LinkResult:
    """Build the dense blended cache of one request on ``device`` (None
    means the card); a tensor-parallel rank passes its ``sharding``
    (``params.sharding``) and links its kv heads of each entry.

    Placed segments (already on the device, in the library) are relinked
    with one ``rope_relink`` over their concatenation and written at their
    offsets; the selected slots, which may overlap placed segments (MPIC
    recomputes each segment's first k tokens), are then zeroed and marked
    ``INVALID_POS`` until the selective prefill writes them.  ``kv_len``
    defaults to the prompt plus one scratch slot.
    """
    cfg = model.cfg
    total = prompt.total_len
    kv_len = kv_len or total + 1
    if kv_len < total + 1:
        raise ValueError(f"kv_len {kv_len} < prompt {total} + 1")
    sel, placed, misses = _gather_placements(prompt, library, selection,
                                             entries, sharding)
    sel_idx = selection_indices(sel)
    cache = model.make_cache(1, kv_len, device=device)
    k_buf, v_buf, pos = cache["k"][:, 0], cache["v"][:, 0], cache["pos"][0]
    if placed:
        dev = k_buf.device
        idx = torch.as_tensor(np.concatenate(
            [np.arange(off, off + n) for off, _, n in placed]), device=dev)
        k_cat = torch.cat([e.k for _, e, _ in placed], dim=1)
        v_cat = torch.cat([e.v for _, e, _ in placed], dim=1)
        if cfg.rope_theta:
            # exact position relocation: K(p + d) = R(d) K(p), per token
            delta = torch.as_tensor(np.concatenate(
                [np.full(n, off, np.int32) for off, _, n in placed]),
                device=dev)
            k_cat = rope_relink(k_cat, delta, cfg.rope_theta)
        k_buf[:, idx] = k_cat.to(k_buf.dtype)
        v_buf[:, idx] = v_cat.to(v_buf.dtype)
        pos[idx] = idx.to(torch.int32)
        if len(sel_idx):
            # dummy cache, written after the placement it may overlap
            sidx = torch.as_tensor(sel_idx, device=dev)
            k_buf[:, sidx] = 0
            v_buf[:, sidx] = 0
            pos[sidx] = INVALID_POS
    sel_tokens, sel_media_embeds, sel_media_mask = selection_arrays(
        prompt, cfg.d_model, sel_idx)
    return LinkResult(
        cache=cache,
        sel_idx=sel_idx,
        sel_tokens=sel_tokens,
        sel_media_embeds=sel_media_embeds,
        sel_media_mask=sel_media_mask,
        n_reused=int(total - sel.sum()),
        n_recomputed=int(sel.sum()),
        misses=misses,
    )


def bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= max(n, lo): the shape buckets of the link
    write, the prefill step and the decode page table (the keys a later
    CUDA-graph cache will use)."""
    b = max(lo, 1)
    while b < n:
        b *= 2
    return b


def link_paged(model, prompt: Prompt, library, selection: np.ndarray, pool,
               page_row: np.ndarray, *, scratch_page: int,
               entries=None, sharding=None) -> PagedLinkResult:
    """Link a prompt's reused segments directly into its reserved pages
    (``sharding`` as in :func:`link_prompt`).

    All placed segments are relinked with one ``rope_relink`` and written
    with one :meth:`~repro_torch.cache.paged.PagedKVPool.link_write`, or,
    on an int8 pool whose placed entries are all stored int8, with one
    :meth:`~repro_torch.cache.paged.PagedKVPool.link_write_q8` (counted in
    the library's ``direct_links``).  The placed-token axis pads to a
    power-of-two bucket whose pad rows land on ``scratch_page``.  Selected
    slots are not zeroed: the prefill writes them before any layer's
    attention reads the pool.
    """
    cfg = model.cfg
    total = prompt.total_len
    ps = pool.cfg.page_size
    sel, placed, misses = _gather_placements(prompt, library, selection,
                                             entries, sharding)
    forced = sel & ~selection                   # miss-driven recomputes
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
        delta = np.concatenate([delta, np.zeros(pad, np.int32)])
        dev = pool.device
        args = [torch.as_tensor(a, device=dev) for a in (pages, offs)]
        direct = pool.quantized and all(
            e.qk is not None and e.qk.block_tokens == e.qv.block_tokens
            for _, e, _ in placed)
        if direct:
            # every placed entry is int8-resident: its bytes rescale onto
            # the page grid.  The segments' scale rows stack into one
            # (L, rows, H, Dh) operand, seg_ids maps each token to its row
            qks, qvs, ksr, vsr, sids = [], [], [], [], []
            base = 0
            for _, e, n in placed:
                qks.append(e.qk.q[:, :n])
                qvs.append(e.qv.q[:, :n])
                ksr.append(e.qk.scale)
                vsr.append(e.qv.scale)
                sids.append(base + scale_row_ids(n, e.qk))
                base += e.qk.scale.shape[1]
            # pad rows (never referenced) bucket the scale-row axis too
            rpad = bucket(base, 1) - base
            ks_cat, vs_cat = (_pad_rows(torch.cat(r, dim=1), rpad, 1.0)
                              for r in (ksr, vsr))
            sid = np.concatenate(sids + [np.zeros(pad, np.int32)])
            pool.link_write_q8(
                *args, _pad_rows(torch.cat(qks, dim=1), pad, 0), ks_cat,
                _pad_rows(torch.cat(qvs, dim=1), pad, 0), vs_cat,
                torch.as_tensor(sid, device=dev),
                torch.as_tensor(delta, device=dev),
                theta=cfg.rope_theta, relink=bool(cfg.rope_theta))
            if library is not None:
                library.note_direct_link(len(placed))
        else:
            k_cat = torch.cat([e.k for _, e, _ in placed], dim=1)
            v_cat = torch.cat([e.v for _, e, _ in placed], dim=1)
            pool.link_write(*args, _pad_rows(k_cat, pad, 0),
                            _pad_rows(v_cat, pad, 0),
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
        forced=forced,
    )


def _pad_rows(x: torch.Tensor, n: int, value) -> torch.Tensor:
    """``x`` (L, S, ...) with ``n`` rows of ``value`` appended on axis 1."""
    if n <= 0:
        return x
    fill = x.new_full((x.shape[0], n) + tuple(x.shape[2:]), value)
    return torch.cat([x, fill], dim=1)


def reselect_paged(model, prompt: Prompt, link: PagedLinkResult,
                   selection: np.ndarray) -> PagedLinkResult:
    """A new selection over an already linked paged prompt, without writing
    anything again: placement does not depend on the selection in the
    paged path (selected slots are overwritten by the prefill, not zeroed
    at link time), so cacheblend's re-selection needs only fresh selection
    arrays.  Miss-forced tokens stay selected."""
    sel = selection | link.forced
    sel_idx = selection_indices(sel)
    sel_tokens, sel_media_embeds, sel_media_mask = selection_arrays(
        prompt, model.cfg.d_model, sel_idx)
    return dataclasses.replace(
        link, sel_idx=sel_idx, sel_tokens=sel_tokens,
        sel_media_embeds=sel_media_embeds, sel_media_mask=sel_media_mask,
        n_reused=int(link.total - sel.sum()),
        n_recomputed=int(sel.sum()))


def session_suffix_link(tokens, n_ctx: int, d_model: int) -> PagedLinkResult:
    """The link of a thawed session's new turn.  The snapshot's KV was
    written at its live positions, so thaw adopts its pages as they are:
    no relink, no scatter, the whole prefix reused.  What is left is the
    suffix: text tokens at positions ``n_ctx ..``, all selected and all
    forced (the library holds nothing to reuse for them), for the paged
    selective prefill."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    s = int(toks.shape[0])
    total = n_ctx + s
    forced = np.zeros(total, bool)
    forced[n_ctx:] = True
    return PagedLinkResult(
        sel_idx=np.arange(n_ctx, total, dtype=np.int64),
        sel_tokens=toks,
        sel_media_embeds=np.zeros((s, d_model), np.float32),
        sel_media_mask=np.zeros(s, bool),
        n_reused=n_ctx,
        n_recomputed=s,
        misses=[],
        total=total,
        forced=forced,
    )
