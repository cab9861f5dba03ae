"""Context-caching policies: the paper's algorithm and its baselines (port of
the JAX package's ``core/policies.py``), all on the same model:

  * ``full_recompute`` - no context caching; the quality oracle.
  * ``prefix_caching`` - reuse the longest exactly matching stored token
    prefix (in practice the system prompt), recompute everything else.
  * ``full_reuse``     - Prompt-Cache style: recompute the text KV on its
    own (step 1), link it with the stored media KV, then compute the first
    output token (step 2).  Two engine invocations.
  * ``cacheblend``     - position-independent, recomputes the top r of the
    media tokens by measured KV deviation; the probe that measures it makes
    it two-step too.
  * ``mpic``           - the paper: selective attention, single step.

``mpic`` and ``cacheblend`` run against the engine's page pool when given
``paged`` (a :class:`~repro_torch.core.paged_prefill.BoundPagedPrefill`);
otherwise, like the other three, against a dense per-request cache, which
the engine splices into its pool or its dense batch cache.  The dense
passes write their caches in place (``Model.prefill`` and
``selective_prefill``); every policy here hands a cache to exactly one pass
and keeps only what that pass returns, as the JAX versions do with their
functional updates.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import select as sel_mod
from repro_torch.core.linker import LinkResult, link_prompt
from repro_torch.core.segments import Prompt
from repro_torch.models.layers import attention_qkv, rmsnorm


@dataclasses.dataclass
class PolicyResult:
    first_logits: np.ndarray      # (V,) logits for the first output token
    cache: Optional[dict]         # None: the KV already sits in the pool
    stats: dict                   # n_recomputed, n_reused, engine_steps, wall_s


# ---------------------------------------------------------------------------
# prefix store (what prefix-based context caching keeps)
# ---------------------------------------------------------------------------

class PrefixStore:
    """Token prefix -> KV store, keyed by a sha1 chained over the prefix's
    int64 token bytes: the digest of a prefix of n tokens is the running
    sha1 after n one-token updates, so :meth:`longest_match` walks a prompt
    with one hash update per token."""

    def __init__(self):
        self._entries = {}  # chained hash -> (n_tokens, k, v)

    @staticmethod
    def _chain(tokens: np.ndarray):
        """Yield (n, digest of the first n tokens) for n = 1..len(tokens)."""
        h = hashlib.sha1()
        toks = np.ascontiguousarray(tokens, np.int64)
        for n in range(len(toks)):
            h.update(toks[n:n + 1])
            yield n + 1, h.hexdigest()

    def put(self, tokens: np.ndarray, k, v) -> None:
        """Store the KV (L, n, Hkv, Dh) of a token prefix.  A streaming
        hash of the whole buffer equals the per-token chain."""
        digest = hashlib.sha1(
            np.ascontiguousarray(tokens, np.int64)).hexdigest()
        self._entries[digest] = (len(tokens), k, v)

    def longest_match(self, tokens: np.ndarray):
        """Longest stored prefix of ``tokens``: (n, k, v), or (0, None,
        None)."""
        best = (0, None, None)
        for n, digest in self._chain(tokens):
            e = self._entries.get(digest)
            if e is not None and e[0] == n:
                best = e
        return best


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _device(params) -> torch.device:
    return params.embed.device


def _full_prompt_arrays(model, prompt: Prompt, device):
    """Token ids (1, S) int32, media mask (1, S) and media embeddings
    (1, S, D) fp32 of the whole prompt, on ``device``."""
    toks = torch.as_tensor(prompt.flat_tokens()[None], dtype=torch.int32,
                           device=device)
    mask = torch.as_tensor(prompt.media_mask()[None], device=device)
    emb = torch.as_tensor(prompt.flat_media_embeds(model.cfg.d_model)[None],
                          device=device)
    return toks, mask, emb


def _first_logits(logits) -> np.ndarray:
    return logits[0, -1].float().cpu().numpy()


def _selective_step(model, params, link: LinkResult, rows=slice(None)):
    """One selective-attention prefill of the selected tokens ``rows`` (all
    of them by default; a chunked prefill passes one chunk) over the
    linked dense cache, which it writes in place."""
    dev = _device(params)
    sel_pos = torch.as_tensor(link.sel_idx[rows][None], dtype=torch.int32,
                              device=dev)
    return model.selective_prefill(
        params,
        torch.as_tensor(link.sel_tokens[rows][None], dtype=torch.int32,
                        device=dev),
        sel_pos, link.cache,
        sel_pos,  # write into the slots of the original positions
        media_embeds=torch.as_tensor(link.sel_media_embeds[rows][None],
                                     device=dev),
        media_mask=torch.as_tensor(link.sel_media_mask[rows][None],
                                   device=dev))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def full_recompute(model, params, prompt: Prompt, library=None, *,
                   kv_len=None, **kw) -> PolicyResult:
    t0 = time.perf_counter()
    dev = _device(params)
    toks, mask, emb = _full_prompt_arrays(model, prompt, dev)
    cache = model.make_cache(1, kv_len or prompt.total_len + 1, device=dev)
    logits, cache = model.prefill(params, toks, cache, media_embeds=emb,
                                  media_mask=mask)
    return PolicyResult(
        _first_logits(logits), cache,
        {"policy": "full_recompute", "n_recomputed": prompt.total_len,
         "n_reused": 0, "engine_steps": 1,
         "wall_s": time.perf_counter() - t0})


def prefix_caching(model, params, prompt: Prompt, library=None, *,
                   prefix_store: Optional[PrefixStore] = None, kv_len=None,
                   **kw) -> PolicyResult:
    """Reuse the longest stored token prefix.  Media slots carry token id 0
    and match only if the whole flattened region does; the engine's store
    holds the system prompt only, the paper's "prefix caching reuses the
    system prompt".

    The store holds K/V, no SSM state, so a model with SSM heads (an SSM,
    a hybrid) takes every hit as a miss and recomputes the whole prompt:
    its SSD heads must run over the prefix too.  (The JAX package reuses a
    hybrid's prefix K/V and starts its SSD heads from a zero state at the
    suffix.)"""
    t0 = time.perf_counter()
    dev = _device(params)
    n_hit, k_hit, v_hit = (prefix_store.longest_match(prompt.flat_tokens())
                           if prefix_store else (0, None, None))
    if model.cfg.attn_free or model.cfg.hybrid:
        n_hit = 0
    if n_hit and params.sharding is not None:
        # the store holds whole K/V; a tensor-parallel rank takes its heads
        k_hit, v_hit = (params.sharding.local_heads(t)
                        for t in (k_hit, v_hit))
    total = prompt.total_len
    cache = model.make_cache(1, kv_len or total + 1, device=dev)
    if n_hit:
        cache["k"][:, 0, :n_hit] = k_hit
        cache["v"][:, 0, :n_hit] = v_hit
        cache["pos"][0, :n_hit] = torch.arange(n_hit, dtype=torch.int32,
                                               device=dev)
    toks, mask, emb = _full_prompt_arrays(model, prompt, dev)
    positions = torch.arange(n_hit, total, dtype=torch.int32,
                             device=dev)[None]
    logits, cache = model.prefill(
        params, toks[:, n_hit:], cache, media_embeds=emb[:, n_hit:],
        media_mask=mask[:, n_hit:], positions=positions, write_idx=positions)
    return PolicyResult(
        _first_logits(logits), cache,
        {"policy": "prefix_caching", "n_recomputed": total - n_hit,
         "n_reused": n_hit, "engine_steps": 1,
         "wall_s": time.perf_counter() - t0})


def full_reuse(model, params, prompt: Prompt, library, *, kv_len=None,
               entries=None, **kw) -> PolicyResult:
    """Two-step Prompt-Cache-style reuse (paper section 3.2)."""
    t0 = time.perf_counter()
    dev = _device(params)
    selection = sel_mod.full_reuse_selection(prompt)
    link = link_prompt(model, prompt, library, selection, kv_len=kv_len,
                       device=dev, entries=entries, sharding=params.sharding)

    # step 1: the text KV on its own (text attends only to text, at its
    # original positions), a separate engine invocation
    n_sel = len(link.sel_idx)
    sel_pos = torch.as_tensor(link.sel_idx[None], dtype=torch.int32,
                              device=dev)
    txt_cache = model.make_cache(1, max(n_sel, 1) + 1, device=dev)
    wr = torch.arange(n_sel, dtype=torch.int32, device=dev)[None]
    _, txt_cache = model.prefill(
        params,
        torch.as_tensor(link.sel_tokens[None], dtype=torch.int32, device=dev),
        txt_cache,
        media_embeds=torch.as_tensor(link.sel_media_embeds[None], device=dev),
        media_mask=torch.as_tensor(link.sel_media_mask[None], device=dev),
        positions=sel_pos, write_idx=wr)

    # link the text KV into the blended cache
    cache = link.cache
    idx = sel_pos[0].long()
    cache["k"][:, :, idx] = txt_cache["k"][:, :, :n_sel]
    cache["v"][:, :, idx] = txt_cache["v"][:, :, :n_sel]
    cache["pos"][:, idx] = sel_pos

    # step 2: the first output token from the last prompt token
    last = prompt.total_len - 1
    toks, mask, emb = _full_prompt_arrays(model, prompt, dev)
    lp = torch.full((1, 1), last, dtype=torch.int32, device=dev)
    logits, cache = model.prefill(
        params, toks[:, last:last + 1], cache,
        media_embeds=emb[:, last:last + 1], media_mask=mask[:, last:last + 1],
        positions=lp, write_idx=lp)
    return PolicyResult(
        _first_logits(logits), cache,
        {"policy": "full_reuse", "n_recomputed": link.n_recomputed,
         "n_reused": link.n_reused, "engine_steps": 2,
         "wall_s": time.perf_counter() - t0, "misses": link.misses})


def _probe_k_deviation(model, params, prompt: Prompt, k_cached0) -> np.ndarray:
    """Layer-0 K of every token, recomputed, against the linked cache's
    layer-0 K ``k_cached0`` (S, Hkv, Dh): the L1 deviation per token,
    cacheblend's ranking signal (one layer, no cache).  A
    tensor-parallel rank sums its kv heads' share over the ranks, so that
    every rank ranks the same scores."""
    cfg = model.cfg
    toks, mask, emb = _full_prompt_arrays(model, prompt, _device(params))
    x = model.embed(params, toks, emb, mask)
    lp0 = params.layers[0]
    positions = torch.arange(prompt.total_len, dtype=torch.int32,
                             device=x.device)[None]
    h = rmsnorm(lp0.attn_norm, x, cfg.rms_norm_eps)
    _, k_probe, _ = attention_qkv(lp0.attn, cfg, h, positions)
    dev = (k_probe[0].float() - k_cached0.float()).abs().sum(dim=(-1, -2))
    if params.sharding is not None and params.sharding.attn:
        dev = params.sharding.mesh.all_reduce(dev)
    return dev.cpu().numpy()


def cacheblend(model, params, prompt: Prompt, library, *, r: float = 0.15,
               kv_len=None, entries=None, paged=None, **kw) -> PolicyResult:
    """CacheBlend-r [Yao et al. 2024]: KV-deviation-driven selection.

    Step 1 (probe): recompute layer-0 K of every token and rank the media
    tokens by L1 deviation from the linked cache.  Step 2: selective
    prefill of the chosen tokens.

    With ``paged``, the link writes straight into the pool pages, the probe
    reads layer-0 K back from the pool, and the re-selection reuses the
    same placement (no second link) before one paged prefill.
    """
    if model.cfg.arch_type == "ssm":
        # the JAX package raises this from its probe; here the link, which
        # comes first, would fail on the SSM's cache without K/V
        raise ValueError("cacheblend needs attention KV")
    t0 = time.perf_counter()
    dev = _device(params)
    base_sel = sel_mod.full_reuse_selection(prompt)
    name = f"cacheblend-{int(r * 100)}"
    if paged is not None:
        link0 = paged.link(model, prompt, library, base_sel, entries=entries,
                           sharding=params.sharding)
        # the probe reads the pool before the prefill has written the
        # selected slots: blank them, as the dense dummy cache does, so a
        # previous tenant's K cannot steer the ranking
        k0 = paged.gather_k0(prompt.total_len)
        k0[torch.as_tensor(link0.sel_idx, dtype=torch.long,
                           device=k0.device)] = 0
        dev_scores = _probe_k_deviation(model, params, prompt, k0)
        selection = sel_mod.cacheblend_selection(prompt, dev_scores, r)
        link = paged.reselect(model, prompt, link0, selection)
        first = paged.prefill(params, link)
        return PolicyResult(
            first, None,
            {"policy": name, "n_recomputed": link.n_recomputed,
             "n_reused": link.n_reused, "engine_steps": 2,
             "paged_prefill": True, "wall_s": time.perf_counter() - t0,
             "misses": link.misses})
    link0 = link_prompt(model, prompt, library, base_sel, device=dev,
                        entries=entries, sharding=params.sharding)
    dev_scores = _probe_k_deviation(model, params, prompt,
                                    link0.cache["k"][0, 0, :prompt.total_len])
    del link0
    selection = sel_mod.cacheblend_selection(prompt, dev_scores, r)
    link = link_prompt(model, prompt, library, selection, kv_len=kv_len,
                       device=dev, entries=entries, sharding=params.sharding)
    logits, cache = _selective_step(model, params, link)
    return PolicyResult(
        _first_logits(logits), cache,
        {"policy": name, "n_recomputed": link.n_recomputed,
         "n_reused": link.n_reused, "engine_steps": 2,
         "wall_s": time.perf_counter() - t0, "misses": link.misses})


def mpic(model, params, prompt: Prompt, library, *, k: int = 32,
         kv_len=None, entries=None, paged=None, **kw) -> PolicyResult:
    """MPIC-k: single-step selective attention (the paper's algorithm).

    With ``paged``, link and selective prefill both write straight into the
    request's pages and the first token's logits come back: no dense
    blended cache exists.  Without it, the linked dense cache goes through
    one selective prefill and comes back for the engine to splice."""
    t0 = time.perf_counter()
    selection = sel_mod.mpic_selection(prompt, k)
    if paged is not None:
        link = paged.link(model, prompt, library, selection, entries=entries,
                          sharding=params.sharding)
        first = paged.prefill(params, link)
        return PolicyResult(
            first, None,
            {"policy": f"mpic-{k}", "n_recomputed": link.n_recomputed,
             "n_reused": link.n_reused, "engine_steps": 1,
             "paged_prefill": True, "wall_s": time.perf_counter() - t0,
             "misses": link.misses})
    link = link_prompt(model, prompt, library, selection, kv_len=kv_len,
                       device=_device(params), entries=entries,
                       sharding=params.sharding)
    logits, cache = _selective_step(model, params, link)
    return PolicyResult(
        _first_logits(logits), cache,
        {"policy": f"mpic-{k}", "n_recomputed": link.n_recomputed,
         "n_reused": link.n_reused, "engine_steps": 1,
         "wall_s": time.perf_counter() - t0, "misses": link.misses})


POLICIES = {
    "full_recompute": full_recompute,
    "prefix_caching": prefix_caching,
    "full_reuse": full_reuse,
    "cacheblend": cacheblend,
    "mpic": mpic,
}
