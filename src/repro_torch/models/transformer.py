"""Decoder-only transformer for the attention architectures (port of the
JAX package's ``models/transformer.py``, the parts the paged serving path
runs).

The weights are ``nn.Module``s: a :class:`Transformer` holds the embedding,
an ``nn.ModuleList`` of :class:`DecoderLayer` (run in a Python loop where
the JAX package scans over a stacked layer axis), the final norm and the LM
head.  Weights keep the JAX layout ``(in, out)`` and apply as ``x @ W``.
The serving passes are plain functions on tensors:

* :func:`prefill_kv` / :func:`forward_with_cache`: contiguous prefill from
  position 0 (what ``precompute_media_kv`` runs on an upload);
* :func:`decode_paged`: one decode step for every slot against the page
  pool;
* :func:`selective_prefill_paged`: the MPIC selective prefill against the
  page pool.

The paged passes write each layer's new K/V into the pool tensors in place
(the JAX versions return new buffers from donated jits) and run attention
through the kernel dispatchers, which launch the CUDA kernels on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.cache.pagequant import quant_scatter
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.selective_attn.ops import selective_attention_paged
from repro_torch.models.layers import (
    attend,
    attention_out,
    attention_qkv,
    banded_attend,
    rmsnorm,
    swiglu,
)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _ones(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = _weight((d, qd), dtype, device)
        self.wk = _weight((d, kvd), dtype, device)
        self.wv = _weight((d, kvd), dtype, device)
        self.wo = _weight((qd, d), dtype, device)


class SwiGLU(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _weight((d, f), dtype, device)
        self.w_up = _weight((d, f), dtype, device)
        self.w_down = _weight((f, d), dtype, device)

    def forward(self, x):
        return swiglu(self.w_gate, self.w_up, self.w_down, x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = _ones(cfg.d_model, dtype, device)
        self.mlp = SwiGLU(cfg, dtype, device)


class Transformer(nn.Module):
    """The parameters of one model (``params`` in the functions below)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        dt = torch_dtype(cfg.param_dtype)
        self.embed = _weight((cfg.vocab_size, cfg.d_model), dt, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dt, dev) for _ in range(cfg.num_layers))
        self.final_norm = _ones(cfg.d_model, dt, dev)
        self.lm_head = _weight((cfg.d_model, cfg.vocab_size), dt, dev)


def init_params(cfg, *, seed: int = 0, device=None) -> Transformer:
    """Seeded random weights on ``device``, drawn as the JAX package's
    ``dense_init`` draws them: N(0, 1) in fp32 scaled by 1/sqrt(fan_in)
    (0.02 for the embedding and the LM head), then cast to the parameter
    dtype; norm scales are ones.  The numbers differ from the JAX ones (a
    ``torch.Generator`` is not ``jax.random``); the tests carry the JAX
    weights over with :func:`repro_torch.weights.params_from_numpy`."""
    params = Transformer(cfg, device=device)
    gen = torch.Generator(device=params.embed.device).manual_seed(seed)

    def fill(w: nn.Parameter, scale: Optional[float] = None) -> None:
        s = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device) * s)

    with torch.no_grad():
        fill(params.embed, 0.02)
        for lp in params.layers:
            for w in (lp.attn.wq, lp.attn.wk, lp.attn.wv, lp.attn.wo,
                      lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down):
                fill(w)
        fill(params.lm_head, 0.02)
    return params


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(params: Transformer, cfg, tokens, media_embeds=None,
                 media_mask=None) -> torch.Tensor:
    x = params.embed[tokens.long()]
    if media_embeds is not None:
        # modality-frontend carve-out: precomputed patch embeddings
        x = torch.where(media_mask[..., None], media_embeds.to(x.dtype), x)
    return x


def _logits(params: Transformer, cfg, x) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x, cfg.rms_norm_eps)
    return x.float() @ params.lm_head.float()


def _mlp(lp: DecoderLayer, cfg, x) -> torch.Tensor:
    return x + lp.mlp(rmsnorm(lp.mlp_norm, x, cfg.rms_norm_eps))


# ---------------------------------------------------------------------------
# contiguous prefill (media upload)
# ---------------------------------------------------------------------------

def prefill_kv(params: Transformer, cfg, embeds, positions, *,
               window: Optional[int] = None):
    """Causal pass over contiguous tokens from position 0: embeds (B, S, D),
    positions (B, S) = arange.  Returns the last hidden states (B, S, D) and
    every layer's K/V, each (L, B, S, Hkv, Dh) in the compute dtype."""
    w = cfg.sliding_window if window is None else window
    s = embeds.shape[1]
    if w and s % w == 0 and s >= 2 * w:
        banded_attend()
    cdt = torch_dtype(cfg.compute_dtype)
    x = embeds
    ks, vs = [], []
    for lp in params.layers:
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k, v = attention_qkv(lp.attn, cfg, h, positions)
        k, v = k.to(cdt), v.to(cdt)
        o = attend(q, k, v, positions, positions, window=w)
        x = _mlp(lp, cfg, x + attention_out(lp.attn.wo, o))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def forward_with_cache(params: Transformer, cfg, embeds, positions, *,
                       window: Optional[int] = None):
    """Contiguous prefill form of the JAX ``forward_with_cache``: the cache
    holds exactly these tokens, so it is returned fresh.  Returns (logits
    (B, S, V) fp32, {"k", "v": (L, B, S, Hkv, Dh), "pos": positions})."""
    x, k, v = prefill_kv(params, cfg, embeds, positions, window=window)
    return _logits(params, cfg, x), {"k": k, "v": v, "pos": positions}


# ---------------------------------------------------------------------------
# paged serving passes
# ---------------------------------------------------------------------------

def _write_layer(l: int, pool_k, pool_v, k_scales, v_scales, pages, offs,
                 k_new, v_new) -> None:
    """Write N new tokens' K/V (N, Hkv, Dh) of layer ``l`` into the pool in
    place; on an int8 pool through the running-scale quantizing write."""
    if k_scales is not None:
        quant_scatter(pool_k[l:l + 1], pool_v[l:l + 1], k_scales[l:l + 1],
                      v_scales[l:l + 1], pages, offs, k_new[None], v_new[None])
    else:
        pool_k[l][pages, offs] = k_new.to(pool_k.dtype)
        pool_v[l][pages, offs] = v_new.to(pool_v.dtype)


def _scales(scales, l):
    return None if scales is None else scales[l]


def decode_paged(params: Transformer, cfg, embeds, positions, pool_k, pool_v,
                 page_table, lengths, write_pages, write_offs, k_scales=None,
                 v_scales=None) -> torch.Tensor:
    """One decode step for ALL slots against the shared page pool.

    embeds (B, 1, D); positions (B, 1) (= current cache length); pool_k/v
    (L, P, ps, Hkv, Dh), written in place; page_table (B, mp) int32, ``mp``
    covering max(lengths); lengths (B,) int32 valid tokens AFTER this
    step's write; write_pages/write_offs (B,) pool coordinates of the new
    token; k_scales/v_scales (L, P, Hkv) fp32 mark an int8 pool and are
    updated in place.  Idle slots point their write at a scratch page and
    carry ``lengths == 0``.  Returns logits (B, V) fp32.
    """
    pages, offs = write_pages.long(), write_offs.long()
    x = embeds
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k_new, v_new = attention_qkv(lp.attn, cfg, h, positions)
        _write_layer(l, pool_k, pool_v, k_scales, v_scales, pages, offs,
                     k_new[:, 0], v_new[:, 0])
        o = paged_attention(q[:, 0].contiguous(), pool_k[l], pool_v[l],
                            page_table, lengths,
                            k_scale=_scales(k_scales, l),
                            v_scale=_scales(v_scales, l),
                            window=cfg.sliding_window)
        x = _mlp(lp, cfg, x + attention_out(lp.attn.wo, o[:, None]))
    return _logits(params, cfg, x)[:, -1, :]


def selective_prefill_paged(params: Transformer, cfg, embeds, sel_positions,
                            pool_k, pool_v, page_table, lengths, write_pages,
                            write_offs, k_scales=None,
                            v_scales=None) -> torch.Tensor:
    """MPIC selective prefill straight against the page pool.

    embeds (B, Sq, D) of the selected tokens (padded to the caller's
    bucket); sel_positions (B, Sq) their prompt positions; page_table
    (B, mp) int32; lengths (B,) int32 valid slots (slot i holds position
    i); write_pages/write_offs (B, Sq), padding rows on the scratch page.
    Per layer: Q/K/V of the selected tokens, their K/V written into the
    pool in place, then selective attention over the whole paged region, so
    the recomputed tokens see each other inside this one pass.  Returns
    logits (B, Sq, V) fp32.
    """
    b, sq = sel_positions.shape
    pages = write_pages.reshape(-1).long()
    offs = write_offs.reshape(-1).long()
    x = embeds
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k_new, v_new = attention_qkv(lp.attn, cfg, h, sel_positions)
        _write_layer(l, pool_k, pool_v, k_scales, v_scales, pages, offs,
                     k_new.reshape(b * sq, *k_new.shape[2:]),
                     v_new.reshape(b * sq, *v_new.shape[2:]))
        o = selective_attention_paged(
            q.contiguous(), pool_k[l], pool_v[l], page_table, sel_positions,
            lengths, k_scale=_scales(k_scales, l),
            v_scale=_scales(v_scales, l), window=cfg.sliding_window)
        x = _mlp(lp, cfg, x + attention_out(lp.attn.wo, o))
    return _logits(params, cfg, x)
