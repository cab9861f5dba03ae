"""Decoder-only model for the attention architectures, the pure SSM and the
attention + SSM hybrid (port of the JAX package's ``models/transformer.py``,
the parts the serving paths and the inference forward run).

The weights are ``nn.Module``s: a :class:`Transformer` holds the embedding,
an ``nn.ModuleList`` of :class:`DecoderLayer` (or, for an SSM, of
:class:`SSMLayer`; run in a Python loop where the JAX package scans over a
stacked layer axis), the final norm and the LM head (none when the
embeddings are tied: the head is then ``embed.T``).  A hybrid's
:class:`DecoderLayer` also holds an :class:`~repro_torch.models.ssm.SSM`
and the two norms that mix its output with the attention's; a MoE's holds
a :class:`~repro_torch.models.moe.MoE` in place of the MLP.  Weights keep
the JAX layout ``(in, out)`` and apply as ``x @ W``.  The passes are plain
functions on tensors:

* :func:`forward_with_cache`: any tokens at any positions against a dense
  cache (:func:`make_cache`): the media upload, the baselines' prefills,
  the dense selective prefill and the dense decode step; for an SSM, a
  contiguous prefill (the SSD chunk kernel) or one recurrent decode step;
  a hybrid runs both in every layer;
* :func:`forward`: a contiguous sequence from position 0 with no cache
  (the inference half of the JAX package's ``forward_train``);
* :func:`decode_paged`: one decode step for every slot against the page
  pool;
* :func:`selective_prefill_paged`: the MPIC selective prefill against the
  page pool.

Every pass writes each layer's new K/V into its cache or pool tensors in
place (the JAX versions return new buffers from donated jits or functional
scatters; no caller reads the old buffer again) and runs attention through
the kernel dispatchers, which launch the CUDA kernels on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.cache.pagequant import quant_scatter
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.selective_attn.ops import (
    selective_attention,
    selective_attention_paged,
)
from repro_torch.models.layers import (
    INVALID_POS,
    attention_out,
    attention_qkv,
    banded_attend,
    rmsnorm,
    swiglu,
)
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.models.ssm import SSM, init_ssm_state, ssm_decode, ssm_forward


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _ones(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


def _zeros(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo``, and with ``cfg.qkv_bias`` the biases
    ``bq``/``bk``/``bv`` (zeros, as ``init_attention`` makes them)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = _weight((d, qd), dtype, device)
        self.wk = _weight((d, kvd), dtype, device)
        self.wv = _weight((d, kvd), dtype, device)
        self.wo = _weight((qd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _zeros(qd, dtype, device)
            self.bk = _zeros(kvd, dtype, device)
            self.bv = _zeros(kvd, dtype, device)


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
    """Attention and MLP (``moe`` in its place for ``arch_type="moe"``);
    with ``cfg.hybrid`` also the SSM heads, which run beside the attention
    on the same normed input, and the norms ``attn_mix_norm``/
    ``ssm_mix_norm`` of the two outputs they mix."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = _ones(cfg.d_model, dtype, device)
        if cfg.arch_type == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = SwiGLU(cfg, dtype, device)
        if cfg.hybrid:
            self.ssm = SSM(cfg, dtype, device)
            self.attn_mix_norm = _ones(cfg.d_model, dtype, device)
            self.ssm_mix_norm = _ones(cfg.d_model, dtype, device)


class SSMLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm = _ones(cfg.d_model, dtype, device)
        self.ssm = SSM(cfg, dtype, device)


class Transformer(nn.Module):
    """The parameters of one model (``params`` in the functions below)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        dt = torch_dtype(cfg.param_dtype)
        layer = SSMLayer if cfg.arch_type == "ssm" else DecoderLayer
        self.embed = _weight((cfg.vocab_size, cfg.d_model), dt, dev)
        self.layers = nn.ModuleList(
            layer(cfg, dt, dev) for _ in range(cfg.num_layers))
        self.final_norm = _ones(cfg.d_model, dt, dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        _weight((cfg.d_model, cfg.vocab_size), dt, dev))


def init_params(cfg, *, seed: int = 0, device=None) -> Transformer:
    """Seeded random weights on ``device``, drawn as the JAX package's
    ``dense_init`` draws them: N(0, 1) in fp32 scaled by 1/sqrt(fan_in)
    (0.02 for the embedding and the LM head, 0.5 for the SSM conv; a
    stacked ``(E, in, out)`` expert weight counts ``E`` as its fan-in, as
    ``dense_init`` does), then cast to the parameter dtype, the MoE router
    kept fp32; norm scales are ones and QKV biases zeros.  The SSM's other
    leaves are set as ``init_ssm`` sets them: ``dt_bias`` -4.6, ``A_log``
    log(linspace(1, 16)), ``D`` ones, ``conv_b`` zeros.  The numbers
    differ from the JAX ones (a ``torch.Generator`` is not ``jax.random``);
    the tests carry the JAX weights over with
    :func:`repro_torch.weights.params_from_numpy`."""
    params = Transformer(cfg, device=device)
    gen = torch.Generator(device=params.embed.device).manual_seed(seed)

    def fill(w: nn.Parameter, scale: Optional[float] = None) -> None:
        s = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device) * s)

    def fill_ssm(p: SSM) -> None:
        for w in (p.in_proj, p.bc_proj, p.dt_proj, p.out_proj):
            fill(w)
        fill(p.conv_w, 0.5)
        p.dt_bias.fill_(-4.6)
        p.A_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, p.A_log.shape[0], dtype=torch.float32)))
        p.D.fill_(1.0)

    with torch.no_grad():
        fill(params.embed, 0.02)
        for lp in params.layers:
            if isinstance(lp, SSMLayer):
                fill_ssm(lp.ssm)
                continue
            for w in (lp.attn.wq, lp.attn.wk, lp.attn.wv, lp.attn.wo):
                fill(w)
            ffn = lp.moe if cfg.arch_type == "moe" else lp.mlp
            for _, w in ffn.named_parameters():
                fill(w)
            if cfg.hybrid:
                fill_ssm(lp.ssm)
        if params.lm_head is not None:
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
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x.float() @ head.float()


def _mlp(lp: DecoderLayer, cfg, x) -> torch.Tensor:
    """The residual FFN block; a MoE's aux loss is dropped (serving)."""
    h = rmsnorm(lp.mlp_norm, x, cfg.rms_norm_eps)
    if cfg.arch_type == "moe":
        return x + moe_ffn(lp.moe, cfg, h)[0]
    return x + lp.mlp(h)


# ---------------------------------------------------------------------------
# dense cache passes
# ---------------------------------------------------------------------------

def make_cache(cfg, batch: int, kv_len: int, *, device=None) -> dict:
    """Empty dense cache, every slot invalid: ``k``/``v`` (L, B, kv_len,
    Hkv, Dh) zeros in the compute dtype, ``pos`` (B, kv_len) int32
    ``INVALID_POS``.  An SSM's cache is its recurrent state instead, zeros:
    ``ssm_h`` (L, B, H, ds, hd) fp32 and ``ssm_conv`` (L, B, W-1, di) in
    the compute dtype (``kv_len`` unused).  A hybrid's holds both."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    cache = {}
    if not cfg.attn_free:
        shape = (cfg.num_layers, batch, kv_len, cfg.num_kv_heads,
                 cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev),
                 "pos": torch.full((batch, kv_len), INVALID_POS,
                                   dtype=torch.int32, device=dev)}
    if cfg.attn_free or cfg.hybrid:
        st = init_ssm_state(cfg, cfg.num_layers * batch, dt, dev)
        cache["ssm_h"] = st["h"].unflatten(0, (cfg.num_layers, batch))
        cache["ssm_conv"] = st["conv"].unflatten(0, (cfg.num_layers, batch))
    return cache


def _scatter_rows(buf, vals, idx):
    """buf (B, S, ...) <- vals (B, Sq, ...) at idx (B, Sq), in place;
    returns ``buf``."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, idx.long()] = vals.to(buf.dtype)
    return buf


def _ssm_step(ssm: SSM, cfg, h, cache, l: int, ssm_mask, ssm_tail_start):
    """Layer ``l``'s SSM heads on ``h``: a prefill (``Sq > 1``, from an
    empty state, Sq a multiple of ``cfg.ssm_chunk``) or one decode step
    from the cached state; the new state is written into ``cache`` in
    place.  Returns the heads' output."""
    if h.shape[1] == 1:
        out, st = ssm_decode(ssm, cfg, h, {
            "h": cache["ssm_h"][l], "conv": cache["ssm_conv"][l]})
    else:
        out, st = ssm_forward(ssm, cfg, h, dt_mask=ssm_mask,
                              tail_start=ssm_tail_start)
    cache["ssm_h"][l] = st["h"]
    cache["ssm_conv"][l] = st["conv"]
    return out


def _mix(lp: DecoderLayer, cfg, attn_out, ssm_out):
    """A hybrid layer's two branches: the mean of their normed outputs."""
    eps = cfg.rms_norm_eps
    return 0.5 * (rmsnorm(lp.attn_mix_norm, attn_out, eps)
                  + rmsnorm(lp.ssm_mix_norm, ssm_out, eps))


def _forward_ssm(params: Transformer, cfg, embeds, cache, ssm_mask,
                 ssm_tail_start):
    """The SSM layers, each through :func:`_ssm_step`."""
    x = embeds
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.norm, x, cfg.rms_norm_eps)
        x = x + _ssm_step(lp.ssm, cfg, h, cache, l, ssm_mask, ssm_tail_start)
    return _logits(params, cfg, x), cache


def forward_with_cache(params: Transformer, cfg, embeds, positions, cache,
                       write_idx, *, window: Optional[int] = None,
                       contiguous: bool = False, ssm_mask=None,
                       ssm_tail_start=None):
    """Run tokens (any subset, any positions) against a dense cache.

    embeds (B, Sq, D) of the tokens to compute; positions (B, Sq) int32
    their positions in the full prompt; cache from :func:`make_cache`, which
    may already hold reused (linked) KV; write_idx (B, Sq) the slots their
    K/V go to.  Per layer the new K/V and positions are written into the
    cache in place, then selective attention runs over the whole cache, so
    the computed tokens see each other inside this one pass.  ``contiguous``
    marks a plain prefill from position 0 (``positions == write_idx ==
    arange``).  Returns (logits (B, Sq, V) fp32, cache).

    An SSM ignores positions and write_idx: a prefill of Sq > 1 tokens
    starts from an empty state (``ssm_mask`` (B, Sq) 0 on padding steps,
    ``ssm_tail_start`` (B,) the start of the conv state's tail; see
    :func:`repro_torch.models.ssm.ssm_forward`), Sq == 1 is a decode step.
    A hybrid runs its SSM heads so beside the attention in every layer.

    A contiguous prefill that fills the cache exactly (``Sq == kv_len``)
    with a window it spans at least twice, in whole windows, attends over
    the fresh K/V with :func:`~repro_torch.models.layers.banded_attend`,
    as the JAX package does.
    """
    if cfg.arch_type == "ssm":
        return _forward_ssm(params, cfg, embeds, cache, ssm_mask,
                            ssm_tail_start)
    w = cfg.sliding_window if window is None else window
    s_q = embeds.shape[1]
    kv_len = cache["k"].shape[2]
    banded = (contiguous and w and s_q == kv_len and s_q % w == 0
              and s_q >= 2 * w)
    kv_pos = _scatter_rows(cache["pos"], positions, write_idx)
    x = embeds
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k_new, v_new = attention_qkv(lp.attn, cfg, h, positions)
        k_full = _scatter_rows(cache["k"][l], k_new, write_idx)
        v_full = _scatter_rows(cache["v"][l], v_new, write_idx)
        if banded:
            o = banded_attend(q.contiguous(), k_new, v_new, positions, w)
        else:
            o = selective_attention(q.contiguous(), k_full, v_full,
                                    positions, kv_pos, window=w)
        a = attention_out(lp.attn.wo, o)
        if cfg.hybrid:
            a = _mix(lp, cfg, a, _ssm_step(lp.ssm, cfg, h, cache, l,
                                           ssm_mask, ssm_tail_start))
        x = _mlp(lp, cfg, x + a)
    return _logits(params, cfg, x), cache


def forward(params: Transformer, cfg, embeds) -> torch.Tensor:
    """Plain causal pass over a contiguous sequence from position 0, with
    no cache: the inference half of the JAX package's ``forward_train``.

    embeds (B, S, D); an SSM or a hybrid needs S to be a multiple of
    ``cfg.ssm_chunk`` (``Model.forward`` pads).  Attention runs through
    :func:`~repro_torch.models.layers.banded_attend` when the window fits
    the sequence at least twice, in whole windows, else the dense
    selective attention over the sequence itself.  Returns logits
    (B, S, V) fp32."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=embeds.device).repeat(b, 1)
    w = cfg.sliding_window
    x = embeds
    for lp in params.layers:
        if cfg.attn_free:
            h = rmsnorm(lp.norm, x, cfg.rms_norm_eps)
            x = x + ssm_forward(lp.ssm, cfg, h)[0]
            continue
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k, v = attention_qkv(lp.attn, cfg, h, positions)
        if w and s % w == 0 and s >= 2 * w:
            o = banded_attend(q.contiguous(), k, v, positions, w)
        else:
            o = selective_attention(q.contiguous(), k, v, positions,
                                    positions, window=w)
        a = attention_out(lp.attn.wo, o)
        if cfg.hybrid:
            a = _mix(lp, cfg, a, ssm_forward(lp.ssm, cfg, h)[0])
        x = _mlp(lp, cfg, x + a)
    return _logits(params, cfg, x)


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
