"""The model for the attention architectures, the pure SSM, the attention +
SSM hybrid and the audio encoder-decoder (port of the JAX package's
``models/transformer.py``).

The weights are ``nn.Module``s: a :class:`Transformer` holds the embedding,
an ``nn.ModuleList`` of :class:`DecoderLayer` (or, for an SSM, of
:class:`SSMLayer`; run in a Python loop where the JAX package scans over a
stacked layer axis), the final norm and the LM head (none when the
embeddings are tied: the head is then ``embed.T``).  A hybrid's
:class:`DecoderLayer` also holds an :class:`~repro_torch.models.ssm.SSM`
and the two norms that mix its output with the attention's; a MoE's holds
a :class:`~repro_torch.models.moe.MoE` in place of the MLP.  whisper's
(``arch_type="audio"``) holds layer norms (:class:`LayerNorm`), a
:class:`GeluMLP` and the cross attention over the encoder's output
(``cross_norm``, ``cross_attn``); its :class:`Transformer` adds the
decoder's learned positions ``pos_embed``, the encoder's layers
(:class:`EncoderLayer`), its positions ``enc_pos_embed`` and its norm
``enc_norm``.  Weights keep the JAX layout ``(in, out)`` and apply as
``x @ W``.  The passes are plain functions on tensors:

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
  page pool;
* :func:`encode` and :func:`compute_cross_kv`: whisper's encoder over
  frame embeddings and the decoder layers' cross-attention K/V over its
  output, which the dense cache carries as ``cross_k``/``cross_v`` (a
  tensor-parallel rank's at its heads: the encoder runs on its heads and
  its slice of ``d_ff``, its output whole on every rank);
* :func:`forward_train`: the training forward (logits and the MoE aux
  loss), differentiable, the SSD heads included.

Every serving pass writes each layer's new K/V into its cache or pool
tensors in place (the JAX versions return new buffers from donated jits or
functional scatters; no caller reads the old buffer again) and runs
attention through the kernel dispatchers, which launch the CUDA kernels on
the card: the decoder's self and cross attention and the encoder's all go
through the dense selective attention (kernel 5).  :func:`forward_train`
alone attends with :func:`~repro_torch.models.layers.attend`, the
counterpart of the JAX package's jnp ``attend`` that its training forward
runs, and runs the SSD through ``ssd_chunked_train``: the kernels have no
backward, and no training pass calls them or their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
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
    attend,
    attention_out,
    attention_qkv,
    banded_attend,
    banded_attend_train,
    gelu_mlp,
    layernorm,
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


class GeluMLP(nn.Module):
    """whisper's MLP: ``w_up``/``w_down`` and the biases ``b_up``/
    ``b_down`` (zeros, as ``init_gelu_mlp`` makes them)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = _weight((d, f), dtype, device)
        self.w_down = _weight((f, d), dtype, device)
        self.b_up = _zeros(f, dtype, device)
        self.b_down = _zeros(d, dtype, device)

    def forward(self, x):
        return gelu_mlp(self.w_up, self.b_up, self.w_down, self.b_down, x)


class LayerNorm(nn.Module):
    """``scale`` (ones) and ``bias`` (zeros), as ``init_layernorm``."""

    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = _ones(d, dtype, device)
        self.bias = _zeros(d, dtype, device)


def _norm_param(cfg, dtype, device):
    """A norm's parameters: whisper's layer norm, else an RMS norm scale."""
    if cfg.arch_type == "audio":
        return LayerNorm(cfg.d_model, dtype, device)
    return _ones(cfg.d_model, dtype, device)


def _norm(p, x, eps: float):
    if isinstance(p, LayerNorm):
        return layernorm(p.scale, p.bias, x, eps)
    return rmsnorm(p, x, eps)


class DecoderLayer(nn.Module):
    """Attention and MLP (``moe`` in its place for ``arch_type="moe"``);
    with ``cfg.hybrid`` also the SSM heads, which run beside the attention
    on the same normed input, and the norms ``attn_mix_norm``/
    ``ssm_mix_norm`` of the two outputs they mix.  whisper's layer norms
    every branch, runs a :class:`GeluMLP` and attends to the encoder's
    output through ``cross_attn`` (normed by ``cross_norm``) between its
    self attention and its MLP."""

    def __init__(self, cfg, dtype, device, widths=None):
        super().__init__()
        self.attn_norm = _norm_param(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = _norm_param(cfg, dtype, device)
        if cfg.arch_type == "moe":
            self.moe = MoE(cfg, dtype, device,
                           *((widths.experts, widths.shared_ff)
                             if widths else ()))
        elif cfg.arch_type == "audio":
            self.mlp = GeluMLP(cfg, dtype, device)
            self.cross_norm = LayerNorm(cfg.d_model, dtype, device)
            self.cross_attn = Attention(cfg, dtype, device)
        else:
            self.mlp = SwiGLU(cfg, dtype, device)
        if cfg.hybrid:
            self.ssm = SSM(cfg, dtype, device,
                           widths.ssm_heads if widths else 0)
            self.attn_mix_norm = _ones(cfg.d_model, dtype, device)
            self.ssm_mix_norm = _ones(cfg.d_model, dtype, device)


class SSMLayer(nn.Module):
    def __init__(self, cfg, dtype, device, widths=None):
        super().__init__()
        self.norm = _ones(cfg.d_model, dtype, device)
        self.ssm = SSM(cfg, dtype, device, widths.ssm_heads if widths else 0)


class EncoderLayer(nn.Module):
    """One layer of whisper's encoder: layer-normed self attention and
    GELU MLP."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.attn_norm = LayerNorm(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = LayerNorm(cfg.d_model, dtype, device)
        self.mlp = GeluMLP(cfg, dtype, device)


class Transformer(nn.Module):
    """The parameters of one model (``params`` in the functions below),
    built to ``cfg``'s shapes.  A tensor-parallel rank's shard (built to
    ``launch.specs.local_config``'s shapes) carries its plan in
    ``sharding`` (a :class:`~repro_torch.serving.sharding.
    ServingSharding`; None for a whole model), which the passes read for
    their collectives.  ``widths`` (``launch.specs.Widths``) are such a
    shard's routed experts, shared experts' hidden units and SSD heads,
    which its config cannot carry (the model's by default)."""

    def __init__(self, cfg, *, device=None, widths=None):
        super().__init__()
        self.cfg = cfg
        self.sharding = None
        dev = resolve_device(device)
        dt = torch_dtype(cfg.param_dtype)
        layer = SSMLayer if cfg.arch_type == "ssm" else DecoderLayer
        self.embed = _weight((cfg.vocab_size, cfg.d_model), dt, dev)
        self.layers = nn.ModuleList(
            layer(cfg, dt, dev, widths) for _ in range(cfg.num_layers))
        self.final_norm = _norm_param(cfg, dt, dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        _weight((cfg.d_model, cfg.vocab_size), dt, dev))
        if cfg.learned_pos_emb:
            self.pos_embed = _weight(
                (cfg.max_position_embeddings, cfg.d_model), dt, dev)
        if cfg.is_encoder_decoder:
            self.enc_layers = nn.ModuleList(
                EncoderLayer(cfg, dt, dev)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = LayerNorm(cfg.d_model, dt, dev)
            self.enc_pos_embed = _weight(
                (cfg.encoder_seq, cfg.d_model), dt, dev)


def init_params(cfg, *, seed: int = 0, device=None,
                sharding=None) -> Transformer:
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
    :func:`repro_torch.weights.params_from_numpy`.  whisper's position
    tables draw at 0.02 as well; its layer-norm biases and MLP biases are
    zeros.

    With ``sharding`` (a :class:`~repro_torch.serving.sharding.
    ServingSharding` of ``cfg``) it builds only this rank's shard: every
    leaf is drawn whole, in the same order from the same generator, and
    the rank keeps its piece, so that the ranks' shards concatenate to
    the whole model's weights; no more than one whole leaf is held at a
    time."""
    if sharding is not None:
        params = Transformer(sharding.local_cfg, device=device,
                             widths=sharding.widths)
        params.sharding = sharding
    else:
        params = Transformer(cfg, device=device)
    gen = torch.Generator(device=params.embed.device).manual_seed(seed)
    names = {id(p): n for n, p in params.named_parameters()}

    def whole_shape(w: nn.Parameter):
        return (w.shape if sharding is None
                else sharding.whole_shapes[names[id(w)]])

    def keep(w: nn.Parameter, x: torch.Tensor) -> None:
        """``w`` <- the whole ``x``, or this rank's piece of it."""
        if sharding is not None:
            x = sharding.shard_leaf(names[id(w)], x)
        w.copy_(x)

    def fill(w: nn.Parameter, scale: Optional[float] = None) -> None:
        shape = whole_shape(w)
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        keep(w, torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=w.device) * s)

    def fill_ssm(p: SSM) -> None:
        for w in (p.in_proj, p.bc_proj, p.dt_proj, p.out_proj):
            fill(w)
        fill(p.conv_w, 0.5)
        p.dt_bias.fill_(-4.6)
        keep(p.A_log, torch.log(torch.linspace(
            1.0, 16.0, whole_shape(p.A_log)[0], dtype=torch.float32)))
        p.D.fill_(1.0)

    with torch.no_grad():
        fill(params.embed, 0.02)
        def fill_attn(attn: Attention) -> None:
            for w in (attn.wq, attn.wk, attn.wv, attn.wo):
                fill(w)

        for lp in params.layers:
            if isinstance(lp, SSMLayer):
                fill_ssm(lp.ssm)
                continue
            fill_attn(lp.attn)
            if cfg.arch_type == "moe":
                for _, w in lp.moe.named_parameters():
                    fill(w)
            elif cfg.arch_type == "audio":
                fill(lp.mlp.w_up)
                fill(lp.mlp.w_down)
                fill_attn(lp.cross_attn)
            else:
                for w in (lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down):
                    fill(w)
            if cfg.hybrid:
                fill_ssm(lp.ssm)
        if params.lm_head is not None:
            fill(params.lm_head, 0.02)
        if cfg.learned_pos_emb:
            fill(params.pos_embed, 0.02)
        if cfg.is_encoder_decoder:
            for lp in params.enc_layers:
                fill_attn(lp.attn)
                fill(lp.mlp.w_up)
                fill(lp.mlp.w_down)
            fill(params.enc_pos_embed, 0.02)
    return params


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(params: Transformer, cfg, tokens, media_embeds=None,
                 media_mask=None) -> torch.Tensor:
    sh = params.sharding
    x = (params.embed[tokens.long()] if sh is None
         else sh.embed(params.embed, tokens))
    if media_embeds is not None:
        # modality-frontend carve-out: precomputed patch embeddings
        x = torch.where(media_mask[..., None], media_embeds.to(x.dtype), x)
    return x


def _logits(params: Transformer, cfg, x) -> torch.Tensor:
    """fp32 logits of the normed ``x``; a rank's vocabulary slice of them
    gathered into the whole vocabulary on every rank."""
    x = _norm(params.final_norm, x, cfg.rms_norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x.float() @ head.float()
    sh = params.sharding
    return logits if sh is None else sh.gather_vocab(logits)


def _attn_out(params: Transformer, wo, o):
    """The attention's output projection; a rank's heads' partial product
    summed over the ranks."""
    sh = params.sharding
    if sh is None or not sh.attn:
        return attention_out(wo, o)
    return sh.row_parallel(o.flatten(2), wo)


def _mlp(params: Transformer, m, h):
    """A SwiGLU or whisper's GELU MLP on ``h``; a rank's slice of ``d_ff``
    ends in a partial ``w_down`` product summed over the ranks, whisper's
    ``b_down`` added once after the sum."""
    sh = params.sharding
    if sh is None or not sh.mlp:
        return m(h)
    if isinstance(m, GeluMLP):
        return sh.row_parallel(F.gelu(h @ m.w_up + m.b_up, approximate="tanh"),
                               m.w_down) + m.b_down
    return sh.row_parallel(F.silu(h @ m.w_gate) * (h @ m.w_up), m.w_down)


def _ffn(params: Transformer, lp: DecoderLayer, cfg, x):
    """The residual FFN block: (x + FFN(norm(x)), the MoE's aux loss, a
    zero without one).  A rank's slice of ``d_ff`` ends in a partial
    ``w_down`` product summed over the ranks; a rank's routed (and
    shared) experts meet the others' in the experts' combine."""
    h = _norm(lp.mlp_norm, x, cfg.rms_norm_eps)
    zero = x.new_zeros((), dtype=torch.float32)
    if cfg.arch_type == "moe":
        sh = params.sharding
        out, aux = moe_ffn(lp.moe, cfg, h, sharding=sh if sh is not None and (
            sh.experts or sh.mlp) else None)
        return x + out, aux
    return x + _mlp(params, lp.mlp, h), zero


def _ssm_sharding(params: Transformer):
    """The plan the SSM passes take: the rank's where its SSD heads are
    cut, else None (whole, or replicated on every rank)."""
    sh = params.sharding
    return sh if sh is not None and sh.ssm else None


def _cross_attention(params: Transformer, lp: DecoderLayer, cfg, x, cross_k,
                     cross_v, *, train: bool = False):
    """whisper's cross attention of ``x`` (B, S, D) over one layer's
    encoder K/V (B, Senc, Hkv, Dh): every query sees every frame.  The
    reference masks it with zero positions on both sides, which pass the
    causal test, so the serving passes give those to kernel 5 unchanged;
    ``train`` attends with ``layers.attend``."""
    h = _norm(lp.cross_norm, x, cfg.rms_norm_eps)
    b, s, _ = h.shape
    q = (h @ lp.cross_attn.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, cross_k.shape[1]), dtype=torch.int32,
                         device=x.device)
    if train:
        o = attend(q, cross_k, cross_v, q_pos, kv_pos, bidirectional=True)
    else:
        o = selective_attention(q.contiguous(), cross_k, cross_v, q_pos,
                                kv_pos)
    return _attn_out(params, lp.cross_attn.wo, o)


# ---------------------------------------------------------------------------
# dense cache passes
# ---------------------------------------------------------------------------

def make_cache(cfg, batch: int, kv_len: int, *, device=None,
               ssm_heads: int = 0) -> dict:
    """Empty dense cache, every slot invalid: ``k``/``v`` (L, B, kv_len,
    Hkv, Dh) zeros in the compute dtype, ``pos`` (B, kv_len) int32
    ``INVALID_POS``.  An SSM's cache is its recurrent state instead, zeros:
    ``ssm_h`` (L, B, H, ds, hd) fp32 and ``ssm_conv`` (L, B, W-1, di) in
    the compute dtype (``kv_len`` unused), at ``ssm_heads`` heads (a
    tensor-parallel rank's; the model's by default).  A hybrid's holds
    both.  An encoder-decoder's adds ``cross_k``/``cross_v`` (L, B,
    encoder_seq, Hkv, Dh) zeros, which a prefill with audio replaces."""
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
        st = init_ssm_state(cfg, cfg.num_layers * batch, dt, dev, ssm_heads)
        cache["ssm_h"] = st["h"].unflatten(0, (cfg.num_layers, batch))
        cache["ssm_conv"] = st["conv"].unflatten(0, (cfg.num_layers, batch))
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _scatter_rows(buf, vals, idx, keep=None):
    """buf (B, S, ...) <- vals (B, Sq, ...) at idx (B, Sq), in place, only
    where ``keep`` (B, Sq) holds when it is given; returns ``buf``."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    idx = idx.long()
    vals = vals.to(buf.dtype)
    if keep is not None:
        keep = keep.reshape(*keep.shape, *(1,) * (vals.dim() - keep.dim()))
        vals = torch.where(keep, vals, buf[rows, idx])
    buf[rows, idx] = vals
    return buf


def _ssm_step(params: Transformer, ssm: SSM, cfg, h, cache, l: int,
              ssm_mask, ssm_tail_start):
    """Layer ``l``'s SSM heads on ``h``: a prefill (``Sq > 1``, from an
    empty state, Sq a multiple of ``cfg.ssm_chunk``) or one decode step
    from the cached state; the new state is written into ``cache`` in
    place.  Returns the heads' output."""
    sh = _ssm_sharding(params)
    if h.shape[1] == 1:
        out, st = ssm_decode(ssm, cfg, h, {
            "h": cache["ssm_h"][l], "conv": cache["ssm_conv"][l]},
            sharding=sh)
    else:
        out, st = ssm_forward(ssm, cfg, h, dt_mask=ssm_mask,
                              tail_start=ssm_tail_start, sharding=sh)
    cache["ssm_h"][l] = st["h"]
    cache["ssm_conv"][l] = st["conv"]
    return out


def _mix(lp: DecoderLayer, cfg, attn_out, ssm_out):
    """A hybrid layer's two branches: the mean of their normed outputs."""
    eps = cfg.rms_norm_eps
    return 0.5 * (rmsnorm(lp.attn_mix_norm, attn_out, eps)
                  + rmsnorm(lp.ssm_mix_norm, ssm_out, eps))


def _forward_ssm(params: Transformer, cfg, embeds, cache, ssm_mask,
                 ssm_tail_start, logits: bool):
    """The SSM layers, each through :func:`_ssm_step`."""
    x = embeds
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.norm, x, cfg.rms_norm_eps)
        x = x + _ssm_step(params, lp.ssm, cfg, h, cache, l, ssm_mask,
                          ssm_tail_start)
    return (_logits(params, cfg, x) if logits else None), cache


def forward_with_cache(params: Transformer, cfg, embeds, positions, cache,
                       write_idx, *, window: Optional[int] = None,
                       contiguous: bool = False, ssm_mask=None,
                       ssm_tail_start=None, logits: bool = True,
                       kv_slice: Optional[int] = None):
    """Run tokens (any subset, any positions) against a dense cache.

    embeds (B, Sq, D) of the tokens to compute; positions (B, Sq) int32
    their positions in the full prompt; cache from :func:`make_cache`, which
    may already hold reused (linked) KV; write_idx (B, Sq) the slots their
    K/V go to.  Per layer the new K/V and positions are written into the
    cache in place, then selective attention runs over the whole cache, so
    the computed tokens see each other inside this one pass.  ``contiguous``
    marks a plain prefill from position 0 (``positions == write_idx ==
    arange``).  Returns (logits (B, Sq, V) fp32, cache); with
    ``logits=False`` the head is skipped and the logits are None.

    An SSM ignores positions and write_idx: a prefill of Sq > 1 tokens
    starts from an empty state (``ssm_mask`` (B, Sq) 0 on padding steps,
    ``ssm_tail_start`` (B,) the start of the conv state's tail; see
    :func:`repro_torch.models.ssm.ssm_forward`), Sq == 1 is a decode step.
    A hybrid runs its SSM heads so beside the attention in every layer.

    A contiguous prefill that fills the cache exactly (``Sq == kv_len``)
    with a window it spans at least twice, in whole windows, attends over
    the fresh K/V with :func:`~repro_torch.models.layers.banded_attend`,
    as the JAX package does.  An encoder-decoder's layers also attend to
    the cache's ``cross_k``/``cross_v`` (:func:`_cross_attention`).

    ``kv_slice`` marks a data rank of a long decode whose KV sequence is
    on ``data`` (the reference's ``shard_kv_seq``): the cache holds the
    slots ``[kv_slice, kv_slice + kv_len)`` of the whole ring, a new
    token's K/V and position land only on the rank that holds its slot
    (``write_idx`` stays the whole ring's), and each layer attends over
    the rank's slice with kernel 5's log-sum-exp and merges with the other
    ranks' (``ServingSharding.merge_kv_slices``).
    """
    if cfg.arch_type == "ssm":
        return _forward_ssm(params, cfg, embeds, cache, ssm_mask,
                            ssm_tail_start, logits)
    w = cfg.sliding_window if window is None else window
    s_q = embeds.shape[1]
    kv_len = cache["k"].shape[2]
    banded = (contiguous and w and s_q == kv_len and s_q % w == 0
              and s_q >= 2 * w)
    own = None
    if kv_slice is not None:
        local = write_idx.long() - kv_slice
        own = (local >= 0) & (local < kv_len)
        write_idx = local.clamp(0, kv_len - 1)
    kv_pos = _scatter_rows(cache["pos"], positions, write_idx, own)
    x = embeds
    for l, lp in enumerate(params.layers):
        h = _norm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k_new, v_new = attention_qkv(lp.attn, cfg, h, positions)
        k_full = _scatter_rows(cache["k"][l], k_new, write_idx, own)
        v_full = _scatter_rows(cache["v"][l], v_new, write_idx, own)
        if banded:
            o = banded_attend(q.contiguous(), k_new, v_new, positions, w)
        elif kv_slice is not None:
            o = params.sharding.merge_kv_slices(*selective_attention(
                q.contiguous(), k_full, v_full, positions, kv_pos, window=w,
                return_lse=True))
        else:
            o = selective_attention(q.contiguous(), k_full, v_full,
                                    positions, kv_pos, window=w)
        a = _attn_out(params, lp.attn.wo, o)
        if cfg.hybrid:
            a = _mix(lp, cfg, a, _ssm_step(params, lp.ssm, cfg, h, cache, l,
                                           ssm_mask, ssm_tail_start))
        x = x + a
        if cfg.is_encoder_decoder:
            x = x + _cross_attention(params, lp, cfg, x, cache["cross_k"][l],
                                     cache["cross_v"][l])
        x = _ffn(params, lp, cfg, x)[0]
    return (_logits(params, cfg, x) if logits else None), cache


def _contiguous(params: Transformer, cfg, x, cross_kv, *, train: bool):
    """The layers over a contiguous sequence from position 0, with no
    cache: (logits (B, S, V) fp32, the summed MoE aux loss).  When the
    window fits the sequence at least twice, in whole windows, attention
    takes the S x 2w band, as the JAX package's passes do: serving through
    ``banded_attend`` (kernel 5), ``train`` through
    ``banded_attend_train``; otherwise serving runs the dense selective
    attention and ``train`` ``layers.attend`` with the window.  ``train``
    runs the SSD heads through ``ssd_chunked_train``.  An SSM or a hybrid
    needs S to be a multiple of ``cfg.ssm_chunk``."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).repeat(b, 1)
    w = cfg.sliding_window
    banded = w and s % w == 0 and s >= 2 * w
    aux = x.new_zeros((), dtype=torch.float32)
    ssm_sh = _ssm_sharding(params)
    for l, lp in enumerate(params.layers):
        if cfg.attn_free:
            h = rmsnorm(lp.norm, x, cfg.rms_norm_eps)
            x = x + ssm_forward(lp.ssm, cfg, h, train=train,
                                sharding=ssm_sh)[0]
            continue
        h = _norm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k, v = attention_qkv(lp.attn, cfg, h, positions)
        if train and banded:
            o = banded_attend_train(q, k, v, positions, w)
        elif train:
            o = attend(q, k, v, positions, positions, window=w)
        elif banded:
            o = banded_attend(q.contiguous(), k, v, positions, w)
        else:
            o = selective_attention(q.contiguous(), k, v, positions,
                                    positions, window=w)
        a = _attn_out(params, lp.attn.wo, o)
        if cfg.hybrid:
            a = _mix(lp, cfg, a, ssm_forward(lp.ssm, cfg, h, train=train,
                                             sharding=ssm_sh)[0])
        x = x + a
        if cross_kv is not None:
            x = x + _cross_attention(params, lp, cfg, x, cross_kv[0][l],
                                     cross_kv[1][l], train=train)
        x, a_l = _ffn(params, lp, cfg, x)
        aux = aux + a_l
    return _logits(params, cfg, x), aux


def forward(params: Transformer, cfg, embeds, cross_kv=None) -> torch.Tensor:
    """Plain causal pass over a contiguous sequence from position 0, with
    no cache: the inference half of the JAX package's ``forward_train``.

    embeds (B, S, D) (with the learned positions added, for whisper);
    ``cross_kv`` an encoder-decoder's ``(cross_k, cross_v)`` from
    :func:`compute_cross_kv`.  An SSM or a hybrid needs S to be a multiple
    of ``cfg.ssm_chunk`` (``Model.forward`` pads).  Attention runs through
    :func:`~repro_torch.models.layers.banded_attend` when the window fits
    the sequence at least twice, in whole windows, else the dense
    selective attention over the sequence itself.  Returns logits
    (B, S, V) fp32."""
    return _contiguous(params, cfg, embeds, cross_kv, train=False)[0]


def forward_train(params: Transformer, cfg, tokens, media_embeds=None,
                  media_mask=None, *, audio_embeds=None):
    """The training forward of the JAX package's ``forward_train``: a
    causal pass over contiguous ``tokens`` (B, S) from position 0, media
    embeddings where ``media_mask`` is set, whisper's learned positions and
    its encoder over ``audio_embeds`` (B, Senc, D).  Returns (logits
    (B, S, V) fp32, the summed MoE aux loss).

    Every attention runs through ``layers.attend`` (the band through
    ``layers.banded_attend_train``), the counterpart of the jnp ``attend``
    that the JAX training forward runs, and every SSD through
    ``ssm.ssd_chunked_train``, the counterpart of its jnp ``ssd_chunked``
    (it reaches no Pallas kernel): the port's kernels have no backward, so
    this pass never calls them or their plain versions.  Differentiable
    end to end, the MoE's capacity dispatch included.  An SSM or a hybrid
    needs S to be a multiple of ``cfg.ssm_chunk`` and raises otherwise, as
    the JAX package asserts (``Model.loss`` does not pad)."""
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens, media_embeds, media_mask)
    if cfg.learned_pos_emb:
        x = x + params.pos_embed[:s][None]
    cross_kv = None
    if cfg.is_encoder_decoder:
        cross_kv = compute_cross_kv(
            params, cfg, _encode(params, cfg, audio_embeds, train=True))
    return _contiguous(params, cfg, x, cross_kv, train=True)


# ---------------------------------------------------------------------------
# whisper: the encoder and the cross-attention K/V
# ---------------------------------------------------------------------------

def _encode(params: Transformer, cfg, audio_embeds, *, train: bool):
    b, s, _ = audio_embeds.shape
    x = audio_embeds.to(torch_dtype(cfg.compute_dtype))
    x = x + params.enc_pos_embed[:s][None]
    pos = torch.arange(s, dtype=torch.int32,
                       device=x.device).repeat(b, 1)
    # bidirectional attention is causal attention with every query at the
    # last key's position: kernel 5 runs it unchanged
    last = torch.full((b, s), s - 1, dtype=torch.int32, device=x.device)
    eps = cfg.rms_norm_eps
    for lp in params.enc_layers:
        h = _norm(lp.attn_norm, x, eps)
        q, k, v = attention_qkv(lp.attn, cfg, h, pos, rope=False)
        if train:
            o = attend(q, k, v, pos, pos, bidirectional=True)
        else:
            o = selective_attention(q.contiguous(), k, v, last, pos)
        x = x + _attn_out(params, lp.attn.wo, o)
        x = x + _mlp(params, lp.mlp, _norm(lp.mlp_norm, x, eps))
    return _norm(params.enc_norm, x, eps)


def encode(params: Transformer, cfg, audio_embeds) -> torch.Tensor:
    """whisper's bidirectional encoder over precomputed frame embeddings
    ``audio_embeds`` (B, Senc, D) (the stub frontend): learned positions,
    no RoPE, every layer's attention through kernel 5 with each query at
    position ``Senc - 1`` and the keys at ``0 .. Senc - 1``, so that every
    query sees every frame.  Returns (B, Senc, D) in the compute dtype."""
    return _encode(params, cfg, audio_embeds, train=False)


def compute_cross_kv(params: Transformer, cfg, enc_out):
    """Each decoder layer's cross-attention K/V over the encoder's output
    ``enc_out`` (B, Senc, D): (cross_k, cross_v), each (L, B, Senc, Hkv,
    Dh).  They hold no decoder position, so they are what MPIC stores for
    an audio segment."""
    b, s, _ = enc_out.shape
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    ks = [(enc_out @ lp.cross_attn.wk).reshape(shape) for lp in params.layers]
    vs = [(enc_out @ lp.cross_attn.wv).reshape(shape) for lp in params.layers]
    return torch.stack(ks), torch.stack(vs)


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
                 v_scales=None, *, slot_writes=None) -> torch.Tensor:
    """One decode step for ALL slots against the shared page pool.

    embeds (B, 1, D); positions (B, 1) (= current cache length); pool_k/v
    (L, P, ps, Hkv, Dh), written in place; page_table (B, mp) int32, ``mp``
    covering max(lengths); lengths (B,) int32 valid tokens AFTER this
    step's write; write_pages/write_offs (B,) pool coordinates of the new
    token; k_scales/v_scales (L, P, Hkv) fp32 mark an int8 pool and are
    updated in place.  Idle slots point their write at a scratch page and
    carry ``lengths == 0``.  Returns logits (B, V) fp32.

    ``slot_writes`` (every slot's ``(write_pages, write_offs)``, (B,)
    each) marks a data rank's step: the other inputs are the rows of its
    slots; after the layers its new K/V rows are shared with the other
    data ranks and every slot's are written (``ServingSharding.
    share_rows``), and the whole batch's logits come back gathered.
    """
    pages, offs = write_pages.long(), write_offs.long()
    x = embeds
    rows = [] if slot_writes is not None else None
    for l, lp in enumerate(params.layers):
        h = rmsnorm(lp.attn_norm, x, cfg.rms_norm_eps)
        q, k_new, v_new = attention_qkv(lp.attn, cfg, h, positions)
        _write_layer(l, pool_k, pool_v, k_scales, v_scales, pages, offs,
                     k_new[:, 0], v_new[:, 0])
        if rows is not None:
            rows.append((k_new[:, 0], v_new[:, 0]))
        o = paged_attention(q[:, 0].contiguous(), pool_k[l], pool_v[l],
                            page_table, lengths,
                            k_scale=_scales(k_scales, l),
                            v_scale=_scales(v_scales, l),
                            window=cfg.sliding_window)
        x = _ffn(params, lp, cfg,
                 x + _attn_out(params, lp.attn.wo, o[:, None]))[0]
    logits = _logits(params, cfg, x)[:, -1, :]
    if rows is None:
        return logits
    sh = params.sharding
    sh.share_rows(pool_k, pool_v, k_scales, v_scales,
                  torch.stack([k for k, _ in rows]),
                  torch.stack([v for _, v in rows]), *slot_writes)
    return sh.gather_slots(logits, slot_writes[0].shape[0], 0)


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
        x = _ffn(params, lp, cfg, x + _attn_out(params, lp.attn.wo, o))[0]
    return _logits(params, cfg, x)
