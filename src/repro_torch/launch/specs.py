"""Partition specs, step functions and input specs (port of the JAX
package's ``launch/specs.py``): the tensor-parallel cut that serving
reads, and the dry run's half.

A spec is a tuple with one entry per dimension: a mesh axis name (or a
tuple of names), or None for a replicated dimension.  :func:`leaf_spec` is
the reference's ``_leaf_spec`` (``wq``/``wk``/``wv``, ``w_gate``/``w_up``
and the SSM's input projections column-parallel on ``model``,
``wo``/``w_down``/``out_proj`` row-parallel, a MoE's routed experts on
their expert axis, ``embed`` on its vocabulary rows, ``lm_head`` on its
last dimension; with ``fsdp`` the complementary dimension on ``data``, the
train rows' description; with ``replicate_ssm`` every SSM leaf whole) and
:func:`guard` its ``_guard`` (an axis that does not divide its dimension
is dropped); both read the JAX tree's paths, layers stacked on axis 0.
:func:`param_pspecs` applies them, without FSDP, to the port's per-layer
parameters, with rules of the port's own, each where the port runs a
collective of its own in place of GSPMD's:

* **attention by whole kv heads**: where the kv heads do not divide the
  ``model`` axis, every attention leaf (self, cross and the encoder's) is
  replicated (the reference cuts ``wq``'s columns anyway and lets GSPMD
  move the activations; the port's kernels run on whole heads with no
  collective inside attention);
* **biases follow their weights**: the QKV biases and whisper's MLP
  ``b_up`` take their weights' columns (the reference keeps them whole and
  GSPMD slices them at the add); ``b_down`` stays whole and is added once,
  after the row-parallel sum;
* **the router whole**: the reference cuts ``router``'s expert columns
  and gathers the fp32 logits; the port routes on every rank from the
  whole ``(D, E)`` router (512 KB a layer at deepseek), so every rank
  computes the same choices, buffer positions and drops;
* **``in_proj`` by halves**: it holds ``[x | z]``; a contiguous column
  cut would give one rank all of x and another all of z, so each half is
  cut by the rank's SSD heads (:data:`HALVED`, :func:`shard_leaf`'s
  ``halves``);
* **``bc_proj`` whole**: B and C are shared by every head, and a column
  cut would split B from C;
* **the SSM's 1-D leaves by heads**: ``dt_bias``, ``A_log``, ``D`` (the
  rank's heads), ``conv_b`` and ``out_norm`` (its channels), which the
  reference leaves whole; ``out_norm``'s sum of squares is summed over the
  ranks (``ServingSharding.rms_norm``);
* **``replicate_ssm``** (the reference's flag, set as its serving plan
  sets it): where the SSD heads do not divide the axis (hymba's 25), every
  SSM leaf is whole and each rank runs every head.

:func:`param_pspecs` is the one decision; :func:`cuts` reads from its
specs which products are cut, :func:`local_config` (the config whose
shapes one rank's shard, KV pool and dense cache have) and
:func:`local_widths` (the widths a config cannot carry: the rank's routed
experts, shared experts' hidden units and SSD heads) read :func:`cuts`.
A rank's config keeps the whole ``num_experts`` (``capacity`` and
``route`` read it: a rank routes as the whole model does) and the whole
SSM fields (``ssm_inner`` is derived from ``d_model``): the rank's shard
carries those widths in its parameters' shapes and the plan.
:func:`shard_params` cuts a whole :class:`~repro_torch.models.transformer.
Transformer` into one rank's shard.

The dry run's half runs on the ``meta`` device: :func:`make_step_fn` and
:func:`input_specs` (``prefill``, ``mpic_prefill`` and ``decode`` on the
dense cache), :func:`make_serving_step_fn` and :func:`serving_input_specs`
(``serve_decode`` and ``serve_prefill`` on the paged pool, laid out by
``ServingSharding``), :func:`step_kind`, :func:`decode_kv_len` and
:func:`cache_pspecs`.  Inputs are ``meta`` tensors of the global shapes
beside their specs, where the reference has ``ShapeDtypeStruct`` and
``NamedSharding``; :func:`localize` cuts them to one rank's shapes.
:func:`cache_pspecs` is the reference's; :func:`rank_cache_pspecs` turns
it into the port's dense-cache cut (kv heads on ``model`` where attention
is cut, whole where it is not, where the reference cuts the sequence; the
SSM state by the rank's heads and channels where the SSM is cut), which
:func:`localize` follows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import activation_rules
from repro_torch.launch.pspec import axis_divides
from repro_torch.weights import leaf_path

Spec = Tuple

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "bc_proj", "dt_proj",
        "router"}
_ROW = {"wo", "w_down", "out_proj"}
_ATTN = ("attn", "cross_attn")
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv", "b_up": "w_up"}
# the port's SSM cut: leaves cut by the rank's heads or channels (the
# reference keeps the 1-D ones whole) and leaves kept whole
_SSM_BY_HEADS = ("dt_bias", "A_log", "D", "conv_b", "out_norm")
_SSM_WHOLE = ("bc_proj",)
# leaves holding two blocks side by side on their cut dimension, each cut
# by the rank's share: the SSM's in_proj, [x | z]
HALVED = ("in_proj",)


def leaf_spec(path: str, ndim: int, *, fsdp: bool = False,
              replicate_ssm: bool = False) -> Spec:
    """One parameter leaf of the JAX tree (``path`` like
    ``/layers/attn/wq``, ``ndim`` counting the stacked layer axis) -> its
    spec: tensor parallelism on ``model``, and with ``fsdp`` the other
    matrix dimension on ``data``; ``replicate_ssm`` keeps every SSM leaf
    whole (the SSD heads do not divide the axis)."""
    name = path.split("/")[-1]
    stacked = "/layers/" in path or "/enc_layers/" in path
    spec = [None] * ndim
    if replicate_ssm and "/ssm/" in path:
        return tuple(spec)
    if name == "embed":
        spec[0] = "model"
        if fsdp:
            spec[1] = "data"
    elif name == "lm_head":
        spec[-1] = "model"
        if fsdp:
            spec[-2] = "data"
    elif name in ("pos_embed", "enc_pos_embed"):
        if fsdp and ndim >= 2:
            spec[-2] = "data"
    elif name in _COL and ndim >= 2:
        spec[-1] = "model"
        if fsdp:
            spec[-2] = "data"
    elif name in _ROW and ndim >= 2:
        spec[-2] = "model"
        if fsdp:
            spec[-1] = "data"
    elif name == "conv_w" and ndim >= 2:
        spec[-1] = "model"
    if "/moe/" in path and name in ("w_gate", "w_up", "w_down") and \
            "/shared/" not in path:
        spec = [None] * ndim
        spec[1 if stacked else 0] = "model"
        if fsdp:
            spec[-1 if name == "w_down" else -2] = "data"
    return tuple(spec)


def guard(spec: Spec, shape, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dimension."""
    return tuple(s if s is not None and axis_divides(mesh, s, shape[i])
                 else None for i, s in enumerate(spec))


def _meta_params(cfg):
    from repro_torch.models.transformer import Transformer
    return Transformer(cfg, device="meta")


def replicate_ssm(cfg, mesh) -> bool:
    """The reference's ``replicate_ssm`` of its serving plan: a model with
    SSD heads that do not divide the ``model`` axis."""
    return bool((cfg.attn_free or cfg.hybrid) and not axis_divides(
        mesh, "model", cfg.ssm_num_heads))


def param_pspecs(cfg, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} for the port's parameters of ``cfg`` (one
    layer's leaves unstacked: the reference's decision with the layer axis
    dropped), under the port's rules (the module's notes)."""
    attn_ok = bool(cfg.num_kv_heads) and axis_divides(
        mesh, activation_rules()["kv_heads"], cfg.num_kv_heads)
    rep_ssm = replicate_ssm(cfg, mesh)
    specs = {}
    for name, p in _meta_params(cfg).named_parameters():
        path, index = leaf_path(name)
        stacked = index is not None
        shape = ((cfg.num_layers if path[0] == "layers"
                  else cfg.encoder_layers),) * stacked + tuple(p.shape)
        s = guard(leaf_spec("/" + "/".join(path), len(shape),
                            replicate_ssm=rep_ssm), shape, mesh)
        specs[name] = s[1:] if stacked else s
    for name in specs:
        parts = name.split(".")
        if len(parts) < 2:
            continue
        if parts[-2] == "moe" and parts[-1] == "router":
            specs[name] = (None, None)
        elif parts[-2] == "ssm" and not rep_ssm:
            if parts[-1] in _SSM_WHOLE:
                specs[name] = (None,) * len(specs[name])
            elif parts[-1] in _SSM_BY_HEADS:
                specs[name] = ("model",)
        elif parts[-2] in _ATTN and not attn_ok:
            specs[name] = (None,) * len(specs[name])
        elif parts[-1] in _BIAS_OF and (parts[-2] in _ATTN
                                        or parts[-2] == "mlp"):
            specs[name] = specs[".".join(parts[:-1] + [_BIAS_OF[parts[-1]]])
                                ][-1:]
    return specs


@dataclasses.dataclass(frozen=True)
class Cuts:
    """Which products the ``model`` axis cuts: attention (by whole kv
    heads, and with it the KV pool, its int8 scales, the dense cache and
    whisper's cross K/V), the MLP (by ``d_ff``; a MoE's shared experts by
    their hidden units), the embedding and the head (by vocabulary), a
    MoE's routed experts (by expert) and the SSD heads (by head, and with
    them the SSM state)."""
    attn: bool
    mlp: bool
    vocab: bool
    experts: bool = False
    ssm: bool = False


def cuts(specs: Dict[str, Spec]) -> Cuts:
    """What :func:`param_pspecs`' ``specs`` cut."""
    def cut(name, dim):
        return name in specs and specs[name][dim] == "model"
    return Cuts(attn=cut("layers.0.attn.wk", -1),
                mlp=(cut("layers.0.mlp.w_down", 0)
                     or cut("layers.0.moe.shared.w_down", 0)),
                vocab=cut("embed", 0), experts=cut("layers.0.moe.w_down", 0),
                ssm=cut("layers.0.ssm.dt_proj", -1))


def halves(name: str) -> int:
    """How many blocks sit side by side on a leaf's cut dimension: 2 for
    :data:`HALVED`, else 1."""
    return 2 if name.split(".")[-1] in HALVED else 1


def shard_leaf(t: torch.Tensor, spec: Spec, mesh, halves: int = 1
               ) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``spec``: a view, or with
    ``halves`` > 1 the rank's piece of each of that many equal blocks of
    the cut dimension, concatenated (a copy)."""
    for d, ax in enumerate(spec):
        if ax != "model":
            continue
        if halves > 1:
            return torch.cat([shard_leaf(b, spec, mesh) for b in
                              torch.chunk(t, halves, dim=d)], dim=d)
        n = t.shape[d] // mesh.model
        t = t.narrow(d, mesh.rank * n, n)
    return t


def local_config(cfg, c: Cuts, m: int):
    """The config whose shapes one rank's shard has on a ``model`` axis of
    ``m``: its kv and query heads, its slice of ``d_ff`` and of the
    vocabulary, each only where ``c`` cuts them (``head_dim`` stays
    explicit).  A MoE's ``d_ff`` (the routed experts' hidden units, whole
    on every rank), ``num_experts`` and the SSM fields stay whole: see
    :func:`local_widths`."""
    over = {"head_dim": cfg.head_dim}
    if c.attn:
        over.update(num_heads=cfg.num_heads // m,
                    num_kv_heads=cfg.num_kv_heads // m)
    if c.mlp and cfg.arch_type != "moe":
        over["d_ff"] = cfg.d_ff // m
    if c.vocab:
        over["vocab_size"] = cfg.vocab_size // m
    return dataclasses.replace(cfg, **over)


@dataclasses.dataclass(frozen=True)
class Widths:
    """The widths of one rank's shard that its config does not carry: the
    routed experts it holds, its shared experts' hidden units and its SSD
    heads (``ssm_heads x ssm_head_dim`` channels).  :meth:`whole` gives
    an unsharded model's."""
    experts: int
    shared_ff: int
    ssm_heads: int

    @classmethod
    def whole(cls, cfg) -> "Widths":
        return cls(experts=cfg.num_experts,
                   shared_ff=cfg.d_ff * cfg.num_shared_experts,
                   ssm_heads=cfg.ssm_num_heads if cfg.ssm_state else 0)


def local_widths(cfg, c: Cuts, m: int) -> Widths:
    """:class:`Widths` of one rank's shard on a ``model`` axis of ``m``."""
    w = Widths.whole(cfg)
    return Widths(experts=w.experts // m if c.experts else w.experts,
                  shared_ff=(w.shared_ff // m
                             if c.mlp and cfg.arch_type == "moe"
                             else w.shared_ff),
                  ssm_heads=w.ssm_heads // m if c.ssm else w.ssm_heads)


def shard_params(params, mesh, specs: Dict[str, Spec] = None):
    """One rank's shard of a whole ``Transformer``: a ``Transformer`` of
    :func:`local_config`'s and :func:`local_widths`' shapes on the same
    device holding copies of the rank's pieces (``specs`` defaults to
    :func:`param_pspecs` of the params' config).  Its ``sharding`` is left
    for the caller to set."""
    from repro_torch.models.transformer import Transformer
    cfg = params.cfg
    specs = specs or param_pspecs(cfg, mesh)
    c = cuts(specs)
    shard = Transformer(local_config(cfg, c, mesh.model),
                        device=params.embed.device,
                        widths=local_widths(cfg, c, mesh.model))
    whole = dict(params.named_parameters())
    with torch.no_grad():
        for name, p in shard.named_parameters():
            p.copy_(shard_leaf(whole[name], specs[name], mesh, halves(name)))
    return shard


# ---------------------------------------------------------------------------
# the dry run: which steps, their inputs and the dense cache's specs
# ---------------------------------------------------------------------------

def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def step_kind(cfg, shape) -> Optional[str]:
    """The step a shape runs for this arch; None: skipped (the
    reference's rule)."""
    if shape.kind == "train":
        return "train"
    if shape.kind == "prefill":
        return "prefill"
    if shape.seq_len > 32768:
        if cfg.is_encoder_decoder:
            return None        # whisper: the decoder's context is small
        if cfg.arch_type == "ssm" or cfg.hybrid or cfg.sliding_window:
            return "decode"    # a sub-quadratic path exists
        return None
    return "decode"


def decode_kv_len(cfg, shape) -> int:
    """The cache a decode shape needs: the window for a long context with
    one (the sub-quadratic path)."""
    if shape.seq_len > 32768 and cfg.sliding_window:
        return cfg.sliding_window
    return shape.seq_len


def _dims(cfg, shape, mesh):
    """(batch spec, kv-sequence spec, multi_pod): the batch on the batch
    axes where they divide it, else on ``data`` alone, else nowhere, and
    then a long decode's KV sequence on ``data``."""
    multi_pod = "pod" in mesh.axis_names
    ba = activation_rules(multi_pod=multi_pod)["batch"]
    sizes = _sizes(mesh)
    bsz = 1
    for a in ba:
        bsz *= sizes[a]
    batch_spec = ba if shape.global_batch % bsz == 0 else (
        ("data",) if shape.global_batch % sizes["data"] == 0 else None)
    kv_seq_spec = "data" if batch_spec is None else None
    return batch_spec, kv_seq_spec, multi_pod


def _kv_head_axis(cfg, mesh):
    return "model" if (cfg.num_kv_heads and cfg.num_kv_heads
                       % _sizes(mesh)["model"] == 0) else None


def _axis(spec):
    """One axis named by a 1-tuple is named alone (as ``PartitionSpec``
    normalizes it)."""
    return spec[0] if isinstance(spec, tuple) and len(spec) == 1 else spec


def cache_pspecs(cfg, mesh, batch_spec, kv_seq_spec) -> Dict[str, Spec]:
    """Specs of the dense cache's tensors (the reference's; see the
    module's docstring for where the port's cut differs)."""
    batch_spec = _axis(batch_spec)
    kh = _kv_head_axis(cfg, mesh)
    seq_model = None if kh else "model"
    out = {}
    if not cfg.attn_free:
        kv = (None, batch_spec, kv_seq_spec or seq_model, kh, None)
        out["k"] = out["v"] = kv
        out["pos"] = (batch_spec, kv_seq_spec or seq_model)
    if cfg.arch_type == "ssm" or cfg.hybrid:
        out["ssm_h"] = (None, batch_spec, None, None, None)
        out["ssm_conv"] = (None, batch_spec, None, "model"
                           if cfg.ssm_inner % mesh.shape[-1] == 0 else None)
    if cfg.is_encoder_decoder:
        out["cross_k"] = out["cross_v"] = (None, batch_spec, None,
                                           _kv_head_axis(cfg, mesh), None)
    return out


def rank_cache_pspecs(cfg, mesh, specs: Dict[str, Spec], c: Cuts
                      ) -> Dict[str, Spec]:
    """The port's dense-cache cut from :func:`cache_pspecs`' ``specs``:
    ``model`` only where the port cuts (the kv heads and the cross K/V's
    heads where attention is cut, none where it is not; the SSM state's
    heads and the conv state's channels where the SSD heads are)."""
    out = {}
    for key, sp in specs.items():
        sp = tuple(None if ax == "model" else ax for ax in sp)
        if key in ("k", "v", "cross_k", "cross_v") and c.attn:
            sp = sp[:3] + ("model",) + sp[4:]
        elif key == "ssm_h" and c.ssm:
            sp = sp[:2] + ("model",) + sp[3:]
        elif key == "ssm_conv" and c.ssm:
            sp = sp[:3] + ("model",)
        out[key] = sp
    return out


def make_step_fn(cfg, kind: str, shape, model=None):
    """The step ``kind`` runs, as a function of the parameters and
    :func:`input_specs`' inputs, through the port's passes (``cfg``: the
    config whose shapes the parameters have, a rank's
    :func:`local_config` under a mesh; ``model`` the facade to run, a
    rank's ``ServingSharding.local_model()``, by default ``cfg``'s)."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    model = model or build_model(cfg)

    if kind == "prefill":
        def fn(params, batch):
            tokens = batch["tokens"]
            cache = model.make_cache(tokens.shape[0], tokens.shape[1],
                                     device=tokens.device)
            return model.prefill(
                params, tokens, cache,
                media_embeds=batch.get("media_embeds"),
                media_mask=batch.get("media_mask"),
                audio_embeds=batch.get("audio_embeds"))
        return fn

    if kind == "mpic_prefill":
        def fn(params, batch, cache):
            return model.selective_prefill(
                params, batch["sel_tokens"], batch["sel_pos"], cache,
                batch["sel_pos"], media_embeds=batch.get("media_embeds"),
                media_mask=batch.get("media_mask"))
        return fn

    if kind == "decode":
        def fn(params, cache, token, position):
            window = cfg.sliding_window
            wi = (position % window if shape.seq_len > 32768 and window
                  else position)            # a ring buffer's slot
            x = model.embed(params, token, positions=position)
            logits, cache = tf.forward_with_cache(params, cfg, x, position,
                                                  cache, wi)
            return logits[:, -1, :], cache
        return fn

    if kind == "train":
        raise NotImplementedError(
            "the train step under a mesh is not ported (ROADMAP.md, queue 1 "
            "item 6)")
    raise ValueError(kind)


# the share of a prompt that an mpic prefill recomputes (the reference's
# ``mpic_sel_frac``)
MPIC_SEL_FRAC = 0.125


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, kind: str, mesh):
    """``(args, specs)``: ``meta`` tensors of every input of the step at
    its global shapes, and their specs (the reference's layout)."""
    from repro_torch.device import torch_dtype
    batch_spec, kv_seq_spec, _ = _dims(cfg, shape, mesh)
    b, s = shape.global_batch, shape.seq_len
    cd, i32 = torch_dtype(cfg.compute_dtype), torch.int32
    rows, rows3 = (_axis(batch_spec), None), (_axis(batch_spec), None, None)

    def media(batch, specs, n):
        if cfg.is_multimodal:
            batch["media_embeds"] = _meta((b, n, cfg.d_model), cd)
            batch["media_mask"] = _meta((b, n), torch.bool)
            specs["media_embeds"], specs["media_mask"] = rows3, rows
        if cfg.is_encoder_decoder:
            batch["audio_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                          cd)
            specs["audio_embeds"] = rows3

    if kind in ("train", "prefill"):
        batch, specs = {"tokens": _meta((b, s), i32)}, {"tokens": rows}
        if kind == "train":
            batch["labels"], specs["labels"] = _meta((b, s), i32), rows
        media(batch, specs, s)
        return (batch,), (specs,)

    if kind == "mpic_prefill":
        s_sel = max(int(s * MPIC_SEL_FRAC), 1)
        batch = {"sel_tokens": _meta((b, s_sel), i32),
                 "sel_pos": _meta((b, s_sel), i32)}
        specs = {"sel_tokens": rows, "sel_pos": rows}
        if cfg.is_multimodal:
            batch["media_embeds"] = _meta((b, s_sel, cfg.d_model), cd)
            batch["media_mask"] = _meta((b, s_sel), torch.bool)
            specs["media_embeds"], specs["media_mask"] = rows3, rows
        cache, cache_sp = _cache_specs(cfg, mesh, b, s, batch_spec,
                                       kv_seq_spec)
        return (batch, cache), (specs, cache_sp)

    if kind == "decode":
        cache, cache_sp = _cache_specs(cfg, mesh, b, decode_kv_len(cfg, shape),
                                       batch_spec, kv_seq_spec)
        tok = _meta((b, 1), i32)
        return (cache, tok, _meta((b, 1), i32)), (cache_sp, rows, rows)

    raise ValueError(kind)


def _cache_specs(cfg, mesh, batch: int, kv_len: int, batch_spec,
                 kv_seq_spec):
    from repro_torch.device import torch_dtype
    cd = torch_dtype(cfg.compute_dtype)
    L = cfg.num_layers
    specs = cache_pspecs(cfg, mesh, batch_spec, kv_seq_spec)
    cache = {}
    if not cfg.attn_free:
        kv = (L, batch, kv_len, cfg.num_kv_heads, cfg.head_dim)
        cache["k"], cache["v"] = _meta(kv, cd), _meta(kv, cd)
        cache["pos"] = _meta((batch, kv_len), torch.int32)
    if cfg.arch_type == "ssm" or cfg.hybrid:
        cache["ssm_h"] = _meta((L, batch, cfg.ssm_num_heads, cfg.ssm_state,
                                cfg.ssm_head_dim), torch.float32)
        cache["ssm_conv"] = _meta((L, batch, cfg.ssm_conv_width - 1,
                                   cfg.ssm_inner), cd)
    if cfg.is_encoder_decoder:
        cross = (L, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["cross_k"], cache["cross_v"] = _meta(cross, cd), _meta(cross,
                                                                     cd)
    return cache, {k: specs[k] for k in cache}


def localize(args, specs, mesh, *, cut_model: bool = True):
    """One rank's ``meta`` inputs from global ``args`` and their
    ``specs`` (nested alike: tuples and dicts of tensors): each dimension
    divided by the sizes of the axes its spec names.  ``cut_model=False``
    keeps ``model`` dimensions whole (the port's dense cache where
    attention is replicated)."""
    sizes = _sizes(mesh)
    if isinstance(args, dict):
        return {k: localize(v, specs[k], mesh, cut_model=cut_model)
                for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        return type(args)(localize(a, sp, mesh, cut_model=cut_model)
                          for a, sp in zip(args, specs))
    shape = list(args.shape)
    for d, ax in enumerate(specs):
        names = ax if isinstance(ax, tuple) else (ax,)
        for n in names:
            if n is None or (n == "model" and not cut_model):
                continue
            if shape[d] % sizes[n]:
                raise ValueError(f"dimension {d} of {tuple(args.shape)} does "
                                 f"not divide over {n} ({sizes[n]})")
            shape[d] //= sizes[n]
    return torch.empty(shape, dtype=args.dtype, device="meta")


# ---------------------------------------------------------------------------
# the serving steps on the paged pool
# ---------------------------------------------------------------------------

SERVE_PAGE_SIZE = 16


def make_serving_step_fn(cfg, kind: str):
    """The engine's paged step as a function of the parameters and
    :func:`serving_input_specs`' inputs: ``serve_decode``
    one token for every slot against the pool, ``serve_prefill`` the
    paged selective prefill of one admission (``cfg``: the config of the
    parameters' shapes, a rank's ``local_config``)."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    model = build_model(cfg)

    if kind == "serve_decode":
        def fn(params, pool_k, pool_v, token, position, page_table, lengths,
               write_pages, write_offs):
            x = model.embed(params, token, positions=position)
            return tf.decode_paged(params, cfg, x, position, pool_k, pool_v,
                                   page_table, lengths, write_pages,
                                   write_offs)
        return fn

    if kind == "serve_prefill":
        def fn(params, pool_k, pool_v, sel_tokens, sel_pos, page_table,
               lengths, write_pages, write_offs):
            x = model.embed(params, sel_tokens, positions=sel_pos)
            return tf.selective_prefill_paged(
                params, cfg, x, sel_pos, pool_k, pool_v, page_table, lengths,
                write_pages, write_offs)
        return fn

    raise ValueError(kind)


def serving_input_specs(cfg, mesh, *, slots: int, kv_len: int, kind: str,
                        s_sel: Optional[int] = None):
    """``(args, specs)`` of the serving step's inputs at global shapes:
    the pool cut as ``ServingSharding`` cuts it (kv heads on ``model``
    where attention is cut), everything else replicated, as every rank
    builds the same host operands.  ``serve_prefill`` is one admission
    (batch 1) of ``s_sel`` selected tokens (``kv_len x MPIC_SEL_FRAC`` by
    default), on pages of ``SERVE_PAGE_SIZE`` slots."""
    from repro_torch.device import torch_dtype
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, cfg)
    cd, i32 = torch_dtype(cfg.compute_dtype), torch.int32
    page_size = SERVE_PAGE_SIZE
    pages_per_slot = -(-kv_len // page_size)
    num_pages = slots * pages_per_slot + 1          # + the scratch page
    pool = _meta((cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                  cfg.head_dim), cd)
    pool_sp = (None, None, None, "model" if sh.attn else None, None)
    rep1, rep2 = (None,), (None, None)

    if kind == "serve_decode":
        tok, vec = _meta((slots, 1), i32), _meta((slots,), i32)
        table = _meta((slots, pages_per_slot), i32)
        return ((pool, pool, tok, tok, table, vec, vec, vec),
                (pool_sp, pool_sp, rep2, rep2, rep2, rep1, rep1, rep1))

    if kind == "serve_prefill":
        n = s_sel or max(int(kv_len * MPIC_SEL_FRAC), 1)
        sel = _meta((1, n), i32)
        return ((pool, pool, sel, sel, _meta((1, pages_per_slot), i32),
                 _meta((1,), i32), sel, sel),
                (pool_sp, pool_sp, rep2, rep2, rep2, rep1, rep2, rep2))

    raise ValueError(kind)
