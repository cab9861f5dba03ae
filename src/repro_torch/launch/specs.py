"""Tensor-parallel partition specs of the serving path (port of the part of
the JAX package's ``launch/specs.py`` that serving reads; its dry-run step
functions, input specs and dense-cache specs are not ported yet, ROADMAP.md
queue 1).

A spec is a tuple with one entry per dimension: a mesh axis name, or None
for a replicated dimension.  :func:`leaf_spec` is the reference's
``_leaf_spec`` without FSDP (``wq``/``wk``/``wv``, ``w_gate``/``w_up``
and the SSM's input projections column-parallel on ``model``,
``wo``/``w_down``/``out_proj`` row-parallel, ``embed`` on its vocabulary
rows, ``lm_head`` on its last dimension) and :func:`guard` its ``_guard``
(an axis that does not divide its dimension is dropped); both read the
JAX tree's paths, layers stacked on axis 0.  :func:`param_pspecs` applies
them to the port's per-layer parameters, with two rules of the port's own:

* attention is cut by whole kv heads or not at all: where the kv heads do
  not divide the ``model`` axis, every attention leaf is replicated (the
  reference cuts ``wq``'s columns anyway and lets GSPMD move the
  activations; the port's kernels run on whole heads with no collective
  inside attention);
* the QKV biases follow their weights' columns (the reference keeps them
  whole and GSPMD slices them at the add).

:func:`param_pspecs` is the one decision; :func:`cuts` reads from its
specs which products are cut, and :func:`local_config` (the config whose
shapes one rank's shard, KV pool and dense cache have) reads :func:`cuts`.
:func:`shard_params` cuts a whole :class:`~repro_torch.models.transformer.
Transformer` into one rank's shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.launch.mesh import serving_rules
from repro_torch.launch.pspec import axis_divides
from repro_torch.weights import leaf_path

Spec = Tuple

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "bc_proj", "dt_proj",
        "router"}
_ROW = {"wo", "w_down", "out_proj"}
_ATTN = ("attn",)
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv"}


def leaf_spec(path: str, ndim: int) -> Spec:
    """One parameter leaf of the JAX tree (``path`` like
    ``/layers/attn/wq``, ``ndim`` counting the stacked layer axis) -> its
    spec: tensor parallelism on ``model``."""
    name = path.split("/")[-1]
    stacked = "/layers/" in path or "/enc_layers/" in path
    spec = [None] * ndim
    if name == "embed":
        spec[0] = "model"
    elif name == "lm_head":
        spec[-1] = "model"
    elif name in _COL and ndim >= 2:
        spec[-1] = "model"
    elif name in _ROW and ndim >= 2:
        spec[-2] = "model"
    elif name == "conv_w" and ndim >= 2:
        spec[-1] = "model"
    if "/moe/" in path and name in ("w_gate", "w_up", "w_down") and \
            "/shared/" not in path:
        spec = [None] * ndim
        spec[1 if stacked else 0] = "model"
    return tuple(spec)


def guard(spec: Spec, shape, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dimension."""
    return tuple(s if s is not None and axis_divides(mesh, s, shape[i])
                 else None for i, s in enumerate(spec))


def _meta_params(cfg):
    from repro_torch.models.transformer import Transformer
    return Transformer(cfg, device="meta")


def param_pspecs(cfg, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} for the port's parameters of ``cfg`` (one
    layer's leaves unstacked: the reference's decision with the layer axis
    dropped), under the port's attention and bias rules."""
    attn_ok = bool(cfg.num_kv_heads) and axis_divides(
        mesh, serving_rules()["kv_heads"], cfg.num_kv_heads)
    specs = {}
    for name, p in _meta_params(cfg).named_parameters():
        path, index = leaf_path(name)
        stacked = index is not None
        shape = ((cfg.num_layers if path[0] == "layers"
                  else cfg.encoder_layers),) * stacked + tuple(p.shape)
        s = guard(leaf_spec("/" + "/".join(path), len(shape)), shape, mesh)
        specs[name] = s[1:] if stacked else s
    for name in specs:
        parts = name.split(".")
        if len(parts) < 2 or parts[-2] not in _ATTN:
            continue
        if not attn_ok:
            specs[name] = (None,) * len(specs[name])
        elif parts[-1] in _BIAS_OF:
            specs[name] = specs[".".join(parts[:-1] + [_BIAS_OF[parts[-1]]])
                                ][-1:]
    return specs


@dataclasses.dataclass(frozen=True)
class Cuts:
    """Which products the ``model`` axis cuts: attention (by whole kv
    heads, and with it the KV pool, its int8 scales and the dense cache),
    the MLP (by ``d_ff``), the embedding and the head (by vocabulary)."""
    attn: bool
    mlp: bool
    vocab: bool


def cuts(specs: Dict[str, Spec]) -> Cuts:
    """What :func:`param_pspecs`' ``specs`` cut."""
    def cut(name, dim):
        return name in specs and specs[name][dim] == "model"
    return Cuts(attn=cut("layers.0.attn.wk", -1),
                mlp=cut("layers.0.mlp.w_down", 0), vocab=cut("embed", 0))


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``spec`` (a view)."""
    for d, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[d] // mesh.model
            t = t.narrow(d, mesh.rank * n, n)
    return t


def local_config(cfg, c: Cuts, m: int):
    """The config whose shapes one rank's shard has on a ``model`` axis of
    ``m``: its kv and query heads, its slice of ``d_ff`` and of the
    vocabulary, each only where ``c`` cuts them (``head_dim`` stays
    explicit)."""
    over = {"head_dim": cfg.head_dim}
    if c.attn:
        over.update(num_heads=cfg.num_heads // m,
                    num_kv_heads=cfg.num_kv_heads // m)
    if c.mlp:
        over["d_ff"] = cfg.d_ff // m
    if c.vocab:
        over["vocab_size"] = cfg.vocab_size // m
    return dataclasses.replace(cfg, **over)


def shard_params(params, mesh, specs: Dict[str, Spec] = None):
    """One rank's shard of a whole ``Transformer``: a ``Transformer`` of
    :func:`local_config`'s shapes on the same device holding copies of the
    rank's pieces (``specs`` defaults to :func:`param_pspecs` of the
    params' config).  Its ``sharding`` is left for the caller to set."""
    from repro_torch.models.transformer import Transformer
    cfg = params.cfg
    specs = specs or param_pspecs(cfg, mesh)
    shard = Transformer(local_config(cfg, cuts(specs), mesh.model),
                        device=params.embed.device)
    whole = dict(params.named_parameters())
    with torch.no_grad():
        for name, p in shard.named_parameters():
            p.copy_(shard_leaf(whole[name], specs[name], mesh))
    return shard
