"""The tensor-parallel serving plan (port of the JAX package's
``serving/sharding.py``).

One :class:`ServingSharding` per rank derives every placement from the
mesh and the model's config through the parameter specs
(``launch/specs.py``, which decide through the one divisibility rule of
``launch/pspec.py``):

* the parameters (``specs``; :meth:`shard` cuts a whole model, and
  ``init_params(sharding=)`` draws a rank's shard directly);
* what the specs cut (``cuts``: attention, the MLP, the vocabulary, a
  MoE's routed experts, the SSD heads), the config of the rank's shapes
  (:attr:`local_cfg`) and the widths it cannot carry (:attr:`widths`:
  routed experts, shared experts' hidden units, SSD heads), at which the
  engine allocates the paged KV pool and its int8 scales (kv heads on
  ``model`` where attention is cut) and the dense cache (kv heads, the
  cross K/V's heads, the SSM state's heads and channels) straight, never
  whole;
* small host operands (tokens, page tables, lengths): replicated, every
  rank builds the same ones.

It also carries the collectives the model passes run (the reference's
GSPMD inserts them): the vocab-parallel embedding (a masked local lookup
summed over the ranks), the row-parallel products (fp32 partial sums,
summed, then rounded once; whisper's ``b_down`` added once after the
sum), the vocab-parallel LM head (local fp32 logits, gathered), the K/V
head gather of an upload, the experts' combine (each rank's pairs summed
over the k choices in fp32, with the shared experts' row-parallel
partial in the same all-reduce, each rounded once: :meth:`reduce`) and
the SSM's ``out_norm`` over all channels (the ranks' sums of squares
summed before the ``rsqrt``: :meth:`rms_norm`).  Attention runs on a
rank's own kv heads with no collective inside; where the kv heads do not
divide the axis, attention is replicated and the MLP stays cut; where the
SSD heads do not, every SSM leaf is whole (the reference's
``replicate_ssm``) and each rank runs every head.  Routing is whole on
every rank (``launch/specs.py``).

Library entries stay whole (all heads), so that the memory tiers and the
spool and wire formats stay those of the unsharded engine: an upload
gathers its K/V heads once, and a link reads the rank's heads of an entry
through :meth:`entry`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cache.quant import QuantizedKV
from repro_torch.launch import specs as S


class EntryShard:
    """A library entry's view through one rank: its K/V (and int8 bytes
    and scales) cut to the rank's kv heads.  Views, no copies; the entry
    is loaded before it is viewed."""

    def __init__(self, entry, lo: int, n: int):
        self._entry, self._lo, self._n = entry, lo, n

    def _cut(self, t):
        return None if t is None else t.narrow(2, self._lo, self._n)

    def _cut_q(self, qkv: Optional[QuantizedKV]):
        if qkv is None:
            return None
        return QuantizedKV(q=self._cut(qkv.q), scale=self._cut(qkv.scale),
                           block_tokens=qkv.block_tokens)

    k = property(lambda s: s._cut(s._entry.k))
    v = property(lambda s: s._cut(s._entry.v))
    qk = property(lambda s: s._cut_q(s._entry.qk))
    qv = property(lambda s: s._cut_q(s._entry.qv))


class ServingSharding:
    """Mesh + the whole model's config -> one rank's plan."""

    def __init__(self, mesh, model_cfg):
        cfg = model_cfg
        self.mesh = mesh
        self.cfg = cfg
        self.specs = S.param_pspecs(cfg, mesh)
        self.whole_shapes = {n: tuple(p.shape) for n, p in
                             S._meta_params(cfg).named_parameters()}
        # which products are cut: attention by whole kv heads, the MLP by
        # d_ff, the embedding and the head by vocabulary, the routed
        # experts by expert, the SSD heads by head
        self.cuts = S.cuts(self.specs)
        self.attn, self.mlp, self.vocab = (
            self.cuts.attn, self.cuts.mlp, self.cuts.vocab)
        self.experts, self.ssm = self.cuts.experts, self.cuts.ssm
        self.local_cfg = S.local_config(cfg, self.cuts, mesh.model)
        self.widths = S.local_widths(cfg, self.cuts, mesh.model)
        # the rank's routed experts [lo, lo + n)
        n = self.widths.experts
        self.expert_range = (mesh.rank * n if self.experts else 0, n)

    # -- parameters ---------------------------------------------------------
    def shard_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return S.shard_leaf(t, self.specs[name], self.mesh, S.halves(name))

    def shard(self, params):
        """This rank's shard of ``params``: cut from a whole model, or
        ``params`` itself when it is one already."""
        if params.sharding is not None:
            return params
        shard = S.shard_params(params, self.mesh, self.specs)
        shard.sharding = self
        return shard

    def local_model(self):
        """The model facade the rank serves with (:attr:`local_cfg`; the
        plan rides on the rank's parameters)."""
        from repro_torch.models.model import Model
        return Model(self.local_cfg, widths=self.widths)

    # -- K/V heads ------------------------------------------------------------
    @property
    def _heads(self):
        n = self.local_cfg.num_kv_heads
        return self.mesh.rank * n, n

    def local_heads(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The rank's kv heads of a whole K/V tensor (a view)."""
        if not self.attn:
            return t
        lo, n = self._heads
        return t.narrow(dim, lo, n)

    def entry(self, e):
        """A library entry as the rank links it."""
        if not self.attn or e is None:
            return e
        return EntryShard(e, *self._heads)

    def gather_heads(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """Every rank's kv heads of a K/V tensor, in head order."""
        return self.mesh.all_gather(t, dim) if self.attn else t

    # -- the passes' collectives ----------------------------------------------
    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """Vocab-parallel lookup: the rows this rank holds, zeros for the
        others, summed over the ranks (exact: one nonzero term)."""
        if not self.vocab:
            return table[tokens.long()]
        n = table.shape[0]
        local = tokens.long() - self.mesh.rank * n
        mine = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
        return self.mesh.all_reduce(x)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits from every rank's slice."""
        return self.mesh.all_gather(logits, -1) if self.vocab else logits

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor):
        """``x @ w`` of a row-parallel weight: this rank's partial product
        with an fp32 result, summed over the ranks in fp32, rounded once to
        x's dtype, as the whole product's fp32 accumulation rounds once."""
        return self.mesh.all_reduce(_fp32_matmul(x, w)).to(x.dtype)

    def partial_product(self, x: torch.Tensor, w: torch.Tensor):
        """This rank's fp32 partial product ``x @ w`` of a row-parallel
        weight, for :meth:`reduce` (:meth:`row_parallel` without its
        sum)."""
        return _fp32_matmul(x, w)

    def expert_partial(self, contrib: torch.Tensor, gate_idx: torch.Tensor):
        """This rank's share of the experts' combine: the products
        ``contrib`` (T, k, D) of its own experts' pairs (``gate_idx``
        (T, k) in :attr:`expert_range`), summed over the k choices in
        fp32."""
        lo, n = self.expert_range
        mine = (gate_idx >= lo) & (gate_idx < lo + n)
        return (contrib.float() * mine[..., None]).sum(dim=1)

    def reduce(self, parts, dtype):
        """fp32 partial sums ``parts`` (one shape) summed over the ranks in
        one all-reduce, each then rounded once to ``dtype``."""
        if not parts:
            return []
        summed = self.mesh.all_reduce(torch.stack(parts))
        return [p.to(dtype) for p in summed.unbind(0)]

    def rms_norm(self, scale: torch.Tensor, x: torch.Tensor, n: int,
                 eps: float = 1e-5):
        """An RMS norm over ``n`` channels of which this rank holds ``x``'s
        last dimension (and ``scale``'s piece): the ranks' fp32 sums of
        squares summed before the ``rsqrt``, as ``layers.rmsnorm`` takes
        the mean over all ``n``."""
        x32 = x.float()
        ss = self.mesh.all_reduce((x32 * x32).sum(dim=-1, keepdim=True))
        out = x32 * torch.rsqrt(ss / n + eps)
        return (out * scale.float()).to(x.dtype)


def _fp32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an fp32 result: on the card a 16-bit product
    accumulates in fp32 and returns it unrounded (the ``out_dtype``
    matmul); on the CPU both sides go to fp32 first."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
            *x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()
