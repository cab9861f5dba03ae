"""Roofline terms and the least work of a step (port of the JAX package's
``roofline/analysis.py``).

Three terms per step, in seconds, on the card's data-sheet rates
(``launch/mesh.py``'s ``H100_*``):

  compute    = FLOPs per device / peak FLOP/s
  memory     = bytes per device / HBM bytes/s
  collective = collective wire bytes per device / NVLink bytes/s

The reference reads the FLOPs and bytes from XLA's ``cost_analysis()`` and
the collectives from the optimized HLO text.  The port has no HLO: the
FLOPs and bytes are :func:`step_cost`'s analytic count of the step's least
work, and :func:`collective_bytes` takes the calls that a recording mesh
(``launch.mesh.RecordingMesh`` / ``record_collectives``) saw.  The port's
layers run in a Python loop, so every call is recorded where it runs and
no loop multiplier applies.

Wire-bytes model per device (ring algorithms, group size g), the
reference's:
  all-gather       result_bytes x (g-1)/g      (received)
  reduce-scatter   result_bytes x (g-1)        (~ input x (g-1)/g)
  all-reduce       2 x result_bytes x (g-1)/g
  all-to-all       result_bytes x (g-1)/g
  collective-permute  result_bytes

The least work (:func:`step_cost`), the work a bound is taken over:
every product on the tokens the step computes; attention over the keys
each query can see (causal, window, valid length), never the padded or
masked slots the plain versions sweep; each weight read once a step (one
rank's cut, when given a rank's local config), however many passes or
chunks the step runs; the KV read once and written once a sequence (int8
and its scale rows on an int8 pool); a MoE's routed experts where the
routing is known.  Elementwise work (norms, softmax, activations) is left
out: the count is a floor.  The kernels' own bounds (``*_kernel_cost``)
count each operand read once and each output written once, as
``chip_smoke.py``'s phase 6 prints them.  Every least time is the largest
of :func:`terms`, the products at :func:`peak_flops` of their dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.launch.mesh import (
    H100_HBM_BW,
    H100_NVLINK_BW,
    H100_PEAK_FLOPS_BF16,
    H100_PEAK_FLOPS_FP32,
    Collective,
)

PEAK_FLOPS_BF16 = H100_PEAK_FLOPS_BF16
HBM_BW = H100_HBM_BW
ICI_BW = H100_NVLINK_BW         # the model axis: NVLink inside a node

# what bounds a least time, by its largest term
BOUND_BY = {"compute": "operations", "memory": "bytes",
            "collective": "collective bytes"}


def peak_flops(dtype) -> float:
    """The card's peak FLOP/s for products in ``dtype`` (a name or a
    ``torch.dtype``): the tensor cores' for 16-bit floats, fp32's for
    anything else."""
    name = str(dtype).replace("torch.", "")
    return (H100_PEAK_FLOPS_BF16 if name in ("bfloat16", "float16")
            else H100_PEAK_FLOPS_FP32)


def terms(flops: float, nbytes: float, coll_bytes: float = 0.0,
          dtype="bfloat16") -> Dict[str, float]:
    """The seconds of each roofline term: ``flops`` at ``dtype``'s peak,
    ``nbytes`` over HBM, ``coll_bytes`` over NVLink.  Every least time in
    this module is the largest of these."""
    return {"compute": flops / peak_flops(dtype), "memory": nbytes / HBM_BW,
            "collective": coll_bytes / ICI_BW}


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)          # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float
    by_kind: Dict[str, float]
    op_count: int


def collective_bytes(calls: Iterable[Collective]) -> CollectiveStats:
    """Wire bytes per device of the collectives a rank ran: each call's
    kind, result bytes and group size through :func:`_wire_bytes`."""
    total, by_kind, count = 0.0, {}, 0
    for c in calls:
        wb = _wire_bytes(c.kind, c.result_bytes, c.group)
        total += wb
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + wb
        count += 1
    return CollectiveStats(total, by_kind, count)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_global: float          # 6·N·D (dense) / 6·N_active·D (MoE)
    chips: int
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory_per_device: Optional[dict] = None
    dtype: str = "bfloat16"            # the products' (the port's field)

    @property
    def terms(self) -> Dict[str, float]:
        return terms(self.flops_per_device, self.bytes_per_device,
                     self.coll_bytes_per_device, self.dtype)

    @property
    def t_compute(self) -> float:
        return self.terms["compute"]

    @property
    def t_memory(self) -> float:
        return self.terms["memory"]

    @property
    def t_collective(self) -> float:
        return self.terms["collective"]

    @property
    def bottleneck(self) -> str:
        t = self.terms
        return max(t, key=t.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs per device x chips): waste probe."""
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "step": self.step, "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_by_kind": self.coll_by_kind,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "memory_per_device": self.memory_per_device,
        }


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic 6ND model FLOPs for the step (the reference's)."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if kind in ("train", "prefill")
                                   else 1)
    if kind == "mpic_prefill":
        tokens = shape.global_batch * shape.seq_len // 8
    f = 2.0 * n * tokens                 # fwd matmuls
    if kind == "train":
        f *= 3.0                         # fwd + bwd ≈ 6ND
    return f


def least_time(rl: Roofline) -> float:
    """The least seconds of ``rl``'s step: its largest term."""
    return max(rl.terms.values())


def roofline_share(measured_s: float, rl: Roofline) -> float:
    """The share of the card's rates a step reached: its least time over
    the time it took (1.0 at the roofline; above it, the count overstates
    the work)."""
    return least_time(rl) / measured_s


def mfu(measured_s: float, model_flops: float, chips: int) -> float:
    """Model FLOPs utilization: ``model_flops`` (6ND / 2ND) over what
    ``chips`` cards could do at the bf16 peak in ``measured_s``."""
    return model_flops / (measured_s * chips * PEAK_FLOPS_BF16)


# ---------------------------------------------------------------------------
# the least work of a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Row:
    """One sequence of a pass: the positions of the queries it computes
    (padding left out) and its valid keys after the pass's writes, as an
    array of positions or as a count ``n`` (positions ``0 .. n-1``: a
    paged row, whose slot ``i`` holds position ``i``); whether the pass
    computes these queries' ``logits``; and ``seq``, which names the
    sequence whose KV the row reads and writes.  Rows of one ``seq`` (a
    request's chunks or passes, given together) share their KV: a key is
    read once if no row of the sequence writes it, and written once.  A
    row without ``seq`` is a sequence of its own."""
    q_pos: Sequence[int]
    keys: Union[int, Sequence[int]]
    logits: bool = True
    seq: Optional[object] = None


@dataclasses.dataclass
class StepCost:
    """The least work of one or more passes: FLOPs and bytes by what they
    are, and the dtype whose peak the products run at."""
    weight_flops: float = 0.0   # products with the weights (the head too)
    attn_flops: float = 0.0     # QK^T and PV over the kept pairs
    other_flops: float = 0.0    # the SSD's chunk algebra and the conv
    weight_bytes: float = 0.0
    kv_bytes: float = 0.0       # K/V (int8: and scale rows) read + written
    state_bytes: float = 0.0    # SSM state; training's moments and writes
    io_bytes: float = 0.0       # tokens, embedding rows, logits out
    dtype: str = "bfloat16"

    @property
    def flops(self) -> float:
        return self.weight_flops + self.attn_flops + self.other_flops

    @property
    def bytes(self) -> float:
        return (self.weight_bytes + self.kv_bytes + self.state_bytes
                + self.io_bytes)

    @property
    def terms(self) -> Dict[str, float]:
        return terms(self.flops, self.bytes, 0.0, self.dtype)

    @property
    def t_compute(self) -> float:
        return self.terms["compute"]

    @property
    def t_memory(self) -> float:
        return self.terms["memory"]

    @property
    def least_s(self) -> float:
        return max(self.terms.values())

    @property
    def bound_by(self) -> str:
        t = self.terms
        return BOUND_BY[max(t, key=t.get)]

    def __add__(self, other: "StepCost") -> "StepCost":
        if other.dtype != self.dtype:
            raise ValueError(f"{self.dtype} and {other.dtype} costs")
        return StepCost(*(getattr(self, f.name) + getattr(other, f.name)
                          for f in dataclasses.fields(self)[:-1]),
                        dtype=self.dtype)

    def scaled(self, s: float) -> "StepCost":
        return StepCost(*(getattr(self, f.name) * s
                          for f in dataclasses.fields(self)[:-1]),
                        dtype=self.dtype)

    def roofline(self, arch: str, shape: str, mesh: str, step: str, *,
                 chips: int = 1, model_flops_global: float = 0.0,
                 coll: Optional[CollectiveStats] = None) -> Roofline:
        """A :class:`Roofline` of these FLOPs and bytes per device, at
        this cost's dtype, and the collectives ``coll``."""
        coll = coll or CollectiveStats(0.0, {}, 0)
        return Roofline(arch=arch, shape=shape, mesh=mesh, step=step,
                        flops_per_device=self.flops,
                        bytes_per_device=self.bytes,
                        coll_bytes_per_device=coll.total_bytes,
                        model_flops_global=model_flops_global, chips=chips,
                        coll_by_kind=coll.by_kind, dtype=self.dtype)


_ITEM = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def _meta_weights(cfg, widths=None) -> Dict[str, Tuple[int, ...]]:
    from repro_torch.models.transformer import Transformer
    return {n: tuple(p.shape) for n, p in Transformer(
        cfg, device="meta", widths=widths).named_parameters()}


def _param_item(name: str, cfg) -> int:
    """Bytes of one element of the port's parameter ``name``: the router
    and the SSM's ``dt_bias``/``A_log``/``D`` are fp32 always."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("router", "dt_bias", "A_log", "D"):
        return 4
    return _ITEM[cfg.param_dtype]


def _expert(parts) -> bool:
    """Whether a parameter name's parts name a routed expert's weight."""
    return ("moe" in parts and "shared" not in parts
            and parts[-1] in ("w_gate", "w_up", "w_down"))


def _visible(q_pos, keys, window: int):
    """(kept (query, key) pairs, the positions of the keys some query
    keeps, sorted) of one row; ``keys`` a count ``n`` means positions
    ``0 .. n-1``."""
    q = np.asarray(q_pos, np.int64)
    kp = (np.arange(int(keys)) if np.ndim(keys) == 0
          else np.sort(np.asarray(keys, np.int64)))
    hi = np.searchsorted(kp, q, side="right")
    lo = (np.searchsorted(kp, q - window, side="right") if window > 0
          else np.zeros_like(hi))
    pairs = int(np.maximum(hi - lo, 0).sum())
    kept = np.zeros(len(kp) + 1, np.int64)
    np.add.at(kept, lo, 1)
    np.add.at(kept, hi, -1)
    return pairs, kp[np.cumsum(kept)[:-1] > 0]


def _ssd_chunk_flops(cfg, n: int, heads: int = 0) -> float:
    """The SSD's least work over ``n`` tokens from an empty state at
    ``heads`` heads (the model's by default): per chunk C·Bᵀ over the kept
    pairs once (the heads share it), per head the scores times x, their
    decay and dt factors, the chunk's state, the previous state's output
    term and the state's recurrence."""
    q, ds, hd = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_head_dim
    h = heads or cfg.ssm_num_heads
    nc = -(-n // q)
    pairs = q * (q + 1) // 2
    return nc * (2 * ds * pairs + h * (2 * hd * pairs + 4 * pairs
                                       + 2 * ds * q * hd + 2 * q * ds * hd
                                       + 2 * ds * hd))


def _sequences(rows: Sequence[Row], window: int):
    """(kept pairs of every row, and per sequence the positions some query
    keeps and the positions written, each sorted and distinct, and
    whether its keys are slots of a paged row)."""
    pairs, seqs = 0, {}
    for i, r in enumerate(rows):
        p, seen = _visible(r.q_pos, r.keys, window)
        pairs += p
        s = seqs.setdefault(i if r.seq is None else ("seq", r.seq),
                            ([], [], np.ndim(r.keys) == 0))
        s[0].append(seen)
        s[1].append(np.asarray(r.q_pos, np.int64))
    return pairs, [(np.unique(np.concatenate(seen)),
                    np.unique(np.concatenate(wrote)), paged)
                   for seen, wrote, paged in seqs.values()]


def step_cost(cfg, rows: Sequence[Row], *, kind: str = "serve",
              kv_dtype: Optional[str] = None, page_size: int = 16,
              window: Optional[int] = None,
              experts: Optional[Sequence[int]] = None,
              cross_frames: int = 0, widths=None) -> StepCost:
    """The least work of the decoder over ``rows`` (:class:`Row`): one
    pass, or the passes of one step given together (a request's prefill
    in chunks or in several passes, its rows sharing a ``seq``: the
    weights, the KV and an SSM's state then count once, as in one pass).

    ``cfg`` is the config whose shapes the weights have: a rank's
    ``local_config`` for one rank's cut, with its ``widths``
    (``launch.specs.Widths``: its routed experts, shared experts' hidden
    units and SSD heads; the leaves it holds whole count whole, as on
    every rank).  A rank's routed experts do their share of the pairs,
    ``k x widths.experts / E`` a token.  ``kind``: ``"serve"`` (a
    prefill, a selective prefill or a decode step: a sequence whose first
    query sits past position 0 continues an SSM state) or ``"train"``
    (forward and backward: three times the products, the parameters read
    and written once, the fp32 AdamW moments read and written once, no
    KV).  ``kv_dtype`` the cache's (``"int8"`` adds one fp32 scale per
    page of ``page_size`` slots and kv head for K and V, read and
    written); ``window`` defaults to ``cfg.sliding_window``; ``experts`` a
    MoE's distinct routed experts per layer where the routing is known,
    else ``min(E, k x tokens)``, the most the pairs can reach (a rank's:
    its own, at most ``widths.experts``);
    ``cross_frames`` the encoder frames an encoder-decoder's cross
    attention reads per sequence."""
    w = cfg.sliding_window if window is None else window
    train = kind == "train"
    kvd = _ITEM[kv_dtype or cfg.compute_dtype]
    cd = _ITEM[cfg.compute_dtype]
    shapes = _meta_weights(cfg, widths)
    L, d = cfg.num_layers, cfg.d_model
    tokens = sum(len(r.q_pos) for r in rows)
    with_logits = sum(len(r.q_pos) for r in rows if r.logits)
    head = with_logits > 0
    pairs, seqs = _sequences(rows, w)
    c = StepCost(dtype=cfg.compute_dtype)

    # the products with the weights, per token computed
    moe_expert, per_token = 0, 0
    for name, shp in shapes.items():
        leaf, parts = name.rsplit(".", 1)[-1], name.split(".")
        if not name.startswith("layers.") or len(shp) < 2:
            continue
        if "cross_attn" in parts and leaf in ("wk", "wv"):
            continue                    # the encoder's frames: cross K/V
        if leaf == "conv_w":
            continue
        if _expert(parts):
            moe_expert += math.prod(shp[1:])
            continue
        per_token += math.prod(shp)
    k = cfg.experts_per_token
    held = cfg.num_experts if widths is None else widths.experts
    share = held / cfg.num_experts if cfg.num_experts else 1.0
    c.weight_flops = 2.0 * tokens * (per_token + k * share * moe_expert)
    head_numel = d * (cfg.vocab_size if "lm_head" not in shapes
                      else shapes["lm_head"][1])
    c.weight_flops += 2.0 * with_logits * head_numel

    # attention over the kept pairs, and the KV read once and written once
    # a sequence: its keys that no row of it writes are read
    if not cfg.attn_free:
        hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        read = written = pages = 0
        for seen, wrote, paged in seqs:
            read += np.setdiff1d(seen, wrote, assume_unique=True).size
            written += wrote.size
            if kv_dtype == "int8":
                if not paged:
                    raise ValueError("an int8 cache is paged: give its "
                                     "rows' keys as a count")
                pages += np.unique(np.concatenate([seen, wrote])
                                   // page_size).size
        c.attn_flops = 4.0 * dh * hq * pairs * L
        if not train:
            c.kv_bytes = 2.0 * (read + written) * hkv * dh * kvd * L
            c.kv_bytes += 2.0 * 2 * pages * hkv * 4 * L
        if cross_frames:
            c.attn_flops += 4.0 * dh * hq * tokens * cross_frames * L
            if not train:
                c.kv_bytes += (2.0 * len(seqs) * cross_frames * hkv * dh
                               * cd * L)
    if cfg.attn_free or cfg.hybrid:
        ds, hd = cfg.ssm_state, cfg.ssm_head_dim
        nh = cfg.ssm_num_heads if widths is None else widths.ssm_heads
        di = nh * hd
        state = nh * ds * hd * 4 + (cfg.ssm_conv_width - 1) * di * cd
        for r in rows:
            n = len(r.q_pos)
            step = n == 1 and int(np.asarray(r.q_pos)[0]) > 0 and not train
            c.other_flops += L * (2.0 * cfg.ssm_conv_width * di * n + (
                4.0 * nh * ds * hd if step
                else _ssd_chunk_flops(cfg, n, nh)))
        if not train:
            # written once a sequence, and read where it continues one
            c.state_bytes = L * state * sum(
                1 + int(wrote.size > 0 and wrote[0] > 0)
                for _, wrote, _ in seqs)

    # each weight read once a step: the embedding's rows alone, the head
    # whole; a MoE's experts as routed
    wbytes = 0.0
    for name, shp in shapes.items():
        parts = name.split(".")
        if parts[0] in ("embed", "pos_embed", "enc_pos_embed", "enc_layers",
                        "enc_norm"):
            continue
        if "cross_attn" in parts and parts[-1] in ("wk", "wv"):
            continue
        if parts[0] == "lm_head" and not head:
            continue
        if _expert(parts):
            continue
        wbytes += math.prod(shp) * _param_item(name, cfg)
    if cfg.tie_embeddings and head:
        wbytes += head_numel * _ITEM[cfg.param_dtype]
    if cfg.arch_type == "moe":
        if experts is None:
            experts = [min(held, k * tokens)] * L
        if len(experts) != L:
            raise ValueError(f"experts: {len(experts)} entries for {L} "
                             "layers")
        # moe_expert sums one expert's weights over the layers
        wbytes += sum(experts) * moe_expert // L * _ITEM[cfg.param_dtype]
    c.weight_bytes = wbytes
    # each sequence's tokens in once (and their positions' rows)
    c.io_bytes = sum(wrote.size for _, wrote, _ in seqs) * (
        4 + d * _ITEM[cfg.param_dtype] * (2 if cfg.learned_pos_emb else 1))
    if not train:
        c.io_bytes += with_logits * cfg.vocab_size * 4       # fp32 logits
    if train:
        c.weight_flops *= 3.0
        c.attn_flops *= 3.0
        c.other_flops *= 3.0
        n_all = sum(math.prod(s) for s in shapes.values())
        item = sum(math.prod(s) * _param_item(n, cfg)
                   for n, s in shapes.items())
        # every parameter read once and written once, and the fp32
        # moments read and written once
        c.weight_bytes = item
        c.state_bytes += item + 16.0 * n_all
        c.io_bytes += tokens * 4                              # labels
    return c


def train_cost(cfg, batch: int, seq: int) -> StepCost:
    """The least work of one training step on ``batch`` sequences of
    ``seq`` tokens: :func:`step_cost`'s ``"train"`` kind, and for an
    encoder-decoder its encoder and cross K/V over ``cfg.encoder_seq``
    frames a sequence, forward and backward (three times their products;
    their weights are among the parameters read once)."""
    frames = cfg.encoder_seq if cfg.is_encoder_decoder else 0
    c = step_cost(cfg, [Row(np.arange(seq), seq)] * batch, kind="train",
                  cross_frames=frames)
    if frames:
        for e in (encode_cost(cfg, batch, frames),
                  cross_kv_cost(cfg, batch, frames)):
            c.weight_flops += 3.0 * e.weight_flops
            c.attn_flops += 3.0 * e.attn_flops
    return c


def encode_cost(cfg, batch: int, frames: int) -> StepCost:
    """The least work of an encoder-decoder's encoder over ``batch``
    inputs of ``frames`` frame embeddings: every layer's products on every
    frame, bidirectional attention (every frame sees every frame), the
    encoder's weights once, the frames in and the encoding out."""
    shapes = _meta_weights(cfg)
    c = StepCost(dtype=cfg.compute_dtype)
    t = batch * frames
    for name, shp in shapes.items():
        if name.startswith("enc_layers.") and len(shp) >= 2:
            c.weight_flops += 2.0 * t * math.prod(shp)
        if name.startswith(("enc_layers.", "enc_norm")):
            c.weight_bytes += math.prod(shp) * _param_item(name, cfg)
    c.attn_flops = (4.0 * cfg.head_dim * cfg.num_heads * batch * frames
                    * frames * cfg.encoder_layers)
    c.io_bytes = 2.0 * t * cfg.d_model * _ITEM[cfg.compute_dtype] + (
        frames * cfg.d_model * _ITEM[cfg.param_dtype])     # + positions
    return c


def cross_kv_cost(cfg, batch: int, frames: int) -> StepCost:
    """The least work of every decoder layer's cross-attention K/V over
    an encoding: two products a layer on every frame, those weights once,
    the encoding in and the K/V out."""
    cd, pd = _ITEM[cfg.compute_dtype], _ITEM[cfg.param_dtype]
    n = cfg.num_layers * 2 * cfg.d_model * cfg.kv_dim
    t = batch * frames
    return StepCost(weight_flops=2.0 * t * n, weight_bytes=n * pd,
                    io_bytes=t * cfg.d_model * cd
                    + 2.0 * cfg.num_layers * t * cfg.kv_dim * cd,
                    dtype=cfg.compute_dtype)


# ---------------------------------------------------------------------------
# the kernels' own bounds (chip_smoke.py's phase 6)
# ---------------------------------------------------------------------------

def kernel_bound(nbytes: float, flops: float, dtype) -> Tuple[float, str]:
    """(least ms, what bounds it) of a kernel call that moves ``nbytes``
    and does ``flops`` at ``dtype``'s peak (:func:`peak_flops`)."""
    t = terms(flops, nbytes, 0.0, dtype)
    key = max(t, key=t.get)
    return t[key] * 1e3, BOUND_BY[key]


def valid_keys_decode(lens, ps: int, mp: int, window: int) -> np.ndarray:
    """Keys each paged decode row keeps: its length within the page
    table's reach, and the window's last keys."""
    hi = np.minimum(lens, mp * ps)
    lo = np.maximum(0, lens - window) if window > 0 else 0
    return np.maximum(hi - lo, 0)


def valid_keys_prefill(q_pos, length: int, window: int) -> np.ndarray:
    """Keys each query of a paged selective prefill keeps."""
    n = np.minimum(q_pos + 1, length)
    if window > 0:
        n = n - np.maximum(0, q_pos - window + 1)
    return np.maximum(n, 0)


def paged_decode_kernel_cost(n_keys, *, batch: int, hq: int, hkv: int,
                             dh: int, q_item: int, kv_item: int,
                             table_numel: int, page_size: int,
                             quantized: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one paged decode call (kernels 3/4): q in and
    out, the kept keys' K and V, the page table and lengths, and on int8
    the scale rows of the pages the kept keys span."""
    n_keys = np.asarray(n_keys)
    nbytes = (2 * batch * hq * dh * q_item
              + 2 * int(n_keys.sum()) * hkv * dh * kv_item
              + table_numel * 4 + batch * 4
              + (2 * int(np.ceil(n_keys / page_size).sum()) * hkv * 4
                 if quantized else 0))
    return nbytes, 4 * dh * hq * int(n_keys.sum())


def paged_prefill_kernel_cost(q_pos, length: int, window: int, *,
                              q_numel: int, hq: int, hkv: int, dh: int,
                              q_item: int, kv_item: int, table_numel: int,
                              page_size: int,
                              quantized: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one paged selective prefill call (kernels 1/2)
    of one row: q in and out, its positions, the keys up to its last
    query, the page table and length, int8's scale rows."""
    q_pos = np.asarray(q_pos)
    n_keys = valid_keys_prefill(q_pos, length, window)
    read_keys = min(length, int(q_pos.max()) + 1)
    nbytes = (2 * q_numel * q_item + q_pos.size * 4
              + 2 * read_keys * hkv * dh * kv_item + table_numel * 4 + 4
              + (2 * -(-read_keys // page_size) * hkv * 4
                 if quantized else 0))
    return nbytes, 4 * dh * hq * int(n_keys.sum())


def dense_attention_kernel_cost(pairs: int, keys: int, *, q_numel: int,
                                pos_numel: int, hq: int, hkv: int, dh: int,
                                item: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one dense selective attention call (kernel 5):
    q in and out, the positions, the K and V of the keys some query
    keeps; four FLOPs a head dim a kept (query, key) pair."""
    nbytes = 2 * q_numel * item + 4 * pos_numel + 2 * keys * hkv * dh * item
    return nbytes, 4 * dh * hq * pairs


def ssd_chunk_kernel_cost(*, b: int, nc: int, h: int, q: int, hd: int,
                          ds: int, in_numel: int,
                          out_numel: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one SSD chunk call (kernel 6), fp32: each
    operand read once, each output written once; C·Bᵀ once per chunk over
    the kept pairs k <= q, per head the scores times x over those pairs,
    their decay and dt factors, the chunk's state."""
    pairs = q * (q + 1) // 2
    flops = b * nc * (2 * ds * pairs
                      + h * (2 * hd * pairs + 4 * pairs + 2 * ds * q * hd))
    return 4 * (in_numel + out_numel), flops


__all__ = [
    "BOUND_BY", "CollectiveStats", "Roofline", "Row", "StepCost",
    "collective_bytes", "cross_kv_cost", "dense_attention_kernel_cost",
    "encode_cost", "kernel_bound", "least_time", "mfu", "model_flops",
    "peak_flops", "terms",
    "paged_decode_kernel_cost", "paged_prefill_kernel_cost",
    "roofline_share", "ssd_chunk_kernel_cost", "step_cost", "train_cost",
    "valid_keys_decode", "valid_keys_prefill",
]
