"""The serving mesh, the production mesh and the card's rates (port of the
JAX package's ``launch/mesh.py``).

The reference runs one controller over a ``data x model`` device mesh and
lets GSPMD insert the collectives.  The port runs one process per rank of
the mesh, joined by ``torch.distributed``: world rank ``d * model + m``
holds model shard ``m`` (its shard of the weights and of the KV pool's
heads) and decodes the slots of data shard ``d``.  Every rank runs the
same engine loop on the same submissions and meets the others in the
collectives of :class:`ServingMesh`: on its ``model`` group
``all_reduce`` after a row-parallel product and ``all_gather`` of head
or vocab shards; on its ``data`` group ``data_all_gather`` of a decode
step's rows (its new K/V and logits, ``serving/sharding.py``) and
``data_all_reduce`` of a long decode's partial softmax.  Host decisions
that read a clock, a disk or a peer are world rank 0's, shared with
:func:`agree` (the identity without a mesh);
:meth:`ServingMesh.any_rank` lets every rank take the same branch when
one rank cannot go on.

The backend follows the device: NCCL when every rank has a card of its
own, gloo on the CPU and when ranks share fewer cards (gloo reduces CUDA
tensors but gathers none, so a gather there runs a zero-padded
``all_reduce`` over its group).

:class:`RecordingMesh` stands in for one rank of a ``data x model`` mesh
on the ``meta`` device: its collectives return shape-correct results,
make no process group and are recorded with their axis;
:func:`record_collectives` records a live mesh's alike.
:func:`make_production_mesh` describes the dry run's mesh (axis names
and sizes, nothing more), and the ``H100_*`` constants are the
card's data-sheet rates that ``roofline`` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import math
import socket
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
INIT_TIMEOUT_S = 120.0      # process group set-up and every collective

# NVIDIA H100 80GB HBM3 (SXM5) data sheet, dense rates at its 700 W power
# limit: the roofline's peaks.  A card set below 700 W runs slower under
# load, so a share against these peaks is stated beside the card's limit.
H100_PEAK_FLOPS_BF16 = 989e12       # tensor cores, bf16 and fp16
H100_PEAK_FLOPS_FP32 = 67e12        # fp32 outside the tensor cores
H100_HBM_BW = 3.35e12               # bytes/s
H100_NVLINK_BW = 450e9              # NVLink 4, bytes/s a direction: model
H100_NDR_BW = 50e9                  # one 400 Gb/s NDR link a card: data, pod

# the production mesh: one 8-card NVLink node per model group, 32 of them
# (256 cards) on the data axis, and two such pods
PRODUCTION_MODEL = 8
PRODUCTION_DATA = 32
PRODUCTION_PODS = 2


@dataclasses.dataclass
class ServingMesh:
    """One rank's view of a ``data x model`` mesh: the sizes, this
    process's world rank (``data_rank * model + model_rank``), the
    backend, the device its shards live on and the process groups of its
    two axes (None: the default group, or no group where the axis is 1).
    A rank holds model shard :attr:`model_rank` and decodes the slots of
    data shard :attr:`data_rank`.  The model passes' collectives run on
    the rank's ``model`` group (:meth:`all_reduce`, :meth:`all_gather`),
    the slots' and a long decode's on its ``data`` group
    (:meth:`data_all_gather`, :meth:`data_all_reduce`), the host
    decisions world-wide (:meth:`broadcast_object`, :meth:`any_rank`).
    On a ``1 x 1`` mesh there is no process group and every collective
    is the identity."""
    data: int
    model: int
    rank: int
    backend: str
    device: torch.device
    model_group: object = None
    data_group: object = None

    axis_names = AXES

    @property
    def shape(self):
        return (self.data, self.model)

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on ``model``: the shard it holds."""
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on ``data``: the slots it decodes."""
        return self.rank // self.model

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the rank's ``model`` group, in place;
        returns ``x``."""
        if self.model > 1:
            dist.all_reduce(x, group=self.model_group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``model`` group's ``x`` concatenated along ``dim``, in rank
        order."""
        return self._gather(x, dim, self.model, self.model_rank,
                            self.model_group)

    def data_all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``data`` group's ``x`` (each data shard's slots)
        concatenated along ``dim``, in data order."""
        return self._gather(x, dim, self.data, self.data_rank,
                            self.data_group)

    def data_all_reduce(self, x: torch.Tensor, op: str = "sum"
                        ) -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over the rank's
        ``data`` group, in place; returns ``x``."""
        if self.data > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=self.data_group)
        return x

    def _gather(self, x, dim, n, idx, group):
        if n == 1:
            return x
        dim %= x.dim()
        if self.backend == "nccl":
            out = x.new_empty((n, *x.shape))
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        else:
            # gloo gathers no CUDA tensor: a zero-padded sum, exact (one
            # nonzero term a position)
            out = x.new_zeros((n, *x.shape))
            out[idx] = x
            dist.all_reduce(out, group=group)
        return out.movedim(0, dim).flatten(dim, dim + 1)

    def broadcast_object(self, obj):
        """World rank 0's ``obj`` on every rank (a host decision that must
        not differ between ranks)."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=0, device=self.device if self.backend == "nccl"
            else None)
        return box[0]

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the world: a sum over the
        ranks, so that every rank takes the same branch (raising together,
        say).  Not a pass's collective: :func:`record_collectives` leaves
        it out."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t)
        return bool(t.item())

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def agree(mesh: Optional[ServingMesh], value):
    """World rank 0's ``value`` on every rank of ``mesh``, or ``value``
    itself without one: a host decision that reads a clock, a disk, a peer
    or other rank-local state.  Every rank calls it at the same point, on
    the engine's thread."""
    return value if mesh is None else mesh.broadcast_object(value)


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device, ranks: int) -> str:
    """NCCL when each of ``ranks`` (the whole ``data x model`` world) has a
    card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def _axis_groups(data: int, model: int, rank: int):
    """This rank's ``model`` and ``data`` process groups.  Every rank
    creates every group, in one order (``new_group`` is collective); an
    axis that spans the world uses the default group (None)."""
    model_group = data_group = None
    if data > 1 and model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
    return model_group, data_group


def make_serving_mesh(data: int = 1, model: int = 0, *, device=None,
                      rank: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = INIT_TIMEOUT_S) -> ServingMesh:
    """This process's rank of a ``data x model`` serving mesh, its process
    group initialised (``init_method`` defaults to ``env://``, as
    ``rank``, default ``$RANK``, does) with a timeout of ``timeout_s``
    that bounds every collective too, and its axes' groups made.  World
    rank ``d * model + m`` holds coordinate ``(d, m)``.  ``model=0`` means
    every visible card over ``data``; on the CPU (``device="cpu"``) give
    the size.  A rank on the card takes card ``rank % device_count``."""
    dev = resolve_device(device)
    if data < 1:
        raise ValueError(f"a data axis of {data}")
    if model == 0:
        if dev.type != "cuda":
            raise ValueError("model=0 means every visible card; on the CPU "
                             "give the mesh's size")
        model = max(torch.cuda.device_count() // data, 1)
    world = data * model
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a {data} x {model} mesh")
    backend = backend_for(dev, world)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    groups = (None, None)
    if world > 1:
        if dist.is_initialized():
            if dist.get_world_size() != world:
                raise ValueError(f"the process group has "
                                 f"{dist.get_world_size()} ranks, the mesh "
                                 f"{world}")
        else:
            dist.init_process_group(
                backend, init_method=init_method or "env://",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s))
        groups = _axis_groups(data, model, rank)
    return ServingMesh(data=data, model=model, rank=rank, backend=backend,
                       device=dev, model_group=groups[0],
                       data_group=groups[1])


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def activation_rules(*, multi_pod: bool = False) -> dict:
    """Logical name -> mesh axis, the reference's rules with no sequence
    axis: the batch on :func:`batch_axes`, heads, kv heads, the MLP,
    experts and the vocabulary on ``model``.  ``launch.specs`` reads the
    batch's axes (the dry run) and the kv heads' axis (the serving cut)
    from it."""
    return {
        "batch": batch_axes(multi_pod),
        "seq": None,
        "kv_seq": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
    }


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """An abstract mesh: its axis names and sizes.  No process group and
    no device stands behind it; the dry run and the partition specs read
    it as they read a live mesh (``axis_names`` and ``shape``)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """``data 32 x model 8`` (256 cards: an 8-card NVLink node per model
    group), or ``pod 2 x data 32 x model 8`` (512) with ``multi_pod``,
    where the reference's TPU mesh is 16 x 16 (x 2)."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (
            PRODUCTION_PODS, PRODUCTION_DATA, PRODUCTION_MODEL))
    return ProductionMesh(AXES, (PRODUCTION_DATA, PRODUCTION_MODEL))


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank ran: its kind (``"all-reduce"`` or
    ``"all-gather"``, as the reference's HLO names them), the bytes of its
    result, the size of its group and the axis the group spans
    (``"model"`` or ``"data"``)."""
    kind: str
    result_bytes: int
    group: int
    axis: str = "model"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class RecordingMesh(ServingMesh):
    """One rank (world rank ``rank``) of a ``data x model`` mesh on
    ``device`` (``meta`` by default) with no process group: the
    reductions return their input, the gathers an uninitialised tensor of
    the gathered shape, and every call lands in :attr:`calls`."""

    def __init__(self, model: int, rank: int = 0, device="meta",
                 data: int = 1):
        super().__init__(data=data, model=model, rank=rank, backend="none",
                         device=torch.device(device))
        self.calls: List[Collective] = []

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self.calls.append(Collective("all-reduce", _nbytes(x), self.model))
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._record_gather(x, dim, self.model, "model")

    def data_all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.data == 1:
            return x
        return self._record_gather(x, dim, self.data, "data")

    def data_all_reduce(self, x: torch.Tensor, op: str = "sum"
                        ) -> torch.Tensor:
        if self.data > 1:
            self.calls.append(Collective("all-reduce", _nbytes(x), self.data,
                                         "data"))
        return x

    def _record_gather(self, x, dim, n, axis):
        dim %= x.dim()
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape)
        self.calls.append(Collective("all-gather", _nbytes(out), n, axis))
        return out

    def broadcast_object(self, obj):
        return obj

    def close(self) -> None:
        pass


@contextlib.contextmanager
def record_collectives(mesh: ServingMesh) -> Iterator[List[Collective]]:
    """Every ``all_reduce`` and ``all_gather`` (and, on a ``data`` axis,
    ``data_all_gather`` and ``data_all_reduce``) that the live ``mesh``
    runs inside the block, appended to the yielded list as
    :class:`Collective` records (the collectives themselves run as
    before)."""
    calls: List[Collective] = []
    reduce, gather = mesh.all_reduce, mesh.all_gather
    d_gather, d_reduce = mesh.data_all_gather, mesh.data_all_reduce

    def all_reduce(x):
        out = reduce(x)
        calls.append(Collective("all-reduce", _nbytes(out), mesh.model))
        return out

    def all_gather(x, dim):
        out = gather(x, dim)
        calls.append(Collective("all-gather", _nbytes(out), mesh.model))
        return out

    def data_all_gather(x, dim):
        out = d_gather(x, dim)
        if mesh.data > 1:
            calls.append(Collective("all-gather", _nbytes(out), mesh.data,
                                    "data"))
        return out

    def data_all_reduce(x, op="sum"):
        out = d_reduce(x, op)
        if mesh.data > 1:
            calls.append(Collective("all-reduce", _nbytes(out), mesh.data,
                                    "data"))
        return out

    mesh.all_reduce, mesh.all_gather = all_reduce, all_gather
    mesh.data_all_gather, mesh.data_all_reduce = (data_all_gather,
                                                  data_all_reduce)
    try:
        yield calls
    finally:
        del mesh.all_reduce, mesh.all_gather
        del mesh.data_all_gather, mesh.data_all_reduce
