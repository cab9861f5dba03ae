"""The serving mesh, the production mesh and the card's rates (port of the
JAX package's ``launch/mesh.py``).

The reference runs one controller over a ``data x model`` device mesh and
lets GSPMD insert the collectives.  The port runs one process per rank of
the ``model`` (tensor-parallel) axis, joined by ``torch.distributed``:
every rank holds its shard of the weights and of the KV pool, runs the
same engine loop on the same submissions, and meets the others in the
collectives of :class:`ServingMesh` (``all_reduce`` after a row-parallel
product, ``all_gather`` of head or vocab shards).  Host decisions that
read a clock, a disk or a peer are rank 0's, shared with :func:`agree`
(which is the identity without a mesh); :meth:`ServingMesh.any_rank` lets
every rank take the same branch when one rank cannot go on.

The backend follows the device: NCCL when every rank has a card of its
own, gloo on the CPU and when ranks share fewer cards (gloo reduces CUDA
tensors but gathers none, so :meth:`ServingMesh.all_gather` runs a
zero-padded ``all_reduce`` there).  The ``data`` axis is not ported: a
mesh with ``data > 1`` raises (ROADMAP.md, queue 1); the port's replicas
and cluster serve slots in parallel instead.

:class:`RecordingMesh` stands in for one rank of a ``model`` axis on the
``meta`` device: its collectives return shape-correct results, make no
process group and are recorded; :func:`record_collectives` records a live
mesh's alike.  :func:`make_production_mesh` describes the dry run's mesh
(axis names and sizes, nothing more), and the ``H100_*`` constants are the
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
    """One rank's view of a ``1 x model`` mesh: the sizes, this process's
    rank on ``model``, the backend and the device its shards live on.
    With ``model == 1`` there is no process group and every collective is
    the identity."""
    data: int
    model: int
    rank: int
    backend: str
    device: torch.device

    axis_names = AXES

    @property
    def shape(self):
        return (self.data, self.model)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in place; returns ``x``."""
        if self.model > 1:
            dist.all_reduce(x)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, in rank order."""
        if self.model == 1:
            return x
        dim %= x.dim()
        if self.backend == "nccl":
            out = x.new_empty((self.model, *x.shape))
            dist.all_gather_into_tensor(out, x.contiguous())
        else:
            out = x.new_zeros((self.model, *x.shape))
            out[self.rank] = x
            dist.all_reduce(out)
        return out.movedim(0, dim).flatten(dim, dim + 1)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (a host decision that must not
        differ between ranks)."""
        if self.model == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=0, device=self.device if self.backend == "nccl"
            else None)
        return box[0]

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank: a sum over the ranks, so
        that every rank takes the same branch (raising together, say).
        Not a pass's collective: :func:`record_collectives` leaves it
        out."""
        if self.model == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t)
        return bool(t.item())

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if self.model > 1 and dist.is_initialized():
            dist.destroy_process_group()


def agree(mesh: Optional[ServingMesh], value):
    """Rank 0's ``value`` on every rank of ``mesh``, or ``value`` itself
    without one: a host decision that reads a clock, a disk, a peer or
    other rank-local state.  Every rank calls it at the same point, on the
    engine's thread."""
    return value if mesh is None else mesh.broadcast_object(value)


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device, ranks: int) -> str:
    """NCCL when each of ``ranks`` has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def make_serving_mesh(data: int = 1, model: int = 0, *, device=None,
                      rank: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = INIT_TIMEOUT_S) -> ServingMesh:
    """This process's rank of a ``data x model`` serving mesh, its process
    group initialised (``init_method`` defaults to ``env://``, as
    ``rank``, default ``$RANK``, does) with a timeout of ``timeout_s``
    that bounds every collective too.  ``model=0`` means every visible
    card; on the CPU (``device="cpu"``) give the size.  A rank on the card
    takes card ``rank % device_count``."""
    if data != 1:
        raise NotImplementedError(
            "the port's serving mesh has no data axis yet (ROADMAP.md, "
            "queue 1): serve replicas with serving.cluster instead")
    dev = resolve_device(device)
    if model == 0:
        if dev.type != "cuda":
            raise ValueError("model=0 means every visible card; on the CPU "
                             "give the mesh's size")
        model = torch.cuda.device_count()
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not 0 <= rank < model:
        raise ValueError(f"rank {rank} outside a model axis of {model}")
    backend = backend_for(dev, model)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if model > 1:
        if dist.is_initialized():
            if dist.get_world_size() != model:
                raise ValueError(f"the process group has "
                                 f"{dist.get_world_size()} ranks, the mesh "
                                 f"{model}")
        else:
            dist.init_process_group(
                backend, init_method=init_method or "env://",
                world_size=model, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s))
    return ServingMesh(data=data, model=model, rank=rank, backend=backend,
                       device=dev)


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
    result and the size of its group."""
    kind: str
    result_bytes: int
    group: int


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class RecordingMesh(ServingMesh):
    """One rank of a ``1 x model`` mesh on ``device`` (``meta`` by
    default) with no process group: ``all_reduce`` returns its input,
    ``all_gather`` an uninitialised tensor of the gathered shape, and
    every call lands in :attr:`calls`."""

    def __init__(self, model: int, rank: int = 0, device="meta"):
        super().__init__(data=1, model=model, rank=rank, backend="none",
                         device=torch.device(device))
        self.calls: List[Collective] = []

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self.calls.append(Collective("all-reduce", _nbytes(x), self.model))
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        dim %= x.dim()
        shape = list(x.shape)
        shape[dim] *= self.model
        out = x.new_empty(shape)
        self.calls.append(Collective("all-gather", _nbytes(out), self.model))
        return out

    def broadcast_object(self, obj):
        return obj

    def close(self) -> None:
        pass


@contextlib.contextmanager
def record_collectives(mesh: ServingMesh) -> Iterator[List[Collective]]:
    """Every ``all_reduce`` and ``all_gather`` that the live ``mesh`` runs
    inside the block, appended to the yielded list as :class:`Collective`
    records (the collectives themselves run as before)."""
    calls: List[Collective] = []
    reduce, gather = mesh.all_reduce, mesh.all_gather

    def all_reduce(x):
        out = reduce(x)
        calls.append(Collective("all-reduce", _nbytes(out), mesh.model))
        return out

    def all_gather(x, dim):
        out = gather(x, dim)
        calls.append(Collective("all-gather", _nbytes(out), mesh.model))
        return out

    mesh.all_reduce, mesh.all_gather = all_reduce, all_gather
    try:
        yield calls
    finally:
        del mesh.all_reduce, mesh.all_gather
