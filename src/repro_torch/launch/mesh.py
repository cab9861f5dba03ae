"""The serving mesh (port of the JAX package's ``launch/mesh.py``).

The reference runs one controller over a ``data x model`` device mesh and
lets GSPMD insert the collectives.  The port runs one process per rank of
the ``model`` (tensor-parallel) axis, joined by ``torch.distributed``:
every rank holds its shard of the weights and of the KV pool, runs the
same engine loop on the same submissions, and meets the others in the
collectives of :class:`ServingMesh` (``all_reduce`` after a row-parallel
product, ``all_gather`` of head or vocab shards).

The backend follows the device: NCCL when every rank has a card of its
own, gloo on the CPU and when ranks share fewer cards (gloo reduces CUDA
tensors but gathers none, so :meth:`ServingMesh.all_gather` runs a
zero-padded ``all_reduce`` there).  The ``data`` axis is not ported: a
mesh with ``data > 1`` raises (ROADMAP.md, queue 1); the port's replicas
and cluster serve slots in parallel instead.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
INIT_TIMEOUT_S = 120.0      # process group set-up and every collective


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

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if self.model > 1 and dist.is_initialized():
            dist.destroy_process_group()


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


def serving_rules() -> dict:
    """Logical name -> mesh axis for the serving path: heads, kv heads,
    the MLP, experts and the vocabulary on ``model``, the batch of slots
    on ``data``, no sequence axis (the reference's ``activation_rules``
    with their defaults).  ``launch.specs.param_pspecs`` reads the kv
    heads' axis from it."""
    return {"batch": ("data",), "seq": None, "kv_seq": None,
            "heads": "model", "kv_heads": "model", "mlp": "model",
            "experts": "model", "vocab": "model"}
