"""Dispatch for the SSD intra-chunk step: the CUDA kernels on the card, the
plain version on the CPU.

``ssd_chunk(x, bm, cm, la, dt)`` takes the contract's layout, as the JAX
package's ``ssd_chunk`` does: x (B, NC, H, Q, hd), bm/cm (B, NC, Q, ds),
la/dt (B, NC, H, Q), all fp32.  It returns y_intra (B, NC, H, Q, hd), s_c
(B, NC, H, ds, hd) and a_c (B, NC, H), contiguous fp32.  The operands may
be strided views: the model holds x as (B, NC, Q, H, hd) and la/dt as
(B, NC, Q, H) and passes them permuted, and the kernels read them in place
through their strides; only the last dim of x, bm and cm must have unit
stride.

A CPU tensor goes to :func:`ssd_chunk_ref`, as does a ``meta`` one
(the dry run's shapes; it launches nothing).  A CUDA tensor launches
``csrc/ssd_chunk.cu`` or raises: there is no fallback on the card.
:func:`ssd_route` picks one of two routes from the host's shapes alone:

- ``"tensor_cores"``: Q 32, 64 or 128 with hd 64 and ds 128, the shapes of
  every mamba2 size.  All three products on ``mma.sync`` in three TF32
  passes; a block computes C·Bᵀ once for :func:`plan_head_groups`'s G
  heads of one chunk.  x, bm and cm are copied 16 bytes at a time, so they
  must be 16-byte aligned with strides of whole 16-byte vectors (the
  wrapper raises otherwise).
- ``"cuda_cores"``: any other Q <= 128, ds <= 128, hd <= 128 (the JAX
  package's small test shapes): the first port, fp32 on the CUDA cores, one
  block per (chunk, head).

Every call counts as one launch of ``SSD_CHUNK`` and, in
``SSD_CHUNK.route_launches``, one of its route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import Kernel, library, ptr
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

_P, _S = ctypes.c_void_p, ctypes.c_int64
SSD_CHUNK = Kernel("ssd_chunk", "ssd_chunk",
                   [_P] + [_S] * 4 + ([_P] + [_S] * 3) * 2
                   + ([_P] + [_S] * 4) * 2 + [_P] * 3 + [ctypes.c_int] * 7)
KERNELS = (SSD_CHUNK,)
MAX_Q = MAX_DS = MAX_HD = 128
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
_ENTRY = {TENSOR_CORES: "mma_f32", CUDA_CORES: "f32"}
MMA_Q = (32, 64, 128)
MMA_HD, MMA_DS = 64, 128


def ssd_route(q: int, hd: int, ds: int) -> str:
    """The route of a call, from shapes the host knows: Q 32, 64 or 128 at
    hd 64 and ds 128 go to the tensor cores, anything else to the CUDA
    cores."""
    if q in MMA_Q and hd == MMA_HD and ds == MMA_DS:
        return TENSOR_CORES
    return CUDA_CORES


def plan_head_groups(b: int, nc: int, h: int, sms: int) -> int:
    """G, the heads of one chunk a tensor-core block computes (C·Bᵀ once
    for all of them): the fewest that fit the ``b * nc * ceil(h / G)``
    blocks into one wave of ``sms`` blocks (one block an SM), else all
    ``h`` heads, which share C·Bᵀ most where there are waves anyway."""
    for g in range(1, h + 1):
        if b * nc * -(-h // g) <= sms:
            return g
    return h


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunk: {what}")


def ssd_chunk(x, bm, cm, la, dt):
    # meta runs no kernel: the plain version computes its shapes
    if x.device.type in ("cpu", "meta"):
        return ssd_chunk_ref(x, bm, cm, la, dt)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    b, nc, h, q, hd = x.shape
    ds = bm.shape[-1]
    tensors = (x, bm, cm, la, dt)
    _check(all(t.device == x.device for t in tensors),
           "all tensors must be on one device")
    _check(all(t.dtype == torch.float32 for t in tensors),
           "all tensors must be float32")
    _check(bm.shape == (b, nc, q, ds) and cm.shape == bm.shape,
           "bm/cm must be (B, NC, Q, ds) matching x")
    _check(la.shape == (b, nc, h, q) and dt.shape == la.shape,
           "la/dt must be (B, NC, H, Q) matching x")
    _check(1 <= q <= MAX_Q, f"chunk length {q} not in 1..{MAX_Q}")
    _check(ds <= MAX_DS and hd <= MAX_HD,
           f"state {ds} or head dim {hd} > {MAX_DS}")
    _check(all(t.stride(-1) == 1 for t in (x, bm, cm)),
           "x, bm and cm need a unit-stride last dim")
    return launch_route(ssd_route(q, hd, ds), x, bm, cm, la, dt)


def launch_route(route: str, x, bm, cm, la, dt):
    """Launch ``route``'s kernel on checked CUDA operands (``ssd_chunk``
    picks the route; a caller may name the CUDA cores for any shape)."""
    b, nc, h, q, hd = x.shape
    ds = bm.shape[-1]
    g = 1
    if route == TENSOR_CORES:
        _check(ssd_route(q, hd, ds) == TENSOR_CORES,
               f"the tensor cores take Q {MMA_Q}, hd {MMA_HD}, ds {MMA_DS}")
        # the kernel copies x, bm and cm rows as 16-byte vectors
        _check(all(t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in
                                                  t.stride()[:-1])
                   for t in (x, bm, cm)),
               "x, bm and cm must be 16-byte aligned, with strides of "
               "whole 16-byte vectors")
        g = plan_head_groups(b, nc, h, _sm_count(x.device.index or 0))
    dev = x.device
    y = torch.empty((b, nc, h, q, hd), dtype=torch.float32, device=dev)
    s = torch.empty((b, nc, h, ds, hd), dtype=torch.float32, device=dev)
    a = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    if a.numel() == 0:
        return y, s, a
    SSD_CHUNK.launch(_ENTRY[route], ptr(x), *x.stride()[:4], ptr(bm),
                     *bm.stride()[:3], ptr(cm), *cm.stride()[:3], ptr(la),
                     *la.stride(), ptr(dt), *dt.stride(), ptr(y), ptr(s),
                     ptr(a), b, nc, h, q, hd, ds, g, route=route)
    return y, s, a


def ssd_resources(route: str, q: int, hd: int = MMA_HD,
                  ds: int = MMA_DS) -> dict:
    """Registers, local memory per thread (bytes: spills and stack, 0 when
    nothing spills), static and dynamic shared memory (bytes), resident
    blocks per SM and threads per block of one instantiation, as the card
    reports them (``cudaFuncGetAttributes`` and the occupancy calculator):
    the tensor-core kernel for chunk length ``q``, or the CUDA-core kernel
    for ``(q, hd, ds)`` (its shared memory grows with them)."""
    fn = library("ssd_chunk").ssd_chunk_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 6)()
    err = fn(0 if route == TENSOR_CORES else 1, q, hd, ds, info)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_info failed (cudaError {err})")
    keys = ("registers", "local_bytes", "static_smem_bytes", "smem_bytes",
            "blocks_per_sm", "threads")
    return dict(zip(keys, info))
