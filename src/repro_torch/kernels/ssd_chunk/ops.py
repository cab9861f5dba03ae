"""Dispatch for the SSD intra-chunk step: the CUDA kernel on the card, the
plain version on the CPU.

``ssd_chunk(x, bm, cm, la, dt)`` takes the contract's layout, as the JAX
package's ``ssd_chunk`` does: x (B, NC, H, Q, hd), bm/cm (B, NC, Q, ds),
la/dt (B, NC, H, Q), all fp32.  It returns y_intra (B, NC, H, Q, hd), s_c
(B, NC, H, ds, hd) and a_c (B, NC, H), contiguous fp32.  The operands may
be strided views: the model holds x as (B, NC, Q, H, hd) and la/dt as
(B, NC, Q, H) and passes them permuted, and the kernel reads them in place
through their strides; only the last dim of x, bm and cm must have unit
stride.

A CPU tensor goes to :func:`ssd_chunk_ref`.  A CUDA tensor launches
``ssd_chunk`` of ``csrc/ssd_chunk.cu`` (Q <= 128, ds <= 128, hd <= 128), or
raises: there is no fallback on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, ptr
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

_P, _S = ctypes.c_void_p, ctypes.c_int64
SSD_CHUNK = Kernel("ssd_chunk", "ssd_chunk",
                   [_P] + [_S] * 4 + ([_P] + [_S] * 3) * 2
                   + ([_P] + [_S] * 4) * 2 + [_P] * 3 + [ctypes.c_int] * 6)
KERNELS = (SSD_CHUNK,)
MAX_Q = MAX_DS = MAX_HD = 128


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunk: {what}")


def ssd_chunk(x, bm, cm, la, dt):
    if x.device.type == "cpu":
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
    dev = x.device
    y = torch.empty((b, nc, h, q, hd), dtype=torch.float32, device=dev)
    s = torch.empty((b, nc, h, ds, hd), dtype=torch.float32, device=dev)
    a = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    if a.numel() == 0:
        return y, s, a
    SSD_CHUNK.launch("f32", ptr(x), *x.stride()[:4], ptr(bm),
                     *bm.stride()[:3], ptr(cm), *cm.stride()[:3], ptr(la),
                     *la.stride(), ptr(dt), *dt.stride(), ptr(y), ptr(s),
                     ptr(a), b, nc, h, q, hd, ds)
    return y, s, a
