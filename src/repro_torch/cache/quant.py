"""Int8 KV quantization and the spool wire format (port of the JAX
package's ``cache/quant.py``).

The library can store media KV as int8 with per-(layer, head, channel)
symmetric scales (``KVLibrary(quantize=True)``), half the bytes of bf16;
the int8 page pool links those bytes by rescaling onto its page grid
(``PagedKVPool.link_write_q8``).  Quantization runs in fp32 torch on
whatever device holds the KV and gives the JAX package's numpy bytes
exactly: the same fp32 amax, division and round-half-to-even.

This module also owns the **spool wire format** (``spool_payload`` /
``unspool_payload``), the npz files of the disk tier.  The field names and
layouts are the JAX package's, so either package reads the other's files:
quantized blocks as ``qk``/``qk_scale``/``qv``/``qv_scale`` (plus
``qk_block``/``qv_block`` when the scales are per token block), fp blocks
as ``k``/``v``.  bfloat16 has no numpy dtype here, so it ships as a
``uint16`` view with a ``<name>__dtype = "bfloat16"`` field beside it, as
the JAX package writes it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

# One symmetric int8 grid for the library, the wire and the int8 page pool:
# every scale is amax / QMAX, so a block moves between them by rescaling.
QMAX = 127.0


def grid_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / QMAX, divided as numpy divides.  The divisor is a tensor on
    purpose: on the card, PyTorch divides by a Python scalar through its
    reciprocal, which misses the quotient by an ulp now and then."""
    amax = amax.float()
    return amax / torch.full_like(amax, QMAX)


def symmetric_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax -> scale on the shared grid; an all-zero slice gets scale 1.0
    so that a division by it never blows up."""
    amax = amax.float()
    return torch.where(amax > 0, grid_scale(amax), torch.ones_like(amax))


@dataclasses.dataclass
class QuantizedKV:
    q: torch.Tensor          # int8, the source's shape (L, S, H, Dh)
    scale: torch.Tensor      # fp32, (L, 1, H, Dh) for the whole sequence or
    #                          (L, nb, H, Dh) with block_tokens per block
    block_tokens: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


def quantize_kv(x, block_tokens: Optional[int] = None) -> QuantizedKV:
    """x (L, S, H, Dh) fp -> int8 with per-(L, H, Dh) symmetric scales, on
    x's device.

    ``block_tokens=bt`` cuts the token axis into ``ceil(S / bt)`` blocks,
    each with its own (L, H, Dh) amax, the granularity of the int8 pool's
    pages."""
    x = torch.as_tensor(x).float()
    if block_tokens is None:
        scale = symmetric_scale(x.abs().amax(dim=1, keepdim=True))
        q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
        return QuantizedKV(q=q, scale=scale)
    if block_tokens < 1:
        raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
    L, S, H, Dh = x.shape
    nb = -(-S // block_tokens)
    pad = nb * block_tokens - S
    blocks = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).reshape(
        L, nb, block_tokens, H, Dh)
    scale = symmetric_scale(blocks.abs().amax(dim=2))        # (L, nb, H, Dh)
    q = torch.clamp(torch.round(blocks / scale[:, :, None]), -QMAX, QMAX)
    q = q.reshape(L, nb * block_tokens, H, Dh)[:, :S].to(torch.int8)
    return QuantizedKV(q=q, scale=scale, block_tokens=block_tokens)


def dequantize_kv(qkv: QuantizedKV) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: fp32 out, within scale / 2."""
    if qkv.block_tokens is None:
        return qkv.q.float() * qkv.scale
    S = qkv.q.shape[1]
    scale = qkv.scale.repeat_interleave(qkv.block_tokens, dim=1)[:, :S]
    return qkv.q.float() * scale


# ---------------------------------------------------------------------------
# spool wire format
# ---------------------------------------------------------------------------

# (signed, unsigned) integer dtype names of each byte width
_INT_OF_WIDTH = {1: ("int8", "uint8"), 2: ("int16", "uint16"),
                 4: ("int32", "uint32"), 8: ("int64", "uint64")}


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype (``"bfloat16"``, ``"int8"``…),
    which the content hash covers."""
    return str(t.dtype).removeprefix("torch.")


def host_array(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a C-ordered numpy array on the host, copied
    from the card if it lives there; a dtype numpy lacks (bfloat16) comes
    as the unsigned integer view of its width."""
    t = t.detach().contiguous().cpu()
    try:
        return t.numpy()
    except TypeError:
        signed, unsigned = _INT_OF_WIDTH[t.element_size()]
        return t.view(getattr(torch, signed)).numpy().view(unsigned)


def _to_wire(name: str, t: torch.Tensor) -> dict:
    """One npz field per tensor, plus ``<name>__dtype`` for a dtype numpy
    lacks, so that the reader restores it bit- and dtype-identical."""
    a = host_array(t)
    if a.dtype.name == dtype_name(t):
        return {name: a}
    return {name: a, name + "__dtype": np.array(dtype_name(t))}


def _from_wire(z, name: str) -> torch.Tensor:
    a = z[name]
    if name + "__dtype" in z.files:
        signed, _ = _INT_OF_WIDTH[a.dtype.itemsize]
        return torch.from_numpy(a.view(signed)).view(
            getattr(torch, str(z[name + "__dtype"])))
    return torch.from_numpy(a)


def spool_payload(file, payload, meta: Optional[dict] = None) -> None:
    """Write a KV payload to ``file`` (a path or a file object) as npz.

    ``payload`` has ``k``/``v``/``qk``/``qv`` attributes
    (:class:`repro_torch.cache.backends.KVPayload`); the int8 form wins
    when present.  ``meta``, when given, goes in a ``__meta__`` JSON field
    that the content hash does not cover."""
    if payload.qk is not None:
        fields = {"qk": payload.qk.q, "qk_scale": payload.qk.scale,
                  "qv": payload.qv.q, "qv_scale": payload.qv.scale}
        # the block size is not recoverable from the shapes: it ships
        for name, qkv in (("qk", payload.qk), ("qv", payload.qv)):
            if qkv.block_tokens is not None:
                fields[name + "_block"] = torch.tensor(qkv.block_tokens,
                                                       dtype=torch.int64)
    else:
        fields = {"k": payload.k, "v": payload.v}
    wire = {}
    for name, t in fields.items():
        wire.update(_to_wire(name, t))
    if meta is not None:
        wire["__meta__"] = np.array(json.dumps(meta))
    np.savez(file, **wire)


def unspool_payload(file) -> dict:
    """Parse one spooled npz block into payload fields, as CPU tensors:
    ``{"k", "v"}`` or ``{"qk": QuantizedKV, "qv": QuantizedKV}``.  Raises
    whatever ``np.load`` raises on truncated or corrupt bytes; the disk
    backend counts that as a miss."""
    with np.load(file) as z:
        if "qk" in z.files:
            def bt(name):
                return (int(z[name + "_block"].ravel()[0])
                        if name + "_block" in z.files else None)
            return {"qk": QuantizedKV(_from_wire(z, "qk"),
                                      _from_wire(z, "qk_scale"),
                                      block_tokens=bt("qk")),
                    "qv": QuantizedKV(_from_wire(z, "qv"),
                                      _from_wire(z, "qv_scale"),
                                      block_tokens=bt("qv"))}
        return {"k": _from_wire(z, "k"), "v": _from_wire(z, "v")}


def read_spool_meta(file) -> Optional[dict]:
    """The ``__meta__`` field of a spooled block, or None without one."""
    with np.load(file) as z:
        if "__meta__" not in z.files:
            return None
        return json.loads(str(z["__meta__"]))
