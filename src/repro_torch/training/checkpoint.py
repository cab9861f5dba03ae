"""Checkpoints in the JAX package's format (port of its
``training/checkpoint.py``), with the port's own msgpack codec.

A checkpoint is one msgpack document of the tree.  An array is a map
``{"__nd__": True, "dtype", "shape", "data"}`` with its raw bytes, a bf16
one stored as fp32 bytes under ``"dtype": "bfloat16"``; a list or tuple is
``{"__seq__": "list" | "tuple", "items": [...]}``.  The codec covers what
that tree holds (maps, arrays of them, str, bin, ints, bool, None and
floats) and writes the bytes ``msgpack.packb(..., use_bin_type=True)``
writes, so each package reads the other's files; the machine with the
card has no ``msgpack``.  Leaves may be tensors or numpy arrays; a loaded
array is a CPU tensor.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

# -- msgpack -----------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8-, 16-, 32-bit; None where msgpack has no such form) that
    holds ``n``."""
    if n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32),
                                 (0xcf, ">Q", 1 << 64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too large")
    else:
        for code, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                                (0xd2, ">i", 31), (0xd3, ">q", 63)):
            if n >= -(1 << bits):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too small")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the types above."""
    out = bytearray()

    def pack(o):
        if o is None:
            out.append(0xc0)
        elif o is True or o is False:
            out.append(0xc3 if o else 0xc2)
        elif isinstance(o, int):
            _pack_int(out, o)
        elif isinstance(o, float):
            out.append(0xcb)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            data = o.encode("utf-8")
            _pack_len(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
            out.extend(data)
        elif isinstance(o, bytes):
            _pack_len(out, len(o), 0, 0, (0xc4, 0xc5, 0xc6))
            out.extend(o)
        elif isinstance(o, dict):
            _pack_len(out, len(o), 0x80, 16, (None, 0xde, 0xdf))
            for k, v in o.items():
                pack(k)
                pack(v)
        elif isinstance(o, (list, tuple)):
            _pack_len(out, len(o), 0x90, 16, (None, 0xdc, 0xdd))
            for v in o:
                pack(v)
        else:
            raise TypeError(f"msgpack: cannot pack {type(o).__name__}")

    pack(obj)
    return bytes(out)


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` for the
    types above."""
    view = memoryview(data)
    pos = 0

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(view):
            raise ValueError("msgpack: truncated document")
        pos += n
        return view[pos - n:pos]

    def num(fmt: str):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def unpack():
        code = take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xe0:
            return code - 0x100
        if code < 0x90:
            return unpack_map(code & 0x0f)
        if code < 0xa0:
            return [unpack() for _ in range(code & 0x0f)]
        if code < 0xc0:
            return str(take(code & 0x1f), "utf-8")
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if code in fixed:
            return fixed[code]
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",       # bin
                   0xd9: ">B", 0xda: ">H", 0xdb: ">I",       # str
                   0xdc: ">H", 0xdd: ">I",                   # array
                   0xde: ">H", 0xdf: ">I"}                   # map
        scalars = {0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if code in scalars:
            return num(scalars[code])
        if code not in lengths:
            raise ValueError(f"msgpack: unsupported type byte {code:#x}")
        n = num(lengths[code])
        if code <= 0xc6:
            return bytes(take(n))
        if code <= 0xdb:
            return str(take(n), "utf-8")
        if code <= 0xdd:
            return [unpack() for _ in range(n)]
        return unpack_map(n)

    def unpack_map(n: int) -> dict:
        out = {}
        for _ in range(n):
            k = unpack()
            out[k] = unpack()
        return out

    obj = unpack()
    if pos != len(view):
        raise ValueError("msgpack: trailing bytes after the document")
    return obj


# -- the tree ------------------------------------------------------------------


def _pack(obj: Any):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {"__nd__": True, "dtype": "bfloat16",
                    "shape": list(t.shape),
                    "data": t.float().numpy().tobytes()}
        obj = t.numpy()
    if isinstance(obj, np.ndarray):
        return {"__nd__": True, "dtype": str(obj.dtype),
                "shape": list(obj.shape), "data": obj.tobytes()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": type(obj).__name__,
                "items": [_pack(v) for v in obj]}
    return obj


def _unpack(obj: Any):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            shape = obj["shape"]
            if obj["dtype"] == "bfloat16":
                a = np.frombuffer(obj["data"], np.float32).reshape(shape)
                return torch.from_numpy(a.copy()).to(torch.bfloat16)
            a = np.frombuffer(obj["data"], np.dtype(obj["dtype"]))
            return torch.from_numpy(a.reshape(shape).copy())
        if obj.get("__seq__"):
            items = [_unpack(v) for v in obj["items"]]
            return tuple(items) if obj["__seq__"] == "tuple" else items
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` through a temporary file and a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(_pack(tree)))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return _unpack(unpackb(f.read()))
