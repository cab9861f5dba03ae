"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and means the card by it.  Only a
caller that asks for ``"cpu"`` gets the CPU, where the kernels' plain
PyTorch versions run; there is no silent fallback from the card to the CPU.
``"meta"`` builds shapes without memory (the tensor-parallel plan reads a
model's parameter shapes so, and the dry run traces whole steps there).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
