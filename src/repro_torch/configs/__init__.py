"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port serves the paper's model only; other architectures of the JAX
package are not ported yet."""
from __future__ import annotations

from repro_torch.configs import llava_mpic
from repro_torch.configs.base import ModelConfig, reduced

_REGISTRY = {"llava-1.6-7b": llava_mpic}


def _module(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG


__all__ = ["ModelConfig", "get_config", "get_smoke_config", "reduced"]
