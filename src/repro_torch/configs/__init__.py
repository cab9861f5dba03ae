"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port serves the paper's model (llava-1.6-7b, MHA), four dense GQA or
MHA decoders (qwen2.5-14b with QKV bias, G 5; yi-9b, G 8;
phi3-medium-14b, G 4; stablelm-1.6b, MHA at head dim 64), two MoE
decoders (deepseek-moe-16b, MHA at head dim 128, 64 experts top-6 and 2
shared; granite-moe-1b-a400m, G 2 at head dim 64, 32 experts top-8),
mamba2-130m, the hybrid hymba-1.5b (attention and SSD heads in every
layer, G 5, a 2048-token window) and the encoder-decoder whisper-small
(learned positions, cross attention over 1,500 encoded audio frames),
and internvl2-76b (80 layers at d 8192, G 8 at head dim 128; 141 GB of
bf16 weights, served tensor-parallel).

``ASSIGNED_ARCHS`` are the dry run's architectures, the reference's list
in its order: every registered arch but the paper's llava."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_moe_16b,
    granite_moe_1b_a400m,
    hymba_1_5b,
    internvl2_76b,
    llava_mpic,
    mamba2_130m,
    phi3_medium_14b,
    qwen2_5_14b,
    stablelm_1_6b,
    whisper_small,
    yi_9b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    reduced,
)

_REGISTRY = {"llava-1.6-7b": llava_mpic, "mamba2-130m": mamba2_130m,
             "qwen2.5-14b": qwen2_5_14b, "yi-9b": yi_9b,
             "phi3-medium-14b": phi3_medium_14b,
             "stablelm-1.6b": stablelm_1_6b, "hymba-1.5b": hymba_1_5b,
             "deepseek-moe-16b": deepseek_moe_16b,
             "granite-moe-1b-a400m": granite_moe_1b_a400m,
             "whisper-small": whisper_small,
             "internvl2-76b": internvl2_76b}

ASSIGNED_ARCHS = ["internvl2-76b", "phi3-medium-14b", "yi-9b", "hymba-1.5b",
                  "stablelm-1.6b", "granite-moe-1b-a400m", "mamba2-130m",
                  "deepseek-moe-16b", "whisper-small", "qwen2.5-14b"]


def _module(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG


__all__ = ["ASSIGNED_ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config", "get_smoke_config", "reduced"]
