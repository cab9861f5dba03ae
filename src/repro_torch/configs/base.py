"""Model configuration dataclass (the port's own copy).

Field for field the same as the JAX package's ``ModelConfig``, so one
configuration reads the same in both packages and the tests can compare
them with ``dataclasses.asdict``.  The port serves only the attention-only
architectures (``Model`` rejects the rest); the other fields are kept so
that the two dataclasses stay interchangeable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    # transformer core ---------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variants -------------------------------------------------
    sliding_window: int = 0      # 0 = full causal attention

    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    router_aux_loss_coef: float = 0.01

    # SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64

    # hybrid (hymba) ---------------------------------------------------------
    hybrid: bool = False

    # encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    learned_pos_emb: bool = False
    max_position_embeddings: int = 32768

    # multimodal (vlm): media patch embeddings injected at token positions
    is_multimodal: bool = False
    media_token_len: int = 256

    # numerics -------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # layer-scan switch of the JAX package; the port always loops in Python
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attn_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims."""
    d = {
        "num_layers": min(cfg.num_layers, 2),
        "d_model": min(cfg.d_model, 256),
        "num_heads": min(cfg.num_heads, 4),
        "num_kv_heads": min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        "head_dim": 64,
        "d_ff": min(cfg.d_ff, 512) if cfg.d_ff else 0,
        "vocab_size": min(cfg.vocab_size, 512),
        "num_experts": min(cfg.num_experts, 4) if cfg.num_experts else 0,
        "experts_per_token": min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        "num_shared_experts": min(cfg.num_shared_experts, 1),
        "encoder_layers": min(cfg.encoder_layers, 2),
        "encoder_seq": min(cfg.encoder_seq, 32),
        "ssm_state": min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        "ssm_chunk": 16,
        "media_token_len": 16,
        "sliding_window": min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        "max_position_embeddings": 2048,
        "name": cfg.name + "-smoke",
    }
    # keep MHA-ness
    if cfg.num_kv_heads and cfg.num_kv_heads == cfg.num_heads:
        d["num_kv_heads"] = d["num_heads"]
    d.update(over)
    return dataclasses.replace(cfg, **d)
