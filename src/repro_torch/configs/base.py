"""Model configuration dataclass (the port's own copy).

Field for field the same as the JAX package's ``ModelConfig``, so one
configuration reads the same in both packages and the tests can compare
them with ``dataclasses.asdict``.  The port serves the attention-only
architectures, the pure SSM, the attention + SSM hybrid and the audio
encoder-decoder (``Model`` rejects other combinations); every field is
kept so that the two dataclasses stay interchangeable.  ``n_params`` /
``n_active_params``, :class:`InputShape` and :data:`INPUT_SHAPES` (the
dry run's four input shapes) are the reference's too.
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

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count, the reference's formula term for term
        (the 6ND model FLOPs of ``roofline.model_flops`` read it)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if not self.attn_free:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        if self.arch_type in ("moe",):
            per_layer += d * self.num_experts  # router
            per_layer += (self.num_experts + self.num_shared_experts) * 3 * d * self.d_ff
        elif self.arch_type == "ssm":
            di, ds, nh = self.ssm_inner, self.ssm_state, self.ssm_num_heads
            per_layer += d * (2 * di + 2 * ds + nh)  # in_proj(z,x) + B,C + dt
            per_layer += di * d  # out_proj
            per_layer += self.ssm_conv_width * di + nh + di  # conv, A, D
        else:
            per_layer += 3 * d * self.d_ff
        if self.hybrid:
            di, ds, nh = self.ssm_inner, self.ssm_state, self.ssm_num_heads
            per_layer += d * (2 * di + 2 * ds + nh) + di * d
            per_layer += self.ssm_conv_width * di + nh + di
        per_layer += 2 * d  # norms
        n += L * per_layer
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, decoder cross-attn
            enc = self.encoder_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            cross = L * (4 * d * d)
            n += enc + cross
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts that fire)."""
        if self.arch_type != "moe":
            return self.n_params()
        full = self.n_params()
        inactive = (self.num_experts - self.experts_per_token)
        per_expert = 3 * self.d_model * self.d_ff
        return full - self.num_layers * inactive * per_expert


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


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
