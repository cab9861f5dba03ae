"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    source="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
