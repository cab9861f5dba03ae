"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
