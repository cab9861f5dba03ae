"""qwen2.5-14b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
