"""stablelm-1.6b [dense] — MHA (kv == heads) [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
