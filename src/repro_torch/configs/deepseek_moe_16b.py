"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert hidden (fine-grained)
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
