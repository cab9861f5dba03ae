"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                # per-expert hidden
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    num_shared_experts=0,
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG)
