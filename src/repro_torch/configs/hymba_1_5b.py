"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Each layer runs GQA attention heads and SSD (mamba2) heads in parallel on
the same input and fuses their (normalized) outputs.  The attention heads
use a sliding window in every layer.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=1,            # SSM heads operate at d_model width
    sliding_window=2048,
)

SMOKE_CONFIG = reduced(CONFIG, num_heads=4, num_kv_heads=2, ssm_state=16)
