"""mamba2-130m [ssm]: SSD, attention-free [arXiv:2405.21060].

MPIC does not apply (no KV cache; the recurrent state depends on the
prefix and its positions): the engine serves it on its dense cache and
rewrites every policy to ``full_recompute``.  Decode is O(1) in the
sequence length.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    tie_embeddings=True,
)

SMOKE_CONFIG = reduced(CONFIG, ssm_state=32)
