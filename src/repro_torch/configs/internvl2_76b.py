"""internvl2-76b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone only, as in the JAX package: the ViT and projector frontend is a
stub, and requests carry precomputed patch embeddings of the right shape.
Its bf16 weights (141.1 GB at the config's shapes) need more than one
card: the port serves it tensor-parallel over a ``model`` axis
(``launch/mesh.py``, ``serving/sharding.py``).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    is_multimodal=True,
    media_token_len=256,
    sliding_window=8192,  # long_500k decode uses the sliding-window path
)

SMOKE_CONFIG = reduced(CONFIG)
