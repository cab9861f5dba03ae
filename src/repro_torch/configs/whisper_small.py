"""whisper-small [audio] — encoder-decoder [arXiv:2212.04356].

Backbone only: the mel-spectrogram and conv frontend are a stub, and the
caller supplies precomputed frame embeddings (B, 1500, d).  The decoder's
self-attention KV is request-specific; the cacheable artifact of this
family is the decoder's cross-attention KV over the encoded audio, which
carries no decoder position.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq=1500,
    learned_pos_emb=True,
    max_position_embeddings=32768,
)

SMOKE_CONFIG = reduced(CONFIG)
