"""The paper's own model: a LLaVA-1.6-style 7B VLM backbone (vicuna-7B LM
plus a ViT frontend stub) [Liu et al., 2024b]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-1.6-7b",
    arch_type="vlm",
    source="arXiv: Liu et al. 2024b (LLaVA-NeXT)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,          # vicuna-7B is MHA
    d_ff=11008,
    vocab_size=32000,
    is_multimodal=True,
    media_token_len=576,      # LLaVA-1.5 tokens per image
    sliding_window=8192,
)

SMOKE_CONFIG = reduced(CONFIG, media_token_len=32)
