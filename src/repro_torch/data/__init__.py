from repro_torch.data.datasets import (
    SYSTEM_PROMPT,
    DialogueSample,
    image_embeds,
    make_dialogues,
)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DialogueSample", "SYSTEM_PROMPT", "image_embeds",
           "make_dialogues", "ByteTokenizer"]
