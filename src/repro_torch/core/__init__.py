from repro_torch.core.segments import (
    Prompt,
    Segment,
    media_segment,
    text_segment,
)

__all__ = ["Prompt", "Segment", "media_segment", "text_segment"]
