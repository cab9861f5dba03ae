"""Prompt segment model.

A prompt is an ordered list of segments — text runs and media (image /
audio / video) references.  Media segments point into the MPIC library by
``media_id``; their KV cache may be linked position-independently.
(The port's own copy of the JAX package's ``core/segments.py``.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(eq=False)
class Segment:
    kind: str                       # "text" | "image" | "audio" | "system"
    length: int
    tokens: Optional[np.ndarray] = None   # int32 (text/system)
    media_id: Optional[str] = None        # library key (media)
    # precomputed frontend embeddings for media (length, d_model) — the
    # modality-frontend carve-out (ViT / mel+conv are stubs upstream)
    embeds: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind in ("text", "system"):
            if self.tokens is None or len(self.tokens) != self.length:
                raise ValueError("a text segment needs `length` tokens")
        elif self.media_id is None:
            raise ValueError("a media segment needs a media_id")

    @property
    def is_media(self) -> bool:
        return self.kind not in ("text", "system")


@dataclass(eq=False)
class Prompt:
    segments: List[Segment]
    user_id: str = "anon"

    @property
    def total_len(self) -> int:
        return sum(s.length for s in self.segments)

    def offsets(self) -> List[int]:
        """Start position of each segment in the flattened prompt."""
        out, p = [], 0
        for s in self.segments:
            out.append(p)
            p += s.length
        return out

    def media_segments(self) -> List[tuple]:
        return [(off, seg) for off, seg in zip(self.offsets(), self.segments)
                if seg.is_media]

    def flat_tokens(self, pad_token: int = 0) -> np.ndarray:
        """Token ids over the full prompt (media slots get ``pad_token``)."""
        out = np.full((self.total_len,), pad_token, np.int32)
        for off, seg in zip(self.offsets(), self.segments):
            if not seg.is_media:
                out[off:off + seg.length] = seg.tokens
        return out

    def media_mask(self) -> np.ndarray:
        m = np.zeros((self.total_len,), bool)
        for off, seg in self.media_segments():
            m[off:off + seg.length] = True
        return m

    def flat_media_embeds(self, d_model: int) -> np.ndarray:
        out = np.zeros((self.total_len, d_model), np.float32)
        for off, seg in self.media_segments():
            if seg.embeds is not None:
                out[off:off + seg.length] = seg.embeds
        return out


def text_segment(tokens: Sequence[int], kind: str = "text") -> Segment:
    t = np.asarray(tokens, np.int32)
    return Segment(kind=kind, length=len(t), tokens=t)


def media_segment(media_id: str, embeds: np.ndarray, kind: str = "image") -> Segment:
    return Segment(kind=kind, length=embeds.shape[0], media_id=media_id,
                   embeds=embeds)
