"""Token selection for partial reuse (port of the JAX package's
``core/select.py``).

MPIC-k recomputes *all text tokens* plus the *first k tokens of every
media segment*.  CacheBlend-r recomputes the text plus the top r of the
media tokens by a measured KV deviation (the probe pass MPIC avoids).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.segments import Prompt


def mpic_selection(prompt: Prompt, k: int) -> np.ndarray:
    """Boolean mask (total_len,): True = recompute (selected)."""
    sel = np.zeros((prompt.total_len,), bool)
    for off, seg in zip(prompt.offsets(), prompt.segments):
        if seg.is_media:
            sel[off:off + min(k, seg.length)] = True
        else:
            sel[off:off + seg.length] = True
    return sel


def full_reuse_selection(prompt: Prompt) -> np.ndarray:
    """Only text is recomputed (k = 0); media KV fully reused."""
    return mpic_selection(prompt, k=0)


def cacheblend_selection(prompt: Prompt, deviation: np.ndarray,
                         r: float) -> np.ndarray:
    """Top r of the *media* tokens by measured KV deviation, plus all text.

    deviation: (total_len,) per-token score (text entries ignored)."""
    sel = full_reuse_selection(prompt)
    media = prompt.media_mask()
    n_pick = int(round(r * int(media.sum())))
    if n_pick > 0:
        dev = np.where(media, deviation, -np.inf)
        picks = np.argpartition(dev, -n_pick)[-n_pick:]
        sel[picks] = True
    return sel


def selection_indices(sel: np.ndarray) -> np.ndarray:
    return np.nonzero(sel)[0].astype(np.int32)
