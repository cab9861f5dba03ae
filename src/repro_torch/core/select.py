"""Token selection for partial reuse (port of the JAX package's
``core/select.py``, the MPIC-k strategy).

MPIC-k recomputes *all text tokens* plus the *first k tokens of every
media segment*.
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


def selection_indices(sel: np.ndarray) -> np.ndarray:
    return np.nonzero(sel)[0].astype(np.int32)
