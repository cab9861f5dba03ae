"""Context-caching policies (port of the JAX package's ``core/policies.py``:
the paper's MPIC on the paged pool).

Not ported yet: ``cacheblend`` and the baselines (``full_recompute``,
``prefix_caching``, ``full_reuse``) and MPIC's dense-cache branch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import select as sel_mod
from repro_torch.core.segments import Prompt


@dataclasses.dataclass
class PolicyResult:
    first_logits: np.ndarray      # (V,) logits for the first output token
    cache: Optional[dict]         # None: the KV already sits in the pool
    stats: dict                   # n_recomputed, n_reused, engine_steps, wall_s


def mpic(model, params, prompt: Prompt, library, *, paged, k: int = 32,
         **kw) -> PolicyResult:
    """MPIC-k: single-step selective attention (the paper's algorithm).

    ``paged`` is the engine-bound :class:`~repro_torch.core.paged_prefill.
    BoundPagedPrefill`: link and selective prefill both write straight into
    the request's pages, and the first token's logits come back."""
    t0 = time.perf_counter()
    selection = sel_mod.mpic_selection(prompt, k)
    link = paged.link(model, prompt, library, selection)
    first = paged.prefill(params, link)
    return PolicyResult(
        first, None,
        {"policy": f"mpic-{k}", "n_recomputed": link.n_recomputed,
         "n_reused": link.n_reused, "engine_steps": 1,
         "paged_prefill": True, "wall_s": time.perf_counter() - t0,
         "misses": link.misses})


POLICIES = {"mpic": mpic}
