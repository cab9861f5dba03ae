"""MRAG retriever (MPIC component 4, Fig. 5).

The paper's analogy: the retriever is the *relocation table* — it finds
which dynamic-library entries a query needs, and the Linker relocates their
KV caches into the request.  Retrieval is embedding cosine similarity over
the dynamic library's media index (the retriever model itself is a simple
mean-pooled embedding — building a full dual-encoder is out of the paper's
scope; the *system* path it exercises is the point).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class Retriever:
    def __init__(self):
        self._index: Dict[str, np.ndarray] = {}   # media_id -> embedding

    def add(self, media_id: str, embeds: np.ndarray) -> None:
        v = embeds.mean(axis=0)
        self._index[media_id] = v / (np.linalg.norm(v) + 1e-8)

    def remove(self, media_id: str) -> None:
        self._index.pop(media_id, None)

    def query(self, q: np.ndarray, top_k: int = 1) -> List[Tuple[str, float]]:
        if not self._index:
            return []
        qv = q / (np.linalg.norm(q) + 1e-8)
        scored = [(mid, float(np.dot(qv, v))) for mid, v in self._index.items()]
        scored.sort(key=lambda x: -x[1])
        return scored[:top_k]

    def __len__(self) -> int:
        return len(self._index)
