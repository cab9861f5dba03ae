"""Static and dynamic KV libraries, memory tier only (port of the JAX
package's ``cache/library.py``).

The **static library** holds the KV of user-uploaded files, scoped per user
(user A cannot link user B's cache).  The **dynamic library** holds the
MRAG corpus, shared by every user under the ``"*"`` scope.  Entries expire
after their TTL; an expired entry is dropped at lookup and the caller
recomputes.  Entries hold tensors on the engine's device.

Not ported yet: the disk and network tiers, the int8 spool, pins and the
per-replica accounting of the JAX library.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(eq=False)
class Entry:
    media_id: str
    k: torch.Tensor            # (L, length, Hkv, Dh), position 0 based
    v: torch.Tensor
    expires: float = float("inf")


class KVLibrary:
    def __init__(self, *, shared: bool = False,
                 default_ttl: float = float("inf")):
        self.shared = shared
        self.default_ttl = default_ttl
        self._entries: Dict[Tuple[str, str], Entry] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def _key(self, user_id: str, media_id: str) -> Tuple[str, str]:
        return ("*", media_id) if self.shared else (user_id, media_id)

    def put(self, user_id: str, media_id: str, k: torch.Tensor,
            v: torch.Tensor, *, ttl: Optional[float] = None) -> Entry:
        """Store one media KV block, replacing any block under the scope."""
        ttl = self.default_ttl if ttl is None else ttl
        e = Entry(media_id=media_id, k=k, v=v, expires=time.time() + ttl)
        with self._lock:
            self._entries[self._key(user_id, media_id)] = e
        return e

    def get(self, user_id: str, media_id: str) -> Optional[Entry]:
        """Lookup honouring user scoping and expiry."""
        key = self._key(user_id, media_id)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and time.time() > e.expires:
                del self._entries[key]
                e = None
            if e is None:
                self._misses += 1
            else:
                self._hits += 1
            return e

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self._hits,
                    "misses": self._misses}
