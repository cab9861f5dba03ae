"""Waiting queue of the engine (port of ``WaitingQueue`` in the JAX
package's ``serving/scheduler.py``, without priority aging).

Admission is sequential: the engine pops one request at a time and links
it with blocking library lookups, as the JAX engine does with
``pipelined=False``.  The pipelined scheduler and its parallel loader are
not ported yet.
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Tuple

from repro_torch.serving.request import Request


class WaitingQueue:
    """Priority waiting queue: higher ``Request.priority`` first, FIFO ties."""

    def __init__(self):
        self._heap: List[Tuple[int, int, Request]] = []
        self._seq = itertools.count()

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (-req.priority, next(self._seq), req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
