"""Request lifecycle (port of the JAX package's ``serving/request.py``, the
fields the paged engine uses)."""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.segments import Prompt

_ids = itertools.count()


class State(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"   # owns a slot, first token not out yet
    RUNNING = "running"         # decode phase (continuous batching slot)
    DONE = "done"
    FAILED = "failed"           # prefill raised or bad policy; slot freed


@dataclasses.dataclass(eq=False)
class Request:
    prompt: Prompt
    max_new_tokens: int = 16
    policy: str = "mpic"
    policy_kwargs: dict = dataclasses.field(default_factory=dict)
    priority: int = 0                # higher admits sooner (FIFO within ties)
    # MRAG: if set, the retriever runs after the prefill
    retrieval_query: Optional[np.ndarray] = None
    retrieval_top_k: int = 1

    req_id: str = dataclasses.field(
        default_factory=lambda: f"req{next(_ids)}")
    state: State = State.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    cur_len: int = 0                 # tokens currently in this request's cache
    slot: int = -1                   # decode batch slot
    error: Optional[str] = None      # why the request FAILED

    # metrics
    t_arrival: float = dataclasses.field(default_factory=time.perf_counter)
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    prefill_stats: dict = dataclasses.field(default_factory=dict)
    linked_media: List[str] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def done(self) -> bool:
        return self.state == State.DONE
