"""Request lifecycle (port of the JAX package's ``serving/request.py``).

``deadline_s`` is a wall-clock budget from ``t_arrival``: the engine reaps
a request past it (terminal ``DEADLINE``) at admission and at the top of
every step, and the cluster reaps one held under backpressure.  A
failover resubmit keeps ``t_arrival``, so the clock runs on."""
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
    DEADLINE = "deadline"       # deadline_s elapsed; reaped, resources freed
    FROZEN = "frozen"           # decode snapshotted into the library; slot
                                # freed (serving/sessions.py)


@dataclasses.dataclass(eq=False)
class Request:
    prompt: Prompt
    max_new_tokens: int = 16
    policy: str = "mpic"
    policy_kwargs: dict = dataclasses.field(default_factory=dict)
    priority: int = 0                # higher admits sooner (FIFO within ties)
    seed: int = 0                    # sampling generator seed (greedy=False)
    # MRAG: if set, the retriever runs after the prefill
    retrieval_query: Optional[np.ndarray] = None
    retrieval_top_k: int = 1
    # wall-clock budget from arrival (seconds); None: no deadline
    deadline_s: Optional[float] = None
    # the session this request belongs to (set by thaw and fork, stamped by
    # freeze), and an optional freeze point: once this many output tokens
    # are out, the engine freezes the request instead of decoding further
    session_id: Optional[str] = None
    freeze_after: Optional[int] = None

    req_id: str = dataclasses.field(
        default_factory=lambda: f"req{next(_ids)}")
    state: State = State.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    cur_len: int = 0                 # tokens currently in this request's cache
    slot: int = -1                   # decode batch slot
    replica: int = -1                # engine replica (cluster routing)
    error: Optional[str] = None      # why the request FAILED

    # metrics
    t_arrival: float = dataclasses.field(default_factory=time.perf_counter)
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    prefill_stats: dict = dataclasses.field(default_factory=dict)
    linked_media: List[str] = dataclasses.field(default_factory=list)
    # TTFT breakdown and overlap, filled by the scheduler at the first token
    load_s: float = 0.0              # loader-worker busy time for its media
    load_blocked_s: float = 0.0      # time the engine waited on those loads
    compute_s: float = 0.0           # prefill wall minus that waiting
    overlap_s: float = 0.0           # load time hidden under engine compute

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.t_admitted - self.t_arrival)

    @property
    def prefill_wall_s(self) -> float:
        """Admission to first token."""
        return max(0.0, self.t_first_token - self.t_admitted)

    @property
    def load_overlap_ratio(self) -> float:
        """Share of this request's load time hidden under compute."""
        return self.overlap_s / self.load_s if self.load_s > 0 else 0.0

    def past_deadline(self, now: Optional[float] = None) -> bool:
        """Has the budget from arrival elapsed?  False without a
        ``deadline_s``."""
        if self.deadline_s is None:
            return False
        return ((now if now is not None else time.perf_counter())
                - self.t_arrival > self.deadline_s)

    @property
    def done(self) -> bool:
        return self.state == State.DONE
