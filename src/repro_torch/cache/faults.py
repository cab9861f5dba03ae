"""Deterministic fault injection for the serving stack (port of the JAX
package's ``cache/faults.py``).

MPIC degrades by one rule: a failed fetch is a recompute.  This module
makes every failure mode of that rule reproducible.  A seeded
:class:`FaultPlan` holds ordered :class:`FaultRule`\\ s, and each injection
site calls :meth:`FaultPlan.check` at the moment the fault would occur.
Rule windows count events and probability draws come from one seeded RNG,
so a plan replays bit-identically, and the same plan string with the same
seed fires on the same events in this package and in the JAX package.

Injection sites and the fault ``kind``\\ s they honour:

    site            kinds                 consulted by
    --------------  --------------------  --------------------------------
    peer.request    blackhole | latency   PeerTransport._request
    peer.body       corrupt               PeerTransport.fetch
    disk.read       io_error              DiskBackend.get
    disk.write      io_error | enospc     DiskBackend.put
    loader.fetch    stall | error         ParallelLoader._timed_get
    engine.step     crash                 MPICEngine.step

``target`` scopes a rule: ``"*"`` matches every event at the site; anything
else matches by substring against the site's event target (peer address,
spool path, media id, replica id).  ``start``/``stop`` bound the rule to a
window of *matching* events (it fires while ``start <= n < stop``).

String form (``FaultPlan.parse``; the serving CLI's ``--fault-plan``):
rules are ``;``-separated, each ``site:kind[:key=val[,key=val...]]``,
e.g. ``"peer.request:blackhole;disk.write:enospc:start=3"``.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import List, Optional, Sequence


class ReplicaCrash(RuntimeError):
    """Injected engine failure (``engine.step:crash``), raised out of
    ``MPICEngine.step`` before any per-request work."""


@dataclasses.dataclass
class FaultRule:
    """One declarative fault.  ``matched`` counts the events this rule
    matched (site and target), ``fired`` those it injected on."""
    site: str
    kind: str
    target: str = "*"
    start: int = 0                    # first matching event index that fires
    stop: Optional[int] = None        # fire while start <= n < stop
    prob: float = 1.0                 # seeded per-event draw when < 1.0
    delay_s: float = 0.0              # latency / stall duration; blackhole
                                      # wait override (0: the peer timeout)
    matched: int = 0
    fired: int = 0

    def matches(self, target: str) -> bool:
        return self.target == "*" or self.target in target

    def describe(self) -> str:
        extras = []
        if self.target != "*":
            extras.append(f"target={self.target}")
        if self.start:
            extras.append(f"start={self.start}")
        if self.stop is not None:
            extras.append(f"stop={self.stop}")
        if self.prob < 1.0:
            extras.append(f"prob={self.prob}")
        if self.delay_s:
            extras.append(f"delay_s={self.delay_s}")
        tail = f":{','.join(extras)}" if extras else ""
        return f"{self.site}:{self.kind}{tail}"


class FaultPlan:
    """Seeded, thread-safe fault schedule.

    ``check(site, target)`` is the only runtime API: every injection site
    calls it once per would-be fault and gets the first rule that fires, or
    None.  Every matching rule's event counter advances on every call, so
    windows do not depend on how many rules coexist.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), *, seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def check(self, site: str, target: str = "") -> Optional[FaultRule]:
        """The first rule firing for this event; advances every matching
        rule's window.  One lock covers the counters and the RNG."""
        hit: Optional[FaultRule] = None
        with self._lock:
            for r in self.rules:
                if r.site != site or not r.matches(target):
                    continue
                n = r.matched
                r.matched += 1
                if hit is not None:
                    continue          # the first firing rule wins; counted
                if n < r.start or (r.stop is not None and n >= r.stop):
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                hit = r
        return hit

    @staticmethod
    def sleep(rule: Optional[FaultRule]) -> None:
        """Serve a latency or stall rule's delay."""
        if rule is not None and rule.delay_s > 0:
            time.sleep(rule.delay_s)

    def stats(self) -> List[dict]:
        with self._lock:
            return [{"rule": r.describe(), "matched": r.matched,
                     "fired": r.fired} for r in self.rules]

    def __bool__(self) -> bool:
        return bool(self.rules)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, "
                f"rules=[{'; '.join(r.describe() for r in self.rules)}])")

    _INT_KEYS = ("start", "stop")
    _FLOAT_KEYS = ("prob", "delay_s")

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        """Parse the ``;``-separated rules (module docstring); ``delay``
        is an alias of ``delay_s``.  Raises ``ValueError`` on a malformed
        rule or an unknown key."""
        rules = []
        for chunk in spec.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":", 2)
            if len(parts) < 2:
                raise ValueError(f"fault rule needs site:kind: {chunk!r}")
            kw = {"site": parts[0].strip(), "kind": parts[1].strip()}
            if len(parts) == 3 and parts[2].strip():
                for pair in parts[2].split(","):
                    if "=" not in pair:
                        raise ValueError(
                            f"expected key=value in fault rule {chunk!r}, "
                            f"got {pair!r}")
                    key, val = (s.strip() for s in pair.split("=", 1))
                    if key == "delay":
                        key = "delay_s"
                    if key in cls._INT_KEYS:
                        kw[key] = int(val)
                    elif key in cls._FLOAT_KEYS:
                        kw[key] = float(val)
                    elif key == "target":
                        kw[key] = val
                    else:
                        raise ValueError(
                            f"unknown fault-rule key {key!r} in {chunk!r}")
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed)
