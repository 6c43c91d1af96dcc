"""Deterministic fault injection for the serving engine (a copy of
``repro.serving.faults``).

A ``FaultPlan`` is an immutable schedule of fault events keyed on the
ENGINE STEP COUNTER (``Engine.n_steps`` — which also advances on idle
iterations under ``clock="steps"``), consulted by ``Engine.run``
between steps. Four event kinds, each exercising one recovery path:

  pool_shrink   reserve ``n_blocks`` free blocks out of the allocator
                (``BlockAllocator.reserve``) — allocator pressure that
                forces evict-with-recompute-replay and admission
                stalls. ``pool_restore`` gives them back.
  nan           force the step's logits to NaN on the named
                rows for that step — drives the per-row finite-logits
                guard: retry-via-eviction once, then quarantine.
  burst         submit a burst of synthetic requests mid-trace
                (arrival = now) — load-shedding / deadline pressure.
                Bursts are stored as prompt SPECS and materialized
                into fresh ``Request`` objects at fire time, so the
                same plan replayed over a fresh trace reproduces
                byte-identical results (the seed-determinism
                invariant).
  delay         sleep before the step — straggler/jitter injection for
                wall-clock goodput benchmarks (a no-op for the
                deterministic steps clock).

The plan itself holds no mutable firing state: the engine tracks which
events it has consumed, so one ``FaultPlan`` can drive any number of
runs. ``FaultPlan.chaos(seed, ...)`` builds a randomized-but-seeded
mix of all four kinds; the same seed always builds the same plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request

#: rid base for burst-injected requests — out of the way of any sane
#: user trace so per-rid bookkeeping never collides.
BURST_RID_BASE = 1_000_000


@dataclasses.dataclass(frozen=True)
class BurstSpec:
    """One synthetic burst request: materialized at fire time."""
    rid: int
    prompt: Tuple[int, ...]
    max_new: int
    ttl: Optional[float] = None         # deadline = fire-time now + ttl

    def materialize(self, now: float) -> Request:
        return Request(
            rid=self.rid, prompt=np.asarray(self.prompt, np.int32),
            max_new=self.max_new, arrival=now,
            deadline=None if self.ttl is None else now + self.ttl)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str                           # see module docstring
    rows: Tuple[int, ...] = ()          # nan
    n_blocks: int = 0                   # pool_shrink / pool_restore
    bursts: Tuple[BurstSpec, ...] = ()  # burst
    delay_s: float = 0.0                # delay

    KINDS = ("nan", "pool_shrink", "pool_restore", "burst", "delay")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"fault kind {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"fault step {self.step}")


class FaultPlan:
    """Immutable, step-indexed fault schedule (see module docstring)."""

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.seed = seed
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.KINDS.index(e.kind))))
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    def events_at(self, step: int) -> List[FaultEvent]:
        return self._by_step.get(step, [])

    def nan_rows(self, step: int) -> Tuple[int, ...]:
        """All rows whose logits are forced non-finite at ``step``."""
        return tuple(r for ev in self.events_at(step) if ev.kind == "nan"
                     for r in ev.rows)

    def has_restore_after(self, step: int) -> bool:
        """True while a pool_restore is still scheduled past ``step`` —
        an apparent admission stall may heal itself, so the engine must
        not diagnose it as permanent yet."""
        return any(ev.kind == "pool_restore" and ev.step > step
                   for ev in self.events)

    @property
    def max_step(self) -> int:
        return max((ev.step for ev in self.events), default=-1)

    def __repr__(self):
        kinds = {}
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        body = " ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        return f"FaultPlan(seed={self.seed}, {body or 'empty'})"

    # -- canned chaos ------------------------------------------------------

    @classmethod
    def chaos(cls, seed: int, vocab: int, n_rows: int,
              horizon: int = 40, n_nan: int = 2, shrink_blocks: int = 2,
              n_burst: int = 2, burst_prompt: int = 6, burst_new: int = 3,
              delay_s: float = 0.0) -> "FaultPlan":
        """A randomized-but-seeded mix of every fault kind inside the
        first ``horizon`` engine steps: one pool shrink (restored half
        a horizon later), ``n_nan`` forced-NaN (step, row) pairs with a
        follow-up hit two steps later on one of them (so at least one
        stream exhausts its single retry and quarantines when the
        replay lands back on the same row), one ``n_burst``-request
        arrival burst, and an optional per-step delay."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        lo, hi = max(horizon // 8, 1), max(horizon // 2, 2)
        if shrink_blocks > 0:
            at = int(rng.integers(lo, hi))
            events.append(FaultEvent(step=at, kind="pool_shrink",
                                     n_blocks=shrink_blocks))
            events.append(FaultEvent(step=at + horizon // 2,
                                     kind="pool_restore"))
        for i in range(n_nan):
            step = int(rng.integers(lo, horizon))
            row = int(rng.integers(0, n_rows))
            events.append(FaultEvent(step=step, kind="nan", rows=(row,)))
            if i == 0:
                events.append(FaultEvent(step=step + 2, kind="nan",
                                         rows=(row,)))
        if n_burst > 0:
            specs = tuple(BurstSpec(
                rid=BURST_RID_BASE + i,
                prompt=tuple(int(t) for t in rng.integers(
                    0, vocab, size=burst_prompt)),
                max_new=burst_new) for i in range(n_burst))
            events.append(FaultEvent(step=int(rng.integers(lo, hi)),
                                     kind="burst", bursts=specs))
        if delay_s > 0:
            for step in range(lo, horizon, max(horizon // 4, 1)):
                events.append(FaultEvent(step=step, kind="delay",
                                         delay_s=delay_s))
        return cls(events, seed=seed)
