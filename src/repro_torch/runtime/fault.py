"""Fault tolerance (port of ``repro.runtime.fault``): a supervised train
loop with periodic commits, a straggler count and restore-and-replay.

  - every ``ckpt_every`` steps the manager commits the state (atomic,
    async writer);
  - a step slower than ``straggler_factor`` x the median (after five
    steps), or than ``deadline_s``, counts as a straggler;
  - on a failure (raised by the step, or injected through
    ``failure_hook``) the supervisor restores the last commit and
    replays from it, at most ``max_restarts`` times. The synthetic
    batches are keyed by step, so the replay sees the same data and
    ends bitwise equal to an uninterrupted run.

Step times are taken after ``torch.cuda.synchronize()`` on a CUDA
device (the reference's ``block_until_ready``).

Under a mesh every rank runs its own supervisor over the same steps, with
a mesh-aware manager (``CheckpointManager(mesh=...)``): the commits,
the manager's waits and a failure injected by step number (the same step
on every rank) happen on all ranks together, so they restore the same
commit and replay together. A real failure on one rank alone is not
handled: the others wait in their next collective until the process
group's timeout.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager


@dataclass
class FaultConfig:
    ckpt_every: int = 50
    deadline_s: float = 300.0
    max_restarts: int = 3
    straggler_factor: float = 3.0   # step > factor x median => straggler


@dataclass
class FaultStats:
    restarts: int = 0
    stragglers: int = 0
    step_times: List[float] = field(default_factory=list)


class Supervisor:
    """Runs (state, step) -> (state, metrics) callables under
    checkpoint / restart semantics."""

    def __init__(self, mgr: CheckpointManager,
                 fcfg: FaultConfig = FaultConfig(),
                 failure_hook: Optional[Callable[[int], bool]] = None,
                 device: Optional[torch.device] = None):
        self.mgr = mgr
        self.fcfg = fcfg
        self.failure_hook = failure_hook or (lambda step: False)
        self.device = device
        self.stats = FaultStats()

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, state: Any, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], Any],
            restore_fn: Callable[[int], Any],
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Any:
        """step_fn(state, step) -> (state, metrics); restore_fn(step) ->
        the state of the commit at ``step``."""
        step = start_step
        while step < n_steps:
            t0 = time.monotonic()
            try:
                if self.failure_hook(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = step_fn(state, step)
                self._sync()
            except Exception:
                if self.stats.restarts >= self.fcfg.max_restarts:
                    raise
                self.stats.restarts += 1
                self.mgr.wait()
                last = self.mgr.latest_step()
                if last is None:
                    raise
                state = restore_fn(last)
                step = last
                continue
            dt = time.monotonic() - t0
            self.stats.step_times.append(dt)
            med = float(np.median(self.stats.step_times))
            if (len(self.stats.step_times) > 5
                    and dt > self.fcfg.straggler_factor * med):
                self.stats.stragglers += 1
            if dt > self.fcfg.deadline_s:
                self.stats.stragglers += 1
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.fcfg.ckpt_every == 0:
                self.mgr.save(step, state)
        self.mgr.wait()
        return state
