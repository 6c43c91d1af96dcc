"""Continuous-batching decode engine (port of ``repro.serving.engine``):
fixed-shape steps over dynamic request state.

The engine owns R fixed request slots (the batch rows of every step), a
paged KV cache sized in blocks, and a ``Scheduler``. Each iteration of
``run``:

  1. consult the ``FaultPlan`` (if any): pool-shrink/restore, arrival
     bursts, artificial delays, forced-NaN rows for this step;
  2. expire past-deadline requests, then admit arrived requests into
     free slots (mid-flight — running streams are untouched);
  3. ask the scheduler for this step's batch: prefill rows consume up
     to ``prefill_chunk`` prompt tokens, decode rows ride along with
     one token each (Orca-style fused iteration). Pure-decode steps run
     one token position;
  4. run ONE step: a loop over the chunk's token positions, each a
     ``lm.paged_decode_step`` (every attention through the
     ``flash_decode_paged`` kernel), with per-row validity masks, and a
     per-row finite-logits flag. Where the reference jits this step
     (two compilations, C and 1), the port runs it eagerly;
  5. quarantine rows that went non-finite (retry once via the
     recompute-replay eviction path, then fail them — neighbors in the
     fused batch never see it), sample greedily at each surviving
     row's last valid position, hand tokens back to the scheduler
     (TTFT / latency bookkeeping, retirement), and loop.

``run`` never raises on a valid trace: unservable submissions come
back ``rejected``, deadline misses ``timeout``, ``max_steps``
exhaustion marks everything unfinished ``timeout`` with partial
``out``, and a permanently-stalled admission queue fails the blocked
head with a block-accounting diagnosis instead of spinning.

Open-loop traces: requests carry ``arrival`` stamps; ``clock="steps"``
replays them against the engine-step counter (deterministic — tests),
``clock="wall"`` against wall time (benchmarks).

Under a mesh (``mesh=``, as ``serve --mesh`` builds it) the pools are
placed by ``paged_cache_axes`` (kv heads over "model"; never over data,
so every data rank runs every row) and the steps run on each rank's
shards. The scheduler reads a wall clock, deadlines and a fault plan, so
it runs on rank 0 alone: each step rank 0 broadcasts the step's block
tables, lengths, tokens, valid counts and poisoned rows, and the other
ranks run that step (``run`` there returns when rank 0's trace ends).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.runtime.meshctx import use_mesh
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.paged_cache import init_paged_cache
from repro_torch.serving.scheduler import Request, Scheduler

#: graceful backstop for pathological admit/evict cycles the stall
#: diagnosis cannot prove permanent — finalizes instead of raising.
IDLE_LIMIT = 100_000


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4              # R: concurrent streams (batch rows)
    n_blocks: int = 64            # KV pool size, in blocks
    block_size: int = 16          # tokens per block
    max_len: int = 256            # per-stream cap (prompt + gen - 1)
    prefill_chunk: int = 8        # prompt tokens per prefill step
    max_waiting: Optional[int] = None   # waiting-queue bound (None: ∞)
    shed: str = "reject"          # "reject" | "evict-oldest-waiting"
    max_evictions: int = 8        # evictions before a stream starves
    max_nan_retries: int = 1      # non-finite replays before quarantine


class Engine:
    """Continuous-batching greedy-decode engine over a paged KV cache.

    ``params`` may be dense, SLaB-compressed dense-equivalent, or packed
    (``PackedLinear`` leaves — the CUDA-kernel serving path). Runs on the
    CUDA card unless ``device="cpu"``; the params must live there. Under
    ``mesh`` they are this rank's shards (``runtime.sharding``)."""

    def __init__(self, cfg: ArchConfig, params: dict,
                 ecfg: EngineConfig = EngineConfig(), device=None,
                 mesh=None):
        if cfg.family in lm.NO_PAGED_DECODE:
            raise ValueError(
                f"engine serves KV-attention families; {cfg.family!r} "
                "has no paged cache")
        self.device = resolve_device(device)
        lm.check_params_on(params, self.device, "the engine")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.sched = Scheduler(ecfg.n_slots, ecfg.n_blocks,
                               ecfg.block_size, ecfg.max_len,
                               ecfg.prefill_chunk,
                               max_waiting=ecfg.max_waiting,
                               shed=ecfg.shed,
                               max_evictions=ecfg.max_evictions)
        self.mesh = mesh
        with use_mesh(mesh):
            self.paged = init_paged_cache(cfg, ecfg.n_blocks,
                                          ecfg.block_size, device=self.device)
        self.n_steps = 0

    # -- one step ----------------------------------------------------------

    @torch.no_grad()
    def _step(self, tables: torch.Tensor, lengths: torch.Tensor,
              tokens: torch.Tensor, n_valid: np.ndarray,
              force_nan: np.ndarray):
        """The fused prefill/decode step over ``c = tokens.shape[1]``
        token positions; row r is live at position t iff t < n_valid[r].
        Returns the greedy token at each row's LAST valid position and a
        per-row all-positions-finite flag (``force_nan`` poisons the
        chosen rows' logits — the fault-injection hook). The pools
        update in place."""
        dev = self.device
        r = tokens.shape[0]
        nv = torch.from_numpy(n_valid).to(dev, non_blocking=True)
        poison = (torch.from_numpy(force_nan).to(dev)[:, None, None]
                  if force_nan.any() else None)
        last = torch.zeros(r, dtype=torch.long, device=dev)
        ok = torch.ones(r, dtype=torch.bool, device=dev)
        lens = lengths
        for t in range(tokens.shape[1]):
            active_h = torch.from_numpy(t < n_valid)      # host mask
            active = active_h.to(dev, non_blocking=True)
            logits, _ = lm.paged_decode_step(
                self.cfg, self.params, self.paged, tables, lens,
                tokens[:, t:t + 1], active_h)
            if poison is not None:
                logits = logits.masked_fill(poison, float("nan"))
            ok = ok & (torch.isfinite(logits[:, 0]).all(dim=-1) | ~active)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            last = torch.where(nv - 1 == t, nxt, last)
            lens = lens + active.to(lens.dtype)
        return last, ok

    def _run_step(self, tokens: np.ndarray, n_valid: np.ndarray,
                  force_nan: np.ndarray):
        """Move the scheduler's tables, lengths and tokens to the card
        (once per step, without waiting on it), run the step, and bring
        back the sampled tokens and finite flags. Under a mesh the step's
        arrays go to the other ranks first."""
        tables, lengths = self.sched.block_table, self.sched.lengths
        if self.mesh is not None:
            self._send(tables, lengths, tokens, n_valid, force_nan)
        return self._device_step(tables, lengths, tokens, n_valid,
                                 force_nan)

    def _device_step(self, tables, lengths, tokens, n_valid, force_nan):
        def dev(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        with use_mesh(self.mesh):
            last, ok = self._step(dev(tables), dev(lengths), dev(tokens),
                                  n_valid, force_nan)
        return last.cpu().numpy().astype(np.int32), ok.cpu().numpy()

    # -- rank 0 leads, the other ranks follow -----------------------------

    def _bcast(self, a: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.mesh.comm_device())
        return self.mesh.broadcast(t, src=0).cpu().numpy()

    def _send(self, tables, lengths, tokens, n_valid, force_nan) -> None:
        r, c = tokens.shape
        self._bcast(np.array([1, r, c, tables.shape[1]]))
        self._bcast(np.concatenate([tables.ravel(), lengths, tokens.ravel(),
                                    n_valid, force_nan.astype(np.int64)]))

    def _follow(self) -> None:
        """Run rank 0's steps until it ends its trace."""
        while True:
            go, r, c, n_bt = self._bcast(np.zeros(4, np.int64)).tolist()
            if not go:
                return
            body = self._bcast(np.zeros(r * (n_bt + c + 3), np.int64))
            parts = np.split(body, np.cumsum([r * n_bt, r, r * c, r]))
            self._device_step(parts[0].reshape(r, n_bt).astype(np.int32),
                              parts[1].astype(np.int32),
                              parts[2].reshape(r, c).astype(np.int32),
                              parts[3].astype(np.int32),
                              parts[4].astype(bool))

    # -- fault plumbing ----------------------------------------------------

    def _fire_faults(self, faults: Optional[FaultPlan], fired: set,
                     now: float, injected: List[Request]) -> None:
        """Apply every not-yet-fired plan event due at/by this step."""
        if faults is None:
            return
        for i, ev in enumerate(faults.events):
            if i in fired or ev.step > self.n_steps:
                continue
            fired.add(i)
            if ev.kind == "pool_shrink":
                self.sched.alloc.reserve(ev.n_blocks)
            elif ev.kind == "pool_restore":
                self.sched.alloc.release(
                    ev.n_blocks if ev.n_blocks else None)
            elif ev.kind == "burst":
                for spec in ev.bursts:
                    req = spec.materialize(now)
                    self.sched.submit(req)
                    injected.append(req)
            elif ev.kind == "delay":
                time.sleep(ev.delay_s)
            # "nan" events are consumed by nan_rows() at step-run time

    def _quarantine_nonfinite(self, n_valid: np.ndarray, ok: np.ndarray,
                              now: float) -> None:
        """Handle rows whose logits went non-finite this step: the
        garbage token is never committed; the row is replayed once via
        the recompute eviction path, then failed. Other rows in the
        fused batch are untouched."""
        for row in [r for r in list(self.sched.slots)
                    if n_valid[r] and not ok[r]]:
            req = self.sched.slots[row].req
            if req.n_nan_retries < self.ecfg.max_nan_retries:
                req.n_nan_retries += 1
                self.sched.evict(row)
            else:
                self.sched.fail(row, now=now, error=(
                    f"non-finite logits at step {self.n_steps} "
                    f"(after {req.n_nan_retries} replay(s))"))

    # -- serving loop ------------------------------------------------------

    def _finalize_unfinished(self, status: str, error: str,
                             now: float) -> None:
        """Graceful shutdown: everything still live gets ``status``
        with partial ``out`` — nothing is discarded, nothing raises."""
        for row in list(self.sched.slots):
            req = self.sched._release(row)
            self.sched._finalize(req, status, error=error, now=now)
        for q in (self.sched.waiting, self.sched.pending):
            while q:
                self.sched._finalize(q.pop(0), status, error=error,
                                     now=now)

    def run(self, requests: Sequence[Request], clock: str = "steps",
            max_steps: Optional[int] = None,
            faults: Optional[FaultPlan] = None) -> List[Request]:
        """Serve an open-loop trace to completion. Returns the requests
        (same objects) with ``status``/``out``/``ttft``/``token_times``
        /``finish`` populated — plus any burst requests ``faults``
        injected — and never raises on a valid trace: failures are
        statuses, not exceptions. Arrival order need not be sorted.
        Under a mesh only rank 0 serves the trace; the other ranks run its
        steps and return ``requests`` untouched."""
        if clock not in ("steps", "wall"):
            raise ValueError(clock)
        if self.mesh is not None and self.mesh.rank != 0:
            self._follow()
            return list(requests)
        try:
            return self._serve(requests, clock, max_steps, faults)
        finally:
            if self.mesh is not None:
                self._bcast(np.zeros(4, np.int64))       # the end

    def _serve(self, requests, clock, max_steps, faults) -> List[Request]:
        for req in requests:
            self.sched.submit(req)       # unservable -> status rejected
        injected: List[Request] = []
        fired: set = set()
        t0 = time.monotonic()
        idle_guard = 0
        while self.sched.has_work():
            now = (float(self.n_steps) if clock == "steps"
                   else time.monotonic() - t0)
            self._fire_faults(faults, fired, now, injected)
            self.sched.expire(now)
            self.sched.admit(now)
            plan = self.sched.plan_step()
            if plan is None:
                if not self.sched.has_work():
                    break                # expiry drained the trace
                nxt = self.sched.next_arrival()
                idle_guard += 1
                heal = (faults is not None
                        and faults.has_restore_after(self.n_steps))
                if (heal and clock == "wall" and nxt is None
                        and not self.sched.slots):
                    # dead idle on the wall clock never advances
                    # n_steps, so a step-indexed restore would never
                    # fire — fast-forward it instead of sleeping on it
                    for i, ev in enumerate(faults.events):
                        if ev.kind == "pool_restore" and i not in fired:
                            fired.add(i)
                            self.sched.alloc.release(
                                ev.n_blocks if ev.n_blocks else None)
                    continue
                if (nxt is None and not self.sched.slots
                        and self.sched.waiting and not heal):
                    # permanent stall: nothing runs, nothing arrives,
                    # no scheduled restore — fail the blocked head with
                    # the block accounting, keep serving the rest
                    diag = self.sched.diagnose_stall() or (
                        "admission stalled with free blocks")
                    self.sched._finalize(self.sched.waiting.pop(0),
                                         "failed", error=diag, now=now)
                    continue
                if idle_guard > IDLE_LIMIT:
                    diag = self.sched.diagnose_stall()
                    self._finalize_unfinished(
                        "failed", f"idle-loop livelock after "
                        f"{IDLE_LIMIT} iterations"
                        + (f": {diag}" if diag else ""), now)
                    break
                if clock == "steps":
                    self.n_steps += 1
                else:
                    time.sleep(min(1e-3, max(nxt - now, 0.0) if nxt
                                   else 1e-3))
                continue
            idle_guard = 0
            tokens, n_valid, _ = plan
            force_nan = np.zeros((self.sched.n_slots,), bool)
            if faults is not None:
                for row in faults.nan_rows(self.n_steps):
                    force_nan[row] = True
            last, ok = self._run_step(tokens, n_valid, force_nan)
            self.n_steps += 1
            emit_t = (float(self.n_steps) if clock == "steps"
                      else time.monotonic() - t0)
            self._quarantine_nonfinite(n_valid, ok, emit_t)
            self.sched.commit_step(n_valid, last, emit_t)
            if max_steps is not None and self.n_steps >= max_steps:
                self._finalize_unfinished(
                    "timeout", f"max_steps={max_steps} exhausted",
                    emit_t)
                break
        # faults are scoped to the run: any still-reserved blocks come
        # back so the pool-leak invariant (n_free == n_blocks once all
        # streams are terminal) holds at trace end
        self.sched.alloc.release()
        return list(requests) + injected


# ----------------------------------------------------------------------
# Metrics
# ----------------------------------------------------------------------

def summarize(requests: Sequence[Request], wall_s: float) -> dict:
    """Aggregate serving metrics over a completed trace: TTFT and
    inter-token latency percentiles (units = the run's clock),
    aggregate generated tokens/s, per-status counts, and goodput —
    tokens/s counting only tokens of requests that FINISHED (partial
    output of timed-out/failed streams is waste, not goods)."""
    ttfts = [r.ttft for r in requests if r.ttft is not None]
    inter: List[float] = []
    for r in requests:
        ts = r.token_times
        inter.extend(b - a for a, b in zip(ts, ts[1:]))
    n_tok = sum(r.n_generated for r in requests)
    n_good = sum(r.n_generated for r in requests
                 if r.status == "finished")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    return {
        "n_requests": len(requests),
        "n_tokens_out": n_tok,
        "wall_s": wall_s,
        "tokens_per_s": n_tok / wall_s if wall_s > 0 else 0.0,
        "goodput_tokens_per_s": n_good / wall_s if wall_s > 0 else 0.0,
        "statuses": dict(Counter(r.status for r in requests)),
        "ttft": {"p50": pct(ttfts, 50), "p95": pct(ttfts, 95),
                 "p99": pct(ttfts, 99)},
        "per_token_latency": {"p50": pct(inter, 50), "p95": pct(inter, 95),
                              "p99": pct(inter, 99)},
        "n_evictions": sum(r.n_evictions for r in requests),
    }
