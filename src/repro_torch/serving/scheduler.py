"""Request scheduler for the continuous-batching engine (a copy of
``repro.serving.scheduler``: pure numpy and Python, host-side).

All state here is host-side and cheap: the scheduler owns the slot
table (fixed R request slots = the engine's batch rows), the block
allocator, and the per-slot block-table / length mirrors that are
moved to the card once per step. Policy:

  admission   arrived requests enter a FIFO waiting queue; free slots
              are filled in queue order (earliest arrival first) any
              time between steps — streams join the running batch
              mid-flight.
  prefill     prompts are consumed in chunks of ``prefill_chunk``
              tokens; while any slot is prefilling, decode rows ride
              along in the same fused step (one token each), so running
              streams keep emitting during admissions.
  retirement  a stream that has produced ``max_new`` tokens retires
              immediately: blocks freed, slot reusable the same step.
  eviction    block-pool OOM evicts the *most recently admitted*
              running request (LIFO victim — earliest arrivals are
              never starved), frees its blocks, and requeues it at the
              front of the waiting queue with ``prompt + generated`` as
              its new prompt (recompute-style preemption: greedy decode
              is deterministic, so the replay continues the stream
              exactly). A request whose worst-case footprint exceeds
              the whole pool is REJECTED at submit time (status
              ``rejected``, never queued), so the highest-priority
              request can always run alone.

Fault tolerance (the lifecycle layer):

  statuses    every request carries a ``status``:
              queued -> running -> finished, with terminal failure
              statuses rejected / timeout / failed / shed. Eviction
              moves a request back to ``queued``. Terminal requests
              keep whatever partial ``out`` they produced.
  deadlines   ``Request.deadline`` is an absolute stamp on the run's
              clock; ``expire(now)`` times out queued *and* running
              requests past it (running rows free their blocks).
  starvation  a request evicted more than ``max_evictions`` times
              fails as starved instead of thrashing forever.
  shedding    ``max_waiting`` bounds the waiting queue; an arrival
              that would overflow it is shed (``shed="reject"``) or
              displaces the oldest waiting entry
              (``shed="evict-oldest-waiting"``).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged_cache import (BlockAllocator,
                                             blocks_needed, table_width)

#: request lifecycle states. queued/running are live; the rest are
#: terminal (a terminal request is never touched again).
STATUSES = ("queued", "running", "finished", "rejected", "timeout",
            "failed", "shed")
TERMINAL = frozenset(STATUSES) - {"queued", "running"}


@dataclasses.dataclass
class Request:
    """One stream: a prompt and a greedy-decode budget."""
    rid: int
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new: int
    arrival: float = 0.0
    deadline: Optional[float] = None    # absolute, on the run's clock

    # filled by the engine ------------------------------------------------
    status: str = "queued"
    error: Optional[str] = None         # terminal diagnostic (failures)
    out: List[int] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None        # first-token time - arrival
    finish: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    n_evictions: int = 0
    n_nan_retries: int = 0              # non-finite-logits replays used

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new={self.max_new}")

    @property
    def n_generated(self) -> int:
        return len(self.out)

    @property
    def done(self) -> bool:
        return self.n_generated >= self.max_new

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    def serve_prompt(self) -> np.ndarray:
        """Prompt to (re)prefill: original prompt plus everything
        generated so far (recompute preemption continues the stream)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])

    def max_cached_tokens(self) -> int:
        """Worst-case cache footprint: every fed token. The final
        generated token is emitted but never fed back."""
        return len(self.prompt) + self.max_new - 1


@dataclasses.dataclass
class _Slot:
    req: Request
    blocks: List[int]
    n_prefilled: int                    # serve_prompt tokens already fed
    admit_seq: int                      # LIFO eviction order
    phase: str                          # "prefill" | "decode"
    next_token: int = -1                # decode: last sampled, to feed


class Scheduler:
    def __init__(self, n_slots: int, n_blocks: int, block_size: int,
                 max_len: int, prefill_chunk: int = 8,
                 max_waiting: Optional[int] = None, shed: str = "reject",
                 max_evictions: int = 8):
        if n_slots < 1 or n_blocks < 1 or prefill_chunk < 1:
            raise ValueError((n_slots, n_blocks, prefill_chunk))
        if shed not in ("reject", "evict-oldest-waiting"):
            raise ValueError(f"shed={shed!r}")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting={max_waiting}")
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_len = max_len
        self.n_bt = table_width(max_len, block_size)
        self.prefill_chunk = prefill_chunk
        self.max_waiting = max_waiting
        self.shed = shed
        self.max_evictions = max_evictions
        self.alloc = BlockAllocator(n_blocks)
        self.pending: List[Request] = []         # submitted, not arrived
        self.waiting: List[Request] = []         # arrived, no slot
        self.slots: Dict[int, _Slot] = {}        # row -> slot state
        self.block_table = np.zeros((n_slots, self.n_bt), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._admit_seq = 0
        self.n_evictions = 0

    # -- lifecycle ---------------------------------------------------------

    def _finalize(self, req: Request, status: str,
                  error: Optional[str] = None,
                  now: Optional[float] = None) -> Request:
        assert status in TERMINAL, status
        req.status = status
        req.error = error
        if now is not None:
            req.finish = now
        return req

    # -- submission / admission ------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request. Unservable requests are REJECTED with
        ``status="rejected"`` (never queued) instead of raising, so one
        bad request cannot kill a trace. Returns True iff queued."""
        if req.terminal:
            return False
        need = req.max_cached_tokens()
        if need > self.max_len:
            self._finalize(req, "rejected", error=(
                f"{need} cached tokens exceeds engine "
                f"max_len={self.max_len}"))
            return False
        if blocks_needed(need, self.block_size) > self.alloc.n_blocks:
            self._finalize(req, "rejected", error=(
                f"needs {blocks_needed(need, self.block_size)} blocks, "
                f"pool has {self.alloc.n_blocks} — cannot ever run"))
            return False
        req.status = "queued"
        bisect.insort(self.pending, req, key=lambda r: r.arrival)
        return True

    def expire(self, now: float) -> List[Request]:
        """Time out every live request whose deadline has passed:
        queued requests leave their queue, running requests free their
        blocks and slot. Partial ``out`` is kept. Returns the newly
        timed-out requests."""
        def late(r: Request) -> bool:
            return r.deadline is not None and now >= r.deadline

        timed: List[Request] = []
        for q in (self.pending, self.waiting):
            for req in [r for r in q if late(r)]:
                q.remove(req)
                timed.append(self._finalize(
                    req, "timeout", now=now,
                    error=f"deadline {req.deadline} passed at {now}"))
        for row in [r for r in self.slots if late(self.slots[r].req)]:
            req = self._release(row)
            timed.append(self._finalize(
                req, "timeout", now=now,
                error=f"deadline {req.deadline} passed at {now}"))
        return timed

    def _shed_overflow(self) -> List[Request]:
        """Enforce the ``max_waiting`` bound on the post-admission
        backlog: overflow is shed from the BACK (newest arrivals) under
        ``shed="reject"``, from the FRONT (longest waiting) under
        ``"evict-oldest-waiting"``. Returns the shed requests."""
        shed: List[Request] = []
        if self.max_waiting is None:
            return shed
        while len(self.waiting) > self.max_waiting:
            if self.shed == "reject":
                shed.append(self._finalize(self.waiting.pop(), "shed",
                            error=(f"waiting queue full "
                                   f"(max_waiting={self.max_waiting})")))
            else:
                shed.append(self._finalize(self.waiting.pop(0), "shed",
                            error=(f"displaced: oldest of an "
                                   f"over-full waiting queue "
                                   f"(max_waiting={self.max_waiting})")))
        return shed

    def admit(self, now: float) -> List[int]:
        """Move arrived requests into free slots; shed waiting-queue
        overflow. Returns filled rows."""
        while self.pending and self.pending[0].arrival <= now:
            self.waiting.append(self.pending.pop(0))
        filled = []
        for row in range(self.n_slots):
            if not self.waiting:
                break
            if row in self.slots:
                continue
            # admission control: only admit when the full prompt fits in
            # currently-free blocks — an admit that would immediately
            # OOM just evicts itself back (thrash)
            nxt = self.waiting[0]
            if (blocks_needed(len(nxt.serve_prompt()), self.block_size)
                    > self.alloc.n_free):
                break
            req = self.waiting.pop(0)
            req.status = "running"
            self.slots[row] = _Slot(req=req, blocks=[], n_prefilled=0,
                                    admit_seq=self._admit_seq,
                                    phase="prefill")
            self._admit_seq += 1
            self.block_table[row, :] = 0
            self.lengths[row] = 0
            filled.append(row)
        self._shed_overflow()
        return filled

    # -- block accounting -------------------------------------------------

    def _capacity(self, row: int) -> int:
        return len(self.slots[row].blocks) * self.block_size

    def _grow(self, row: int, target_tokens: int) -> bool:
        """Allocate blocks until ``row`` can cache ``target_tokens``;
        on pool OOM evict LIFO victims (never ``row`` itself unless it
        IS the newest). Returns False if ``row`` was evicted instead."""
        slot = self.slots[row]
        while self._capacity(row) < target_tokens:
            n_need = blocks_needed(target_tokens, self.block_size) \
                - len(slot.blocks)
            got = self.alloc.alloc(n_need)
            if got is not None:
                for b in got:
                    self.block_table[row, len(slot.blocks)] = b
                    slot.blocks.append(b)
                return True
            victim = max(self.slots, key=lambda r: self.slots[r].admit_seq)
            self.evict(victim)
            if victim == row:
                return False
        return True

    def _release(self, row: int) -> Request:
        """Free ``row``'s blocks and slot; caller sets the status."""
        slot = self.slots.pop(row)
        self.alloc.free(slot.blocks)
        self.block_table[row, :] = 0
        self.lengths[row] = 0
        return slot.req

    def evict(self, row: int) -> None:
        """Preempt ``row``: free its blocks, requeue front-of-line.
        A request past its eviction budget is finalized as starved
        (status ``failed``) instead of requeued — N replays that never
        stick are thrash, not progress."""
        req = self._release(row)
        req.n_evictions += 1
        self.n_evictions += 1
        if req.n_evictions > self.max_evictions:
            self._finalize(req, "failed", error=(
                f"starved: evicted {req.n_evictions} times "
                f"(max_evictions={self.max_evictions})"))
            return
        # decode rows hold a sampled-but-unfed token: fold it into the
        # replayed prompt so nothing is lost (it was already emitted)
        req.status = "queued"
        self.waiting.insert(0, req)

    def fail(self, row: int, error: str,
             now: Optional[float] = None) -> Request:
        """Quarantine ``row``: free its blocks, finalize as failed.
        Partial ``out`` survives; neighbors are untouched."""
        return self._finalize(self._release(row), "failed", error=error,
                              now=now)

    def retire(self, row: int, now: float) -> Request:
        return self._finalize(self._release(row), "finished", now=now)

    # -- step planning ----------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.slots or self.waiting or self.pending)

    def next_arrival(self) -> Optional[float]:
        return self.pending[0].arrival if self.pending else None

    def diagnose_stall(self) -> Optional[str]:
        """Why the head of the waiting queue cannot be admitted —
        ``None`` when it could be (or nothing waits)."""
        if not self.waiting:
            return None
        nxt = self.waiting[0]
        need = blocks_needed(len(nxt.serve_prompt()), self.block_size)
        if need <= self.alloc.n_free:
            return None
        return (f"rid={nxt.rid} blocked: prompt of "
                f"{len(nxt.serve_prompt())} tokens needs {need} blocks, "
                f"{self.alloc.n_free}/{self.alloc.n_blocks} free"
                + (f" ({self.alloc.n_reserved} reserved)"
                   if self.alloc.n_reserved else ""))

    def plan_step(self) -> Optional[Tuple[np.ndarray, np.ndarray, bool]]:
        """Build this step's fixed-shape batch.

        Returns (tokens (R, C), n_valid (R,), any_prefill) or None when
        no slot can run. Prefill rows consume up to ``prefill_chunk``
        prompt tokens; decode rows ride along with one token
        (``any_prefill`` False means every row is decode — the engine
        uses its C=1 step). Rows the allocator had to evict drop out of
        the batch (n_valid 0)."""
        any_prefill = any(s.phase == "prefill" for s in self.slots.values())
        c = self.prefill_chunk if any_prefill else 1
        tokens = np.zeros((self.n_slots, c), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        # LIFO-victim eviction: grow highest-priority rows first so a
        # victim's freed blocks serve earlier arrivals, not later ones
        rows = sorted(self.slots, key=lambda r: self.slots[r].admit_seq)
        for row in rows:
            if row not in self.slots:        # evicted by an earlier grow
                continue
            slot = self.slots[row]
            if slot.phase == "prefill":
                prompt = slot.req.serve_prompt()
                take = min(c, len(prompt) - slot.n_prefilled)
                if not self._grow(row, self.lengths[row] + take):
                    continue
                tokens[row, :take] = prompt[
                    slot.n_prefilled:slot.n_prefilled + take]
                n_valid[row] = take
            else:
                if not self._grow(row, self.lengths[row] + 1):
                    continue
                tokens[row, 0] = slot.next_token
                n_valid[row] = 1
        if not n_valid.any():
            return None
        return tokens, n_valid, any_prefill

    def commit_step(self, n_valid: np.ndarray, sampled: np.ndarray,
                    now: float) -> List[Request]:
        """Advance slot state after a step. ``sampled`` (R,) is each
        row's greedy token at its last valid position. Returns retired
        requests."""
        retired = []
        for row in list(self.slots):
            took = int(n_valid[row])
            if not took:
                continue
            slot = self.slots[row]
            self.lengths[row] += took
            if slot.phase == "prefill":
                slot.n_prefilled += took
                if slot.n_prefilled < len(slot.req.serve_prompt()):
                    continue                 # more prompt to feed
                slot.phase = "decode"
            tok = int(sampled[row])
            req = slot.req
            if req.ttft is None:
                req.ttft = now - req.arrival
            req.out.append(tok)
            req.token_times.append(now)
            slot.next_token = tok
            if req.done:
                retired.append(self.retire(row, now))
        return retired
