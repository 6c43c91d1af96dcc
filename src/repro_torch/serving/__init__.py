"""Continuous-batching serving engine (port of ``repro.serving``).

The pieces, bottom-up:

  * ``paged_cache`` — the paged/block KV cache: per-layer K/V block
    pools with a per-request block table and a host-side free-list
    allocator (``BlockAllocator``, incl. the ``reserve``/``release``
    fault surface).
  * ``scheduler`` — host-side request scheduler: admits variable-length
    requests mid-flight, interleaves chunked prefill with decode,
    retires finished streams, evicts-with-requeue on block OOM, and
    owns the request lifecycle (statuses, deadlines, load shedding,
    starvation caps).
  * ``faults`` — deterministic fault injection: a seeded ``FaultPlan``
    of step-indexed pool-shrink / forced-NaN / burst / delay events
    the engine consults between steps.
  * ``engine`` — the decode loop: fixed-shape prefill/decode steps
    (``lm.paged_decode_step`` and the ``flash_decode_paged`` CUDA
    kernel) driven over the scheduler's dynamic request state,
    replaying open-loop arrival traces, with a per-row finite-logits
    guard quarantining numerically-dead streams.

Entry point: ``Engine.run(requests)`` or ``python -m
repro_torch.launch.serve --engine``.
"""
from repro_torch.serving.engine import Engine, EngineConfig, summarize
from repro_torch.serving.faults import BurstSpec, FaultEvent, FaultPlan
from repro_torch.serving.paged_cache import (BlockAllocator, PagedKVCache,
                                             init_paged_cache)
from repro_torch.serving.scheduler import (STATUSES, TERMINAL, Request,
                                           Scheduler)

__all__ = ["Engine", "EngineConfig", "summarize", "BurstSpec",
           "FaultEvent", "FaultPlan", "BlockAllocator", "PagedKVCache",
           "init_paged_cache", "STATUSES", "TERMINAL", "Request",
           "Scheduler"]
