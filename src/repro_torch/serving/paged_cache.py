"""Paged KV cache (port of ``repro.serving.paged_cache``): fixed-size
blocks, per-request block tables, and a host-side free-list allocator.

Layout. One pool per layer holds every request's K/V in fixed-size
blocks; the cache is a list with one ``PagedKVCache`` per layer (the
reference stacks the layers on a leading axis instead):

    k, v     (n_blocks, block_size, KV, dh)      cfg.dtype | int8
    k_scale  (n_blocks, block_size, KV) f32      int8 mode only

A request's cache is the logical concatenation of the blocks its
block-table row names: ``block_tables[r, j]`` is the physical block
holding tokens ``[j*block_size, (j+1)*block_size)`` of request ``r``.
Block tables and lengths are small host-side numpy arrays owned by the
scheduler; the engine moves them to the card once per step.

Writes go through ``paged_write``, in place; reads through the
``flash_decode_paged`` kernel.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.common import ArchConfig


class PagedKVCache(NamedTuple):
    """One layer's block pools (families without KV attention don't
    page)."""
    k: torch.Tensor                        # (n_blocks, bs, KV, dh)
    v: torch.Tensor                        # (n_blocks, bs, KV, dh)
    k_scale: Optional[torch.Tensor] = None   # (n_blocks, bs, KV) f32, int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return self.k.shape[0]

    @property
    def block_size(self) -> int:
        return self.k.shape[1]


def paged_cache_axes(cfg: ArchConfig) -> PagedKVCache:
    """Logical axes of one layer's pools (runtime.sharding): blocks are
    never sharded (any request may own any block, so a block split would
    scatter one stream across ranks), while the kv-head dim goes over
    "model" where it divides (each rank serves its heads' pool)."""
    scale_ax = ("kv_blocks", None, "kv_heads") if cfg.kv_quant else None
    ax = ("kv_blocks", None, "kv_heads", None)
    return PagedKVCache(ax, ax, scale_ax, scale_ax)


def init_paged_cache(cfg: ArchConfig, n_blocks: int, block_size: int,
                     device=None) -> List[PagedKVCache]:
    """One zeroed ``PagedKVCache`` per layer; under a mesh, this rank's
    shard of it as ``paged_cache_axes`` places it."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise ValueError(
            f"paged KV serving needs a KV-attention family, not "
            f"{cfg.family!r} (SSM state is O(1) — it doesn't page)")
    shp = (n_blocks, block_size, cfg.n_kv, cfg.d_head)
    from repro_torch.runtime.meshctx import current_mesh
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.runtime.sharding import Planner
        spec = Planner(mesh, cfg).spec(paged_cache_axes(cfg).k, shp)
        shp = tuple(d // mesh.n(() if e is None else (e,))
                    for d, e in zip(shp, spec))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.kv_quant:
        return [PagedKVCache(zeros(shp, torch.int8), zeros(shp, torch.int8),
                             zeros(shp[:-1], torch.float32),
                             zeros(shp[:-1], torch.float32))
                for _ in range(cfg.n_layers)]
    return [PagedKVCache(zeros(shp, cfg.dtype), zeros(shp, cfg.dtype))
            for _ in range(cfg.n_layers)]


def active_rows(active, device) -> torch.Tensor:
    """The indices of the True rows of ``active`` (R,) bool, as a long
    tensor on ``device``. A mask on the host gives them without waiting
    on the card (an asynchronous copy); one on the card waits for it
    (``nonzero``)."""
    if not isinstance(active, torch.Tensor):
        active = torch.as_tensor(np.asarray(active, bool))
    return torch.nonzero(active).reshape(-1).to(device, non_blocking=True)


def paged_write(pool: torch.Tensor, new: torch.Tensor,
                block_ids: torch.Tensor, offsets: torch.Tensor,
                active) -> torch.Tensor:
    """Write one token per active request row into a single-layer pool,
    in place, and return the pool.

    pool (n_blocks, bs, KV, dh) | (n_blocks, bs, KV); new (R, KV, dh) |
    (R, KV); block_ids / offsets (R,) int; active (R,) bool, best on the
    host (see ``active_rows``). Inactive rows write nowhere; active rows
    own distinct slots, so no two writes collide."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    rows = active_rows(active, pool.device)
    flat = pool.view((n_blocks * bs,) + tuple(pool.shape[2:]))
    slots = block_ids.long()[rows] * bs + offsets.long()[rows]
    flat.index_copy_(0, slots, new[rows].to(pool.dtype))
    return pool


class BlockAllocator:
    """Host-side free list over the pool's physical block ids.

    LIFO reuse keeps recently-freed blocks hot. The allocator is
    all-or-nothing: ``alloc(n)`` either returns n block ids or None
    (caller decides to evict/queue) — no partial grants to unwind.

    ``reserve(n)``/``release()`` take free blocks out of circulation
    and put them back — the fault-injection surface for allocator
    pressure (``serving/faults.py`` pool-shrink events). Reserved
    blocks are neither free nor allocated; ``release()`` must be
    called before the end-of-trace leak check ``n_free == n_blocks``
    holds."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._reserved: List[int] = []

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_reserved(self) -> int:
        return len(self._reserved)

    def reserve(self, n: int) -> int:
        """Pull up to ``n`` free blocks out of circulation (pool-shrink
        fault). Returns how many were actually reserved — never more
        than are free, so live streams keep their blocks."""
        if n < 0:
            raise ValueError(f"reserve({n})")
        take = min(n, len(self._free))
        self._reserved.extend(self._free[len(self._free) - take:])
        del self._free[len(self._free) - take:]
        return take

    def release(self, n: Optional[int] = None) -> int:
        """Return ``n`` (default: all) reserved blocks to the free
        list. Returns how many came back."""
        give = len(self._reserved) if n is None else min(
            n, len(self._reserved))
        self._free.extend(self._reserved[len(self._reserved) - give:])
        del self._reserved[len(self._reserved) - give:]
        return give

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1] if n else []
        del self._free[len(self._free) - n:]
        return got

    def free(self, ids: List[int]) -> None:
        for b in ids:
            if not (0 <= b < self.n_blocks):
                raise ValueError(f"free of out-of-range block {b}")
        if set(ids) & set(self._free):
            raise ValueError(f"double free: {set(ids) & set(self._free)}")
        self._free.extend(ids)


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


def table_width(max_len: int, block_size: int) -> int:
    """Block-table columns needed to address ``max_len`` tokens."""
    return max(blocks_needed(max_len, block_size), 1)
