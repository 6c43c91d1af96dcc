"""GQA attention (port of ``repro.models.attention``): the query-chunked
full-sequence path and the single-token decode path against a
preallocated KV cache. Logits and softmax are fp32; probabilities are
cast to the model dtype before the value contraction, as in the
reference.

The decode path writes the new token's K/V into the cache tensors in
place (the reference returns fresh arrays); ``KVCache.length`` is a host
int, one write offset for the whole batch. The paged path (the serving
engine's) carries per-row lengths as a device tensor instead and writes
into a block pool, also in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.packed_model import linear
from repro_torch.models.common import ArchConfig, dense_init, rotate
from repro_torch.runtime.meshctx import (current_mesh, gather_model,
                                         lse_combine, model_shards)

NEG_INF = -1e30


def attention_axes() -> dict:
    """Logical axes of the attention params (runtime.sharding)."""
    return {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv"),
        "wv": ("embed", "kv"),
        "wo": ("heads", "embed"),
    }


def init_attention(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.d_q), d, cfg.dtype, device),
        "wk": dense_init(gen, (d, cfg.d_kv), d, cfg.dtype, device),
        "wv": dense_init(gen, (d, cfg.d_kv), d, cfg.dtype, device),
        "wo": dense_init(gen, (cfg.d_q, d), cfg.d_q, cfg.dtype, device),
    }


def multihead_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                        positions: torch.Tensor,
                        first=None) -> torch.Tensor:
    """Full-sequence attention, query-chunked. x (B, S, D) -> (B, S, D);
    positions (B, S), or (B, S, 3) under M-RoPE. Causal unless
    ``cfg.causal`` is False (the audio encoder). The mask reads the
    position ids of the batch's first row for every row, as the
    reference does; where x holds a rank's rows of a larger batch,
    ``first`` is row 0 of that batch's positions."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    g = h // kv
    q = linear(x, p["wq"], tap="wq").reshape(b, s, h, dh)
    k = linear(x, p["wk"], tap="wk").reshape(b, s, kv, dh)
    v = linear(x, p["wv"], tap="wv").reshape(b, s, kv, dh)
    q = rotate(cfg, q, positions)
    k = rotate(cfg, k, positions)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    q = q * (dh ** -0.5)

    cq = min(cfg.q_chunk, s)
    if s % cq:
        cq = s
    kv_pos = torch.arange(s, device=x.device)
    # the mask compares a query's position id (under M-RoPE its t id) with
    # the key's index, as the reference does
    row0 = (positions[0] if first is None
            else torch.as_tensor(first, device=x.device))
    qpos_rows = row0[..., 0] if row0.dim() == 2 else row0
    kf = k.float()
    outs = []
    for c0 in range(0, s, cq):
        qc = q[:, c0:c0 + cq]
        logits = torch.einsum("bqhd,bshd->bhqs", qc.float(), kf)
        if cfg.causal:
            mask = qpos_rows[c0:c0 + cq, None] >= kv_pos[None, :]
            logits = logits.masked_fill(~mask[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, s, cfg.d_q)
    return linear(out, p["wo"], tap="wo")


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, Kv, dh) in cfg.dtype, or int8
    v: torch.Tensor     # (B, S_max, Kv, dh)
    length: int         # tokens currently valid (one offset for the batch)
    k_scale: Optional[torch.Tensor] = None   # (B, S_max, Kv) f32, int8 only
    v_scale: Optional[torch.Tensor] = None
    # under a mesh whose "model" axis shards the positions (kv_seq): the
    # first position this rank holds; None for a whole cache
    seq_lo: Optional[int] = None


def kv_cache_axes(cfg: ArchConfig) -> KVCache:
    """Batch over data, cached sequence over model: each model rank holds
    a slice of the positions, and the softmax combines across ranks
    (``runtime.meshctx.lse_combine``)."""
    scale_ax = ("batch", "kv_seq", None) if cfg.kv_quant else None
    return KVCache(("batch", "kv_seq", None, None),
                   ("batch", "kv_seq", None, None), (),
                   scale_ax, scale_ax)


def init_kv_cache(cfg: ArchConfig, batch: int, s_max: int,
                  device=None) -> KVCache:
    """The empty cache of ``batch`` rows. Under a mesh whose planner puts
    "kv_seq" on "model" (s_max divisible), this rank's slice of the
    positions only (the caller has split the rows already)."""
    lo = None
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.runtime.sharding import Planner
        if Planner(mesh, cfg).act_spec("kv_seq", shape=(s_max,))[0]:
            n = mesh.shape["model"]
            s_max //= n
            lo = mesh.index(("model",)) * s_max
    shp = (batch, s_max, cfg.n_kv, cfg.d_head)
    if cfg.kv_quant:
        sshp = shp[:-1]
        return KVCache(torch.zeros(shp, dtype=torch.int8, device=device),
                       torch.zeros(shp, dtype=torch.int8, device=device), 0,
                       torch.zeros(sshp, dtype=torch.float32, device=device),
                       torch.zeros(sshp, dtype=torch.float32, device=device),
                       lo)
    return KVCache(torch.zeros(shp, dtype=cfg.dtype, device=device),
                   torch.zeros(shp, dtype=cfg.dtype, device=device), 0,
                   seq_lo=lo)


def _quantize_token(t: torch.Tensor):
    """(..., Kv, dh) -> int8 payload + (..., Kv) f32 scale: per (token,
    head) absmax / 127, at least 1e-8; round half to even, as jnp.round."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     cache: KVCache, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token step. x (B, 1, D); positions (B, 1), or (B, 1, 3) under
    M-RoPE.

    int8 mode: the cache is stored and read as int8; the per-(token,
    head) scales are folded into the scores and the probabilities, so no
    dequantized copy of the cache is formed (the reference's
    arithmetic)."""
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.d_head
    q = linear(x, p["wq"], tap="wq").reshape(b, s, cfg.n_heads, dh)
    k_new = linear(x, p["wk"], tap="wk").reshape(b, s, kv, dh)
    v_new = linear(x, p["wv"], tap="wv").reshape(b, s, kv, dh)
    q = rotate(cfg, q, positions)
    k_new = rotate(cfg, k_new, positions)
    if cache.seq_lo is not None:
        out = _split_decode(cfg, q, k_new, v_new, cache)
        return (linear(out, p["wo"], tap="wo"),
                cache._replace(length=cache.length + s))

    idx = cache.length
    if cfg.kv_quant:
        k_q, k_s = _quantize_token(k_new)
        v_q, v_s = _quantize_token(v_new)
        cache.k[:, idx:idx + s] = k_q
        cache.v[:, idx:idx + s] = v_q
        cache.k_scale[:, idx:idx + s] = k_s
        cache.v_scale[:, idx:idx + s] = v_s
    else:
        cache.k[:, idx:idx + s] = k_new.to(cache.k.dtype)
        cache.v[:, idx:idx + s] = v_new.to(cache.v.dtype)
    new_cache = cache._replace(length=idx + s)

    q = q.reshape(b, s, kv, g, dh) * (dh ** -0.5)
    kk = cache.k.to(cfg.dtype) if cfg.kv_quant else cache.k
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), kk.float())
    if cfg.kv_quant:
        logits = logits * cache.k_scale.permute(0, 2, 1)[:, :, None, None, :]
    valid = torch.arange(cache.k.shape[1], device=x.device) <= idx
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if cfg.kv_quant:
        probs = probs * cache.v_scale.permute(0, 2, 1)[:, :, None, None, :]
    probs = probs.to(cfg.dtype)
    vv = cache.v.to(cfg.dtype) if cfg.kv_quant else cache.v
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vv)
    out = out.reshape(b, s, cfg.d_q)
    return linear(out, p["wo"], tap="wo"), new_cache


def _split_decode(cfg: ArchConfig, q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """``decode_attention`` on this rank's slice of the positions,
    [seq_lo, seq_lo + S_l): the new tokens written where they fall in it,
    the scores of its positions, and the softmax and the weighted V
    combined across the "model" ranks (the reference's split softmax,
    explicit). Its arithmetic is the single device's: probabilities
    normalised in f32 (int8: times the V scales), rounded to cfg.dtype,
    then weighed against V at cfg.dtype, accumulated in f32 and rounded
    once. Returns the attention output (B, S, d_q)."""
    b, s = q.shape[:2]
    kv, g, dh = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.d_head
    idx, lo, s_l = cache.length, cache.seq_lo, cache.k.shape[1]
    a, e = max(idx, lo), min(idx + s, lo + s_l)
    if a < e:
        if cfg.kv_quant:
            k_q, k_s = _quantize_token(k_new)
            v_q, v_s = _quantize_token(v_new)
            cache.k_scale[:, a - lo:e - lo] = k_s[:, a - idx:e - idx]
            cache.v_scale[:, a - lo:e - lo] = v_s[:, a - idx:e - idx]
            k_new, v_new = k_q, v_q
        cache.k[:, a - lo:e - lo] = k_new[:, a - idx:e - idx].to(
            cache.k.dtype)
        cache.v[:, a - lo:e - lo] = v_new[:, a - idx:e - idx].to(
            cache.v.dtype)
    q = q.reshape(b, s, kv, g, dh) * (dh ** -0.5)
    kk = cache.k.to(cfg.dtype) if cfg.kv_quant else cache.k
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), kk.float())
    if cfg.kv_quant:
        logits = logits * cache.k_scale.permute(0, 2, 1)[:, :, None, None, :]
    valid = lo + torch.arange(s_l, device=q.device) <= idx
    logits = logits.masked_fill(~valid, NEG_INF)
    vv = (cache.v.to(cfg.dtype) if cfg.kv_quant else cache.v).float()

    def weigh_v(pr):
        if cfg.kv_quant:
            pr = pr * cache.v_scale.permute(0, 2, 1)[:, :, None, None, :]
        pr = pr.to(cfg.dtype).float()
        return torch.einsum("bkgqs,bskd->bkgqd", pr, vv)

    out = lse_combine(logits, weigh_v)                    # (B,kv,g,S,dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, cfg.d_q).to(cfg.dtype)


def paged_decode_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, pool,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           positions: torch.Tensor, active: torch.Tensor):
    """One-token decode against a paged KV cache (one layer's pool).

    x (R, 1, D); pool a single-layer ``serving.paged_cache.PagedKVCache``
    (k/v (n_blocks, bs, KV, dh)); block_tables (R, n_bt) int32; lengths
    (R,) int32 tokens already cached per row (also the write position);
    active (R,) bool, on the host or on x's device: inactive rows write
    nothing and read nothing. Returns (out (R, 1, D), pool); the pool is
    updated in place.

    The new token's K/V go to block ``block_tables[r, len // bs]`` at
    offset ``len % bs``; attention then reads the whole stream through
    the block table with the ``flash_decode_paged`` kernel, int8
    included. Under a mesh whose planner split the pool's kv heads over
    "model", each rank writes and reads its heads and the heads' outputs
    are gathered."""
    from repro_torch.kernels import ops
    from repro_torch.serving.paged_cache import paged_write
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.d_head
    q = linear(x, p["wq"], tap="wq").reshape(b, s, cfg.n_heads, dh)
    k_new = linear(x, p["wk"], tap="wk").reshape(b, s, kv, dh)
    v_new = linear(x, p["wv"], tap="wv").reshape(b, s, kv, dh)
    q = rotate(cfg, q, positions)
    k_new = rotate(cfg, k_new, positions)

    kv_l = pool.k.shape[2]
    if kv_l != kv:                  # this rank's kv heads of the pool
        h0 = model_shards()[0] * kv_l
        k_new, v_new = k_new[:, :, h0:h0 + kv_l], v_new[:, :, h0:h0 + kv_l]
        q = q[:, :, h0 * g:(h0 + kv_l) * g]
    bs_blk = pool.block_size
    n_bt = block_tables.shape[1]
    # physical write slot; the clamp shields idle rows with stale
    # lengths (their write is dropped by ``active`` anyway)
    col = torch.clamp(lengths // bs_blk, 0, n_bt - 1).long()
    blk = torch.gather(block_tables, 1, col[:, None])[:, 0]
    off = lengths % bs_blk
    if cfg.kv_quant:
        k_q, k_s = _quantize_token(k_new)
        v_q, v_s = _quantize_token(v_new)
        paged_write(pool.k, k_q[:, 0], blk, off, active)
        paged_write(pool.v, v_q[:, 0], blk, off, active)
        paged_write(pool.k_scale, k_s[:, 0], blk, off, active)
        paged_write(pool.v_scale, v_s[:, 0], blk, off, active)
    else:
        paged_write(pool.k, k_new[:, 0], blk, off, active)
        paged_write(pool.v, v_new[:, 0], blk, off, active)

    qg = q[:, 0].reshape(b, kv_l, g, dh) * (dh ** -0.5)
    act = torch.as_tensor(active).to(x.device, non_blocking=True)
    att_len = torch.where(act, lengths + 1, 0).to(torch.int32)
    out = ops.flash_decode_paged_attention(
        qg.contiguous(), pool.k, pool.v, block_tables, att_len,
        pool.k_scale, pool.v_scale)
    if kv_l != kv:
        out = gather_model(out, dim=1)
    out = out.reshape(b, 1, cfg.d_q).to(x.dtype)
    return linear(out, p["wo"], tap="wo"), pool
