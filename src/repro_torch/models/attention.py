"""GQA attention (port of ``repro.models.attention``): the query-chunked
full-sequence path and the single-token decode path against a
preallocated KV cache. Logits and softmax are fp32; probabilities are
cast to the model dtype before the value contraction, as in the
reference.

The decode path writes the new token's K/V into the cache tensors in
place (the reference returns fresh arrays); ``KVCache.length`` is a host
int, one write offset for the whole batch.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.packed_model import linear
from repro_torch.models.common import ArchConfig, dense_init, rotate

NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.d_q), d, cfg.dtype, device),
        "wk": dense_init(gen, (d, cfg.d_kv), d, cfg.dtype, device),
        "wv": dense_init(gen, (d, cfg.d_kv), d, cfg.dtype, device),
        "wo": dense_init(gen, (cfg.d_q, d), cfg.d_q, cfg.dtype, device),
    }


def multihead_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention, query-chunked. x (B, S, D) -> (B, S, D)."""
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
    qpos_rows = positions[0]
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
    k: torch.Tensor     # (B, S_max, Kv, dh) in cfg.dtype
    v: torch.Tensor     # (B, S_max, Kv, dh)
    length: int         # tokens currently valid (one offset for the batch)


def init_kv_cache(cfg: ArchConfig, batch: int, s_max: int,
                  device=None) -> KVCache:
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    shp = (batch, s_max, cfg.n_kv, cfg.d_head)
    return KVCache(torch.zeros(shp, dtype=cfg.dtype, device=device),
                   torch.zeros(shp, dtype=cfg.dtype, device=device), 0)


def decode_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     cache: KVCache, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token step. x (B, 1, D); positions (B, 1)."""
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.d_head
    q = linear(x, p["wq"], tap="wq").reshape(b, s, cfg.n_heads, dh)
    k_new = linear(x, p["wk"], tap="wk").reshape(b, s, kv, dh)
    v_new = linear(x, p["wv"], tap="wv").reshape(b, s, kv, dh)
    q = rotate(cfg, q, positions)
    k_new = rotate(cfg, k_new, positions)

    idx = cache.length
    cache.k[:, idx:idx + s] = k_new.to(cache.k.dtype)
    cache.v[:, idx:idx + s] = v_new.to(cache.v.dtype)
    new_cache = KVCache(cache.k, cache.v, idx + s)

    q = q.reshape(b, s, kv, g, dh) * (dh ** -0.5)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), cache.k.float())
    valid = torch.arange(cache.k.shape[1], device=x.device) <= idx
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache.v)
    out = out.reshape(b, s, cfg.d_q)
    return linear(out, p["wo"], tap="wo"), new_cache
