"""Flash-decode: grouped-query single-token attention against a KV cache
in the model dtype or int8 — the hand-written CUDA kernels
(``csrc/flash_decode.cu``) and their plain PyTorch versions.

    out (R, KV, G, dh) = softmax(q · Kᵀ) · V   per (row, kv head),
    over the first lengths[r] cached tokens; q pre-scaled by 1/√dh

``flash_decode_paged`` reads K/V through per-row block tables from a
pool of (n_blocks, bs, KV, dh) blocks (the serving engine's paged
cache); ``flash_decode`` reads a contiguous (B, S, KV, dh) cache. In
int8 mode K/V come with f32 scales (…, KV) per (token, head).

Replace ``repro/kernels/flash_decode.py::{flash_decode_paged,
flash_decode}`` (TPU), whose outputs at length 0 differ: the paged
kernel skips every chunk and returns zeros; the contiguous one never
skips a chunk and returns the mean of V over S padded to its chunk
(``bs`` = min(bs, S)), padding slots counted as zeros. Both versions
here reproduce that.

The kernels split each row's tokens across blocks (flash-decoding):
``head_chunk`` and ``plan_splits`` pick the query heads a block takes
and the tokens a split covers from shapes alone — never from
``lengths``, so a launch never waits on the card — and a second kernel
merges a row's splits. ``split_attend_plain`` is that arithmetic in
plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

FLASH_DECODE_PAGED = build.CudaKernel(
    "flash_decode_paged", "flash_decode.cu",
    "src/repro/kernels/flash_decode.py:188 (flash_decode_paged, "
    "pallas_call :236)")
FLASH_DECODE = build.CudaKernel(
    "flash_decode", "flash_decode.cu",
    "src/repro/kernels/flash_decode.py:85 (flash_decode, pallas_call :130)")

NEG_INF = -1e30
MAX_DH = 256        # head width the kernel takes (any G)
# csrc/flash_decode.cu's constants: tokens a tile (splits are whole
# tiles), query-head x 8-column units a block holds (kMaxUnits), query
# heads a block (kMaxHeads) and splits a row (kMaxSplits)
TILE = 32
MAX_UNITS = 512
MAX_HEADS = 64
MAX_SPLITS = 1024
# A row's splits are no shorter than MIN_SPLIT tokens, and a launch aims
# for SPLIT_BLOCKS_PER_SM blocks an SM at full lengths (chosen by timing
# chip_smoke's shapes on the H100: PERF.md §6).
MIN_SPLIT = 128
SPLIT_BLOCKS_PER_SM = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_PAGED_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
               _I, _I, _I, _I, _I, _I, _P]
_CONTIG_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, _P]


def head_chunk(g: int, dh: int) -> int:
    """Query heads one block takes: all G while G x dh_pad / 8 fits
    MAX_UNITS (and MAX_HEADS), else G cut into equal chunks."""
    units = -(-dh // 16) * 2                      # dh padded to 16, / 8
    most = max(1, min(MAX_UNITS // units, MAX_HEADS))
    n = -(-g // most)
    return -(-g // n)


def plan_splits(rows: int, kv: int, n_chunks: int, n_max: int,
                n_sm: int) -> Tuple[int, int]:
    """(n_split, split_len): split each row's n_max token slots into
    n_split runs of split_len tokens (a multiple of TILE; the last run may
    be shorter), enough that rows x kv x n_chunks x n_split blocks give
    SPLIT_BLOCKS_PER_SM blocks to each of n_sm SMs, but no run shorter
    than MIN_SPLIT unless the row is. From shapes only: a split that
    starts past its row's length does nothing."""
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // max(rows * kv * n_chunks, 1))
    n = max(1, min(want, n_max // MIN_SPLIT, MAX_SPLITS))
    split_len = -(-n_max // n)
    split_len = -(-split_len // TILE) * TILE
    return -(-n_max // split_len), split_len


_sm_count = build.sm_count


def _plan(dev, rows, kv, g, dh, n_max):
    """(gc, n_split, split_len, scratch or None) of one launch."""
    gc = head_chunk(g, dh)
    n_split, split_len = plan_splits(rows, kv, -(-g // gc), n_max,
                                     _sm_count(dev.index or 0))
    part = None
    if n_split > 1:
        part = torch.empty(rows * kv * g * n_split * (dh + 2),
                           dtype=torch.float32, device=dev)
    return gc, n_split, split_len, part


def _deq(t: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 copy of a cache plane, times its per-(token, head) scale."""
    t = t.float()
    return t if scale is None else t * scale.float()[..., None]


def _attend(q, k, v, valid) -> torch.Tensor:
    """Masked softmax attention in fp32: q (R, KV, G, dh), k / v
    (R, S, KV, dh) fp32, valid (R, S) -> (R, KV, G, dh) fp32."""
    logits = torch.einsum("rkgd,rskd->rkgs", q.float(), k)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    v = v.masked_fill(~valid[:, :, None, None], 0.0)
    return torch.einsum("rkgs,rskd->rkgd", p, v)


def gather_rows(pool, scale, block_tables) -> torch.Tensor:
    """fp32 (R, n_bt · bs, KV, dh) copy of each row's blocks of a pool
    (ids clamped to it), times the per-(token, head) scale if given."""
    r, n_bt = block_tables.shape
    ids = block_tables.long().clamp(0, pool.shape[0] - 1)
    t = _deq(pool[ids], None if scale is None else scale[ids])
    return t.reshape(r, n_bt * pool.shape[1], *t.shape[3:])


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, lengths,
                             k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version: gather each row's blocks into a contiguous cache,
    masked softmax in fp32; zero-length rows return zeros. Entries of a
    table past its row's length are gathered but never weighted."""
    k = gather_rows(k_pool, k_scale, block_tables)
    v = gather_rows(v_pool, v_scale, block_tables)
    n_max = k.shape[1]
    pos = torch.arange(n_max, device=q.device)
    valid = pos[None, :] < lengths.long()[:, None]
    out = _attend(q, k, v, valid)
    live = (lengths > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


def split_attend_plain(q, k, v, lengths, split_len: int, pad_count: int = 0,
                       skip_empty: bool = True) -> torch.Tensor:
    """The kernels' split-then-combine arithmetic in plain PyTorch (fp32
    out), for the CPU tests. k / v (R, N, KV, dh) fp32, dequantized. Split
    i covers tokens [i·split_len, (i+1)·split_len) of a row's first n_proc
    = min(length, N) — all N on a length-0 row unless ``skip_empty`` —
    with masked scores past the length; each live split gives (m, l, acc),
    merged in split order: out = Σ c_i acc_i / (Σ c_i l_i + pad_count ·
    e^(-1e30 - m)), c_i = e^(m_i - m), m = max_i m_i."""
    n = k.shape[1]
    lens = lengths.long().to(q.device)
    n_proc = torch.where(lens > 0, lens.clamp(max=n),
                         torch.zeros_like(lens) if skip_empty
                         else torch.full_like(lens, n))
    logits = torch.einsum("rkgd,rskd->rkgs", q.float(), k)
    pos = torch.arange(n, device=q.device)
    scored = (pos[None, :] < lens[:, None])[:, None, None, :]
    live = (pos[None, :] < n_proc[:, None])[:, None, None, :]
    s = torch.where(scored, logits, torch.full_like(logits, NEG_INF))
    ms, ls, accs = [], [], []
    for t0 in range(0, n, split_len):
        sl = slice(t0, min(t0 + split_len, n))
        si, li = s[..., sl], live[..., sl]
        m = torch.where(li, si, NEG_INF).amax(-1)
        p = torch.where(li, torch.exp(si - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("rkgs,rskd->rkgd", p, v[:, sl]))
    m_i, l_i = torch.stack(ms, -1), torch.stack(ls, -1)
    starts = torch.arange(len(ms), device=q.device) * split_len
    on = (starts[None, :] < n_proc[:, None])[:, None, None, :]
    m_i = torch.where(on, m_i, NEG_INF)
    m = m_i.amax(-1)
    c = torch.where(on, torch.exp(m_i - m[..., None]), 0.0)
    norm = (c * l_i).sum(-1) + pad_count * torch.exp(NEG_INF - m)
    acc = torch.einsum("rkgi,irkgd->rkgd", c, torch.stack(accs))
    return acc / norm.clamp_min(1e-30)[..., None]


def _padded(s: int, bs: int) -> int:
    """S rounded up to the reference's chunk, bs = min(bs, S)."""
    bs = min(bs, s)
    return -(-s // bs) * bs


def flash_decode_plain(q, k, v, lengths, k_scale=None, v_scale=None,
                       bs: int = 512) -> torch.Tensor:
    """Plain version of the contiguous kernel: masked softmax in fp32 for
    rows with tokens; a length-0 row returns Σ_s V[s] / S_pad, the TPU
    kernel's uniform weights over its padded span."""
    s = k.shape[1]
    kf, vf = _deq(k, k_scale), _deq(v, v_scale)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lengths.long()[:, None]
    out = _attend(q, kf, vf, valid)
    mean = vf.sum(dim=1) / _padded(s, bs)              # (B, KV, dh)
    empty = mean[:, :, None, :].expand_as(out)
    live = (lengths > 0)[:, None, None, None]
    return torch.where(live, out, empty).to(q.dtype)


def _check_cache(q, k, v, k_scale, v_scale, lead):
    """Shared operand checks; returns (quant, scale pointers)."""
    dev = q.device
    r, kv, g, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}, expected float32/bfloat16")
    if dh > MAX_DH:
        raise ValueError(f"dh={dh}: the kernel takes head widths up to "
                         f"{MAX_DH} (any number of query heads)")
    build.check_operand(q, "q", q.dtype, (r, kv, g, dh), dev)
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("give both k_scale and v_scale, or neither")
    kd = torch.int8 if quant else q.dtype
    build.check_operand(k, "k", kd, (*lead, kv, dh), dev)
    build.check_operand(v, "v", kd, (*lead, kv, dh), dev)
    if quant:
        build.check_operand(k_scale, "k_scale", torch.float32, (*lead, kv),
                            dev)
        build.check_operand(v_scale, "v_scale", torch.float32, (*lead, kv),
                            dev)
        return True, k_scale.data_ptr(), v_scale.data_ptr()
    return False, None, None


def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """Launch the paged CUDA kernel on PyTorch's current stream. Block ids
    out of [0, n_blocks) are clamped (never read past the pool)."""
    r, kv, g, dh = q.shape
    n_blocks, bs = k_pool.shape[0], k_pool.shape[1]
    n_bt = block_tables.shape[1]
    dev = q.device
    quant, ksp, vsp = _check_cache(q, k_pool, v_pool, k_scale, v_scale,
                                   (n_blocks, bs))
    build.check_operand(block_tables, "block_tables", torch.int32,
                        (r, n_bt), dev)
    build.check_operand(lengths, "lengths", torch.int32, (r,), dev)
    out = torch.empty_like(q)
    if r == 0:
        return out
    gc, n_split, split_len, part = _plan(dev, r, kv, g, dh, n_bt * bs)
    fn = build.function(FLASH_DECODE_PAGED.source, FLASH_DECODE_PAGED.name,
                        _PAGED_ARGS)
    err = fn(build.dtype_code(q.dtype), int(quant), q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), ksp, vsp,
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), r, kv, g, dh,
             n_blocks, bs, n_bt, gc, split_len, n_split,
             build.stream_ptr(dev))
    build.check_launch(err, FLASH_DECODE_PAGED.name,
                       f"R={r} KV={kv} G={g} dh={dh} blocks={n_blocks}x{bs} "
                       f"n_bt={n_bt} int8={quant} splits={n_split}x"
                       f"{split_len}")
    FLASH_DECODE_PAGED.launches += 1
    return out


def flash_decode(q, k, v, lengths, k_scale=None, v_scale=None,
                 bs: int = 512) -> torch.Tensor:
    """Launch the contiguous CUDA kernel on PyTorch's current stream.
    ``bs`` is the reference's chunk: it only sets the padded span a
    length-0 row averages over. Lengths must not exceed S."""
    b, kv, g, dh = q.shape
    s = k.shape[1]
    dev = q.device
    quant, ksp, vsp = _check_cache(q, k, v, k_scale, v_scale, (b, s))
    build.check_operand(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    if b == 0:
        return out
    if s == 0:
        raise ValueError("an empty cache (S = 0)")
    gc, n_split, split_len, part = _plan(dev, b, kv, g, dh, s)
    fn = build.function(FLASH_DECODE.source, FLASH_DECODE.name, _CONTIG_ARGS)
    err = fn(build.dtype_code(q.dtype), int(quant), q.data_ptr(),
             k.data_ptr(), v.data_ptr(), ksp, vsp, lengths.data_ptr(),
             out.data_ptr(), None if part is None else part.data_ptr(), b,
             kv, g, dh, s, _padded(s, bs) - s, gc, split_len, n_split,
             build.stream_ptr(dev))
    build.check_launch(err, FLASH_DECODE.name,
                       f"B={b} KV={kv} G={g} dh={dh} S={s} int8={quant} "
                       f"splits={n_split}x{split_len}")
    FLASH_DECODE.launches += 1
    return out
