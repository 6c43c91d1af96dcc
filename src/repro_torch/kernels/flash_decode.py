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
"""
from __future__ import annotations

import ctypes
from typing import Optional

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

_P = ctypes.c_void_p
_I = ctypes.c_int
_PAGED_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, _P]
_CONTIG_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                _P]


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


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, lengths,
                             k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version: gather each row's blocks into a contiguous cache,
    masked softmax in fp32; zero-length rows return zeros. Entries of a
    table past its row's length are gathered but never weighted."""
    r, n_bt = block_tables.shape
    bs = k_pool.shape[1]
    ids = block_tables.long().clamp(0, k_pool.shape[0] - 1)

    def rows(pool, scale):
        t = _deq(pool[ids], None if scale is None else scale[ids])
        return t.reshape(r, n_bt * bs, *t.shape[3:])

    k, v = rows(k_pool, k_scale), rows(v_pool, v_scale)
    pos = torch.arange(n_bt * bs, device=q.device)
    valid = pos[None, :] < lengths.long()[:, None]
    out = _attend(q, k, v, valid)
    live = (lengths > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


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
    fn = build.function(FLASH_DECODE_PAGED.source, FLASH_DECODE_PAGED.name,
                        _PAGED_ARGS)
    err = fn(build.dtype_code(q.dtype), int(quant), q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), ksp, vsp,
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), r,
             kv, g, dh, n_blocks, bs, n_bt, build.stream_ptr(dev))
    build.check_launch(err, FLASH_DECODE_PAGED.name,
                       f"R={r} KV={kv} G={g} dh={dh} blocks={n_blocks}x{bs} "
                       f"n_bt={n_bt} int8={quant}")
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
    fn = build.function(FLASH_DECODE.source, FLASH_DECODE.name, _CONTIG_ARGS)
    err = fn(build.dtype_code(q.dtype), int(quant), q.data_ptr(),
             k.data_ptr(), v.data_ptr(), ksp, vsp, lengths.data_ptr(),
             out.data_ptr(), b, kv, g, dh, s, _padded(s, bs) - s,
             build.stream_ptr(dev))
    build.check_launch(err, FLASH_DECODE.name,
                       f"B={b} KV={kv} G={g} dh={dh} S={s} int8={quant}")
    FLASH_DECODE.launches += 1
    return out
