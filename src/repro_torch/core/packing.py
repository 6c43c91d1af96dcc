"""Storage packing for SLaB components (port of ``repro.core.packing``):
the formats the CUDA kernels stream from device memory.

- sign bits:  W_B {±1} -> 32-bit words, 32 signs/word along D_in (bit j
              of word g is column 32g+j, a set bit means +1).
- N:M packed: W_S (2:4 / 4:8) -> values (Do, Di/m, n) + int8 positions
              inside each m-group, non-zeros first by position.
- ELL packed: unstructured W_S -> row-padded values (Do, K_max) + column
              ids (kept ids sorted; short rows pad with value 0 at a
              zero column).
- SLaBPacked: one compressed linear's serving bundle (sparse part in
              one of the formats above, u, v, sign words), the input of
              ``kernels.ops.slab_linear_kernel``.

torch has few ops on uint16/uint32, so the unsigned planes are carried
as bit-identical signed views: sign words as int32, ELL ids as int16
(int32 past 65536 columns). ``as_unsigned`` recovers the values.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_ELL_MAX_DIN = 2 ** 16   # uint16 column-id ceiling; wider rows use uint32


def _wrap_signed(a: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> the same bit pattern as a signed
    ``bits``-wide tensor."""
    half, full = 1 << (bits - 1), 1 << bits
    dt = {16: torch.int16, 32: torch.int32}[bits]
    return torch.where(a >= half, a - full, a).to(dt)


def as_unsigned(a: torch.Tensor) -> torch.Tensor:
    """Signed int16/int32 view of an unsigned plane -> its int64 values."""
    mask = {torch.int16: 0xFFFF, torch.int32: 0xFFFFFFFF}[a.dtype]
    return a.long() & mask


# ------------------------------ sign bits ------------------------------

def pack_sign_bits(w_b: torch.Tensor) -> torch.Tensor:
    """Pack ±1 (or bool 'is positive') along the last dim into int32
    words holding the uint32 bit pattern. D_in must divide by 32."""
    d_out, d_in = w_b.shape
    if d_in % 32:
        raise ValueError(f"D_in={d_in} not a multiple of 32")
    pos = (w_b > 0).long().reshape(d_out, d_in // 32, 32)
    shifts = torch.arange(32, device=w_b.device)
    return _wrap_signed((pos << shifts).sum(-1), 32)


def unpack_sign_bits(packed: torch.Tensor, d_in: int,
                     dtype=torch.int8) -> torch.Tensor:
    """Inverse of pack_sign_bits: words -> ±1 matrix (Do, d_in). The
    shift is arithmetic on the int32 view, so the mask follows it."""
    d_out, words = packed.shape
    if words * 32 != d_in:
        raise ValueError(f"{words} words cannot hold D_in={d_in}")
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return (bits * 2 - 1).reshape(d_out, d_in).to(dtype)


# ------------------------------ N:M packing ----------------------------

class NMPacked(NamedTuple):
    values: torch.Tensor    # (Do, Di // m, n)
    indices: torch.Tensor   # (Do, Di // m, n) int8
    n: int
    m: int
    d_in: int


def pack_nm(w_s: torch.Tensor, n: int, m: int,
            strict: bool = False) -> NMPacked:
    """Pack an N:M-sparse dense-masked matrix; groups with fewer than n
    non-zeros pad with (value 0, smallest unused position). ``strict``
    raises if a group holds more than n non-zeros."""
    d_out, d_in = w_s.shape
    if d_in % m:
        raise ValueError(f"D_in={d_in} not divisible by m={m}")
    g = w_s.reshape(d_out, d_in // m, m)
    nz = g != 0
    if strict:
        worst = int(nz.sum(-1).max())
        if worst > n:
            raise ValueError(
                f"matrix is not {n}:{m} sparse (a group holds {worst} "
                f"non-zeros; packing would drop values)")
    ar = torch.arange(m, device=w_s.device)
    order_key = torch.where(nz, ar, m + ar)
    idx = torch.argsort(order_key, dim=-1, stable=True)[..., :n]
    vals = torch.gather(g, -1, idx)
    return NMPacked(vals.to(w_s.dtype), idx.to(torch.int8), n, m, d_in)


def nm_packed_bits(p: NMPacked, bits: int = 16) -> int:
    """Storage cost: values at ``bits`` + ceil(log2(m)) bits per index."""
    idx_bits = max(1, math.ceil(math.log2(p.m)))
    return p.values.numel() * bits + p.indices.numel() * idx_bits


def unpack_nm(p: NMPacked) -> torch.Tensor:
    d_out = p.values.shape[0]
    g = torch.zeros((d_out, p.d_in // p.m, p.m), dtype=p.values.dtype,
                    device=p.values.device)
    g.scatter_add_(-1, p.indices.long(), p.values)
    return g.reshape(d_out, p.d_in)


# ------------------------------ ELL packing ----------------------------

class ELLPacked(NamedTuple):
    values: torch.Tensor    # (Do, K_max)
    indices: torch.Tensor   # (Do, K_max) uint16 ids as int16 (int32 wide)
    d_in: int


def ell_row_nnz_max(w_s: torch.Tensor) -> int:
    """Realized K_max: the largest per-row nnz (host sync)."""
    return max(1, int((w_s != 0).sum(1).max()))


def ell_idx_itemsize(d_in: int) -> int:
    """Bytes per ELL column id: 2 while ids fit 16 bits, else 4."""
    return 2 if d_in <= _ELL_MAX_DIN else 4


def ell_wins_bytes(k_max: int, d_in: int, itemsize: int = 4) -> bool:
    """True when row-padded ELL stores strictly fewer bytes than dense."""
    return k_max * (itemsize + ell_idx_itemsize(d_in)) < d_in * itemsize


def ell_pack(w_s: torch.Tensor, nnz: int | None = None) -> ELLPacked:
    """Keep each row's ``nnz`` largest-magnitude entries (default: the
    realized per-row max): stable argsort on −|w| (zeros last), kept ids
    sorted ascending, pads at zero columns."""
    d_out, d_in = w_s.shape
    if nnz is None:
        nnz = ell_row_nnz_max(w_s)
    keys = torch.where(w_s != 0, -w_s.float().abs(),
                       torch.full((), math.inf, device=w_s.device))
    idx = torch.argsort(keys, dim=1, stable=True)[:, :nnz]
    idx = torch.sort(idx, dim=1).values
    vals = torch.gather(w_s, 1, idx)
    bits = 16 if ell_idx_itemsize(d_in) == 2 else 32
    return ELLPacked(vals, _wrap_signed(idx, bits), d_in)


def ell_unpack(p: ELLPacked) -> torch.Tensor:
    d_out = p.values.shape[0]
    out = torch.zeros((d_out, p.d_in), dtype=p.values.dtype,
                      device=p.values.device)
    return out.scatter_add_(1, as_unsigned(p.indices), p.values)


# --------------------------- SLaB packed bundle ------------------------

class SLaBPacked(NamedTuple):
    """Serving format of one compressed linear: an N:M or ELL sparse part,
    or the dense-masked W_S itself; u / v as (Do,) / (Di,) at rank 1,
    (Do, r) / (Di, r) otherwise; sign words (Do, Di/32)."""
    sparse: "NMPacked | ELLPacked | torch.Tensor"
    u: torch.Tensor
    v: torch.Tensor
    b_packed: torch.Tensor
    d_out: int
    d_in: int


def pack_decomposition(dec, pattern: str | None = None) -> SLaBPacked:
    """Pack a full SLaB decomposition: N:M with ``pattern``, else ELL when
    every row keeps the same count (the (1, D_in) comparison group), else
    the dense-masked W_S."""
    from repro_torch.core import sparsity as sp
    d_out, d_in = dec.w_s.shape
    if pattern is not None:
        n, m = sp.parse_pattern(pattern)
        sparse = pack_nm(dec.w_s, n, m)
    else:
        nnz = sp.mask_nnz_per_row_uniform(dec.w_s != 0)
        sparse = ell_pack(dec.w_s, nnz) if nnz is not None else dec.w_s
    u = dec.u[:, 0] if dec.u.dim() == 2 and dec.u.shape[1] == 1 else dec.u
    v = dec.v[:, 0] if dec.v.dim() == 2 and dec.v.shape[1] == 1 else dec.v
    return SLaBPacked(sparse, u, v, pack_sign_bits(dec.w_b), d_out, d_in)
