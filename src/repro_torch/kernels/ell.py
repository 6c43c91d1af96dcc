"""Row-padded ELL linears: the hand-written CUDA kernels and their plain
PyTorch versions. W_S streams as vals (N, K_max) + column ids (N, K_max):

    ell_matmul       y = x @ W_Sᵀ
    ell_lr_matmul    y = x @ W_Sᵀ + (x @ Vᵀ) @ U        (fp32 projection)
    slab_ell_matmul  y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r

Replace ``repro/kernels/ell.py::{ell_matmul, ell_lr_matmul,
slab_ell_matmul}`` (TPU). Operands use the kernel layout: x (M, K),
u (R, N), v (R, K); ``kernels.ops`` maps the public layouts onto it.

Each has two libraries under one C name, each counting its launches on
its own ``CudaKernel``: the split gather of ``csrc/grouped_tc.cu`` (bf16
from a row crossover where x fits a block, each row's entries split
across blocks by ``slab_matmul.plan_ell_splits``) and the first design
of ``csrc/ell.cu`` (f32, fewer rows, wider K); ``ell_kernel`` /
``slab_ell_kernel`` / ``ell_lr_kernel`` pick one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import as_unsigned
from repro_torch.kernels import build
from repro_torch.kernels import slab_matmul as slab_k
from repro_torch.kernels.common import binlr_term, lowrank_term

_SLAB_ELL_TPU = ("src/repro/kernels/ell.py:191 (slab_ell_matmul, "
                 "pallas_call :209)")
SLAB_ELL = build.CudaKernel("slab_ell_matmul", "grouped_tc.cu",
                            _SLAB_ELL_TPU)
SLAB_ELL_FIRST = build.CudaKernel("slab_ell_matmul", "ell.cu", _SLAB_ELL_TPU,
                                  key="slab_ell_matmul@ell.cu")
_ELL_TPU = "src/repro/kernels/ell.py:92 (ell_matmul, pallas_call :105)"
ELL = build.CudaKernel("ell_matmul", "grouped_tc.cu", _ELL_TPU)
ELL_FIRST = build.CudaKernel("ell_matmul", "ell.cu", _ELL_TPU,
                             key="ell_matmul@ell.cu")
_ELL_LR_TPU = "src/repro/kernels/ell.py:134 (ell_lr_matmul, pallas_call :149)"
ELL_LR = build.CudaKernel("ell_lr_matmul", "grouped_tc.cu", _ELL_LR_TPU)
ELL_LR_FIRST = build.CudaKernel("ell_lr_matmul", "ell.cu", _ELL_LR_TPU,
                                key="ell_lr_matmul@ell.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_ELL_ARGS = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_ELL_LR_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# grouped_tc.cu's slab_ell_matmul and ell_lr_matmul also take the split's
# scratch (part, tickets) and plan (n_split, entries per split; #1 also
# chunks per split)
_SLAB_ELL_TC_ARGS = [_I, _I] + [_P] * 9 + [_I] * 8 + [_P]
_ELL_LR_TC_ARGS = [_I, _I] + [_P] * 8 + [_I] * 7 + [_P]
_ELL_TC_ARGS = [_I, _I] + [_P] * 6 + [_I] * 6 + [_P]

# The bf16 slab_ell_matmul, ell_lr_matmul and ell_matmul run
# grouped_tc.cu's split gather from these many rows (chip_smoke.py's M
# sweep through each library at (4096, 4096), PERF.md) where
# ell_split_smem fits an H100 block; fewer rows, f32 and wider K run the
# first design. #1's split
# library wins from M 2; at M 1 the two are within ~20 % either way
# (PERF.md §6 records the first design ahead in most runs), and 1 keeps
# phase l's one-row decode steps on the split library. #5's first design
# is faster at M 1 and 2 (no ±1 term to amortise the split's fixed cost);
# #4's, with neither term, at M 1 only (its split library is ~3 % ahead
# at M 2).
SLAB_ELL_TC_MIN_ROWS = 1
ELL_LR_TC_MIN_ROWS = 3
ELL_TC_MIN_ROWS = 2
RING_STEPS = 4       # grouped_tc.cu's kEllStages
THREADS = 256        # ... and kEllThreads


def ell_split_smem(k: int, r: int, idx_bytes: int,
                   binary: bool = False) -> int:
    """Shared bytes of grouped_tc.cu's ell_split_kernel at one tile of 8
    batch rows (its ell_split_smem at one n-tile): x as ell_kp(K) 16-byte
    columns and the gather's cp.async ring (4 steps of 8-entry blocks for
    each of 256 threads: 16 bytes of vals and 16 per 8 uint16 ids); for
    #1 (``binary``) the ±1 sums of 128 rows in fp32, with the ring
    sharing its bytes with the bf16 x ⊙ v_r tiles of the widest split
    (slab_matmul.NM_MAX_SPLIT_CHUNKS chunks plus 8 columns) and u of 128
    rows; otherwise, for a rank-``r`` projection (#5, #13; r 0 for #12),
    its sums (r, 8) and the 8 warps' partial sums in fp32; with r 0 (#4,
    #12) x and the ring alone."""
    kp = (k + 8) // 8 * 8
    ring = RING_STEPS * (1 + idx_bytes // 2) * THREADS * 16
    if binary:
        sx = min(-(-k // slab_k.CHUNK), slab_k.NM_MAX_SPLIT_CHUNKS) \
            * slab_k.CHUNK + 8
        tiles = r * 8 * sx * 2 + r * slab_k.ROWS * 2
        return kp * 16 + 8 * 16 * 8 * 4 + -(-max(ring, tiles) // 16) * 16
    return kp * 16 + ring + -(-r * 8 * 4 // 16) * 16 + 8 * r * 8 * 4


def _dense_of(vals, idx, k: int) -> torch.Tensor:
    """Scatter the ELL rows to a dense fp32 (N, K) W_S."""
    w = torch.zeros((vals.shape[0], k), dtype=torch.float32,
                    device=vals.device)
    return w.scatter_add_(1, as_unsigned(idx), vals.float())


def _check_ell(x, vals, idx):
    """Shared operand checks of the ELL kernels; returns (m, k, n, k_max)."""
    m, k = x.shape
    n, k_max = vals.shape
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    build.check_operand(vals, "vals", x.dtype, (n, k_max), dev)
    if idx.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"ELL ids must be int16/int32 views, not {idx.dtype}")
    build.check_operand(idx, "idx", idx.dtype, (n, k_max), dev)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    return m, k, n, k_max


def ell_matmul_plain(x, vals, idx) -> torch.Tensor:
    """Plain version: dense rebuild of W_S, fp32 matmul; returns x.dtype."""
    y = x.float() @ _dense_of(vals, idx, x.shape[1]).T
    return y.to(x.dtype)


def ell_kernel(dtype, m: int, k: int,
               idx_bytes: int = 2) -> build.CudaKernel:
    """The library a launch at ``m`` rows, ``k`` columns and ids of
    ``idx_bytes`` runs: grouped_tc.cu for bf16 from ELL_TC_MIN_ROWS rows
    where ell_split_smem (x and the ring) fits an H100 block; f32 (1e-5,
    no TF32), fewer rows and wider K the first design."""
    if dtype == torch.bfloat16 and m >= ELL_TC_MIN_ROWS \
            and ell_split_smem(k, 0, idx_bytes) <= slab_k.TC_SMEM:
        return ELL
    return ELL_FIRST


def ell_matmul(x, vals, idx) -> torch.Tensor:
    """Launch the ELL CUDA kernel on PyTorch's current stream."""
    m, k = x.shape
    return launch_ell(ell_kernel(x.dtype, m, k, idx.element_size()), x,
                      vals, idx)


def launch_ell(kern, x, vals, idx) -> torch.Tensor:
    """ell_matmul through ``kern``'s library (ELL or ELL_FIRST), counted
    on its counter."""
    m, k, n, k_max = _check_ell(x, vals, idx)
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} K_max={k_max}"
    head = (build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), y.data_ptr())
    if kern is ELL:
        n_split, epb, _, part, tickets = slab_k.ell_plan(dev, m, n, k, k_max)
        fn = build.function(kern.source, kern.name, _ELL_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), m, n, k,
                 k_max, n_split, epb, build.stream_ptr(dev))
        detail += f" splits={n_split}x{epb}"
    else:
        fn = build.function(kern.source, kern.name, _ELL_ARGS)
        err = fn(*head, m, n, k, k_max, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def ell_lr_matmul_plain(x, vals, idx, u, v) -> torch.Tensor:
    """Plain version: dense rebuild of W_S, fp32 matmul, plus the fp32
    low-rank projection term; returns x.dtype."""
    y = x.float() @ _dense_of(vals, idx, x.shape[1]).T \
        + lowrank_term(x, u, v)
    return y.to(x.dtype)


def ell_lr_kernel(dtype, m: int, k: int, r: int = 1,
                  idx_bytes: int = 2) -> build.CudaKernel:
    """The library a launch at ``m`` rows, ``k`` columns, rank ``r`` and
    ids of ``idx_bytes`` runs: grouped_tc.cu for bf16 from
    ELL_LR_TC_MIN_ROWS rows where ell_split_smem fits an H100 block; f32
    (1e-5, no TF32), fewer rows and wider K the first design."""
    if dtype == torch.bfloat16 and m >= ELL_LR_TC_MIN_ROWS \
            and ell_split_smem(k, r, idx_bytes) <= slab_k.TC_SMEM:
        return ELL_LR
    return ELL_LR_FIRST


def ell_lr_matmul(x, vals, idx, u, v) -> torch.Tensor:
    """Launch the ELL + low-rank CUDA kernel on the current stream."""
    m, k = x.shape
    kern = ell_lr_kernel(x.dtype, m, k, u.shape[0], idx.element_size())
    return launch_ell_lr(kern, x, vals, idx, u, v)


def launch_ell_lr(kern, x, vals, idx, u, v) -> torch.Tensor:
    """ell_lr_matmul through ``kern``'s library (ELL_LR or ELL_LR_FIRST),
    counted on its counter."""
    m, k, n, k_max = _check_ell(x, vals, idx)
    r = u.shape[0]
    dev = x.device
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} K_max={k_max} R={r}"
    head = (build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            y.data_ptr())
    if kern is ELL_LR:
        n_split, epb, _, part, tickets = slab_k.ell_plan(dev, m, n, k, k_max,
                                                         rank=r)
        fn = build.function(kern.source, kern.name, _ELL_LR_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), m, n, k,
                 k_max, r, n_split, epb, build.stream_ptr(dev))
        detail += f" splits={n_split}x{epb}"
    else:
        fn = build.function(kern.source, kern.name, _ELL_LR_ARGS)
        err = fn(*head, m, n, k, k_max, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def _split_rows(vals, idx, k: int, s: int, epb: int) -> torch.Tensor:
    """Dense fp32 (N, K) of split s's run of every ELL row: its entries
    [s · epb, (s + 1) · epb) counted from the 8-entry boundary at or below
    the row's first entry (row n starts at entry n · K_max of the planes,
    whose base is 16-byte aligned)."""
    n, k_max = vals.shape
    off = torch.arange(n, device=vals.device)[:, None] * k_max % 8
    run = (torch.arange(k_max, device=vals.device)[None, :] + off) // epb
    return _dense_of(torch.where(run == s, vals, torch.zeros_like(vals)),
                     idx, k)


def ell_lr_split_plain(x, vals, idx, u, v, n_split: int,
                       epb: int) -> torch.Tensor:
    """grouped_tc.cu's ell_lr_matmul arithmetic under a split of each
    row's entries, in plain PyTorch (fp32, for the CPU tests): split s
    sums its run of every row (_split_rows) and projects x onto V over
    its share of the columns, [s · ⌈K / n_split⌉, (s + 1) · ⌈K /
    n_split⌉); the partial sums and the partial projections are each
    added in split order, then acc + p · U is rounded once to x.dtype
    (the reference's acc + p · u). With u = v = None (ell_matmul, #4) the
    partial sums alone."""
    k = x.shape[1]
    share = -(-k // n_split)
    xf = x.float()
    acc = torch.zeros(x.shape[0], vals.shape[0], device=x.device)
    p = None if v is None else torch.zeros(x.shape[0], v.shape[0],
                                           device=x.device)
    for s in range(n_split):
        cols = slice(min(k, s * share), min(k, (s + 1) * share))
        acc = acc + xf @ _split_rows(vals, idx, k, s, epb).T
        if p is not None:
            p = p + xf[:, cols] @ v[:, cols].float().T
    if p is not None:
        acc = acc + p @ u.float()
    return acc.to(x.dtype)


def slab_ell_matmul_plain(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Plain version: scatter the ELL rows to a dense W_S, fp32 matmul,
    plus the binary ⊙ rank-r term; returns x.dtype."""
    y = x.float() @ _dense_of(vals, idx, x.shape[1]).T \
        + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def slab_ell_kernel(dtype, m: int, k: int, r: int = 1,
                    idx_bytes: int = 2) -> build.CudaKernel:
    """The library a launch at ``m`` rows, ``k`` columns, rank ``r`` and
    ids of ``idx_bytes`` runs: grouped_tc.cu for bf16 from
    SLAB_ELL_TC_MIN_ROWS rows where ell_split_smem (x, the widest split's
    x ⊙ v_r tiles) fits an H100 block; f32 (1e-5, no TF32), fewer rows
    and wider K or ranks the first design."""
    if dtype == torch.bfloat16 and m >= SLAB_ELL_TC_MIN_ROWS \
            and ell_split_smem(k, r, idx_bytes, binary=True) \
            <= slab_k.TC_SMEM:
        return SLAB_ELL
    return SLAB_ELL_FIRST


def slab_ell_matmul(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Launch the ELL SLaB CUDA kernel on PyTorch's current stream."""
    m, k = x.shape
    kern = slab_ell_kernel(x.dtype, m, k, u.shape[0], idx.element_size())
    return launch_slab_ell(kern, x, vals, idx, b_packed, u, v)


def launch_slab_ell(kern, x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """slab_ell_matmul through ``kern``'s library (SLAB_ELL or
    SLAB_ELL_FIRST), counted on its counter."""
    m, k, n, k_max = _check_ell(x, vals, idx)
    r = u.shape[0]
    dev = x.device
    build.check_operand(b_packed, "b_packed", torch.int32, (n, k // 32), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    build.check_aligned(b_packed, "b_packed")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} K_max={k_max} R={r}"
    head = (build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), b_packed.data_ptr(),
            u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is SLAB_ELL:
        n_split, epb, cps, part, tickets = slab_k.ell_plan(
            dev, m, n, k, k_max, binary=True)
        fn = build.function(kern.source, kern.name, _SLAB_ELL_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), m, n, k,
                 k_max, r, n_split, epb, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{epb} columns {cps * slab_k.CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _ARGS)
        err = fn(*head, m, n, k, k_max, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_ell_split_plain(x, vals, idx, b_packed, u, v, n_split: int,
                         epb: int, cps: int) -> torch.Tensor:
    """grouped_tc.cu's slab_ell_matmul arithmetic under a split, in plain
    PyTorch (fp32, for the CPU tests): split s sums its run of every row
    (_split_rows) and the ±1 term over columns [s · cps · CHUNK, (s + 1)
    · cps · CHUNK) into one partial; the partials are added in split
    order and rounded once to x.dtype."""
    k = x.shape[1]
    step = cps * slab_k.CHUNK
    xf = x.float()
    acc = torch.zeros(x.shape[0], vals.shape[0], device=x.device)
    for s in range(n_split):
        cols = slice(min(k, s * step), min(k, (s + 1) * step))
        words = slice(cols.start // 32, cols.stop // 32)
        part = xf @ _split_rows(vals, idx, k, s, epb).T
        if cols.stop > cols.start:
            part = part + binlr_term(x[:, cols], b_packed[:, words],
                                     u, v[:, cols])
        acc = acc + part
    return acc.to(x.dtype)
