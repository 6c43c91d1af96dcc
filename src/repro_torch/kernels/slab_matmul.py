"""Fused SLaB linears with a dense-masked or an N:M packed sparse part:
the hand-written CUDA kernels (``csrc/slab_matmul.cu``; the bf16
slab_matmul and slab_lr_matmul and the bf16 2:4 / 4:8 slab_nm_matmul and
slab_nm_lr_matmul ``csrc/grouped_tc.cu``) and their plain PyTorch
versions.

    slab_matmul, slab_nm_matmul  y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r
    slab_lr_matmul               y = x @ W_Sᵀ + (x @ Vᵀ) @ U  (no binary)
    slab_nm_lr_matmul            the same with an N:M W_S   (no binary)

Replace ``repro/kernels/slab_matmul.py::{slab_matmul, slab_nm_matmul,
slab_lr_matmul, slab_nm_lr_matmul}`` (TPU). Operands use the kernel layout: x (M, K),
u (R, N), v (R, K).

Each has two libraries under one C name, each counting its launches on
its own ``CudaKernel``: the tensor-core kernel of ``grouped_tc.cu``
(bf16; slab_nm_* at 2:4 / 4:8; K split across blocks by
``plan_nm_splits``, slab_matmul's and slab_lr_matmul's by
``plan_dense_splits``) and the first design of ``slab_matmul.cu`` (f32,
other patterns); ``slab_dense_kernel`` / ``slab_lr_kernel`` /
``slab_nm_kernel`` / ``slab_nm_lr_kernel`` pick one.
``plan_nm_splits``, ``plan_tiles_per_block`` and the split's scratch
(``tc_plan``) also serve #8 (``kernels.nm_sparse``), #9
(``kernels.binlr``) and the grouped #15, #16, #17 and #20
(``kernels.grouped``) on grouped_tc.cu; ``plan_ell_splits``
and ``ell_plan`` split the ELL rows of #1 and #5 (``kernels.ell``)
there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import binlr_term, expand_nm, lowrank_term

_SLAB_NM_TPU = ("src/repro/kernels/slab_matmul.py:117 (slab_nm_matmul, "
                "pallas_call :135)")
_SLAB_DENSE_TPU = ("src/repro/kernels/slab_matmul.py:64 (slab_matmul, "
                   "pallas_call :77)")
SLAB_DENSE = build.CudaKernel("slab_matmul", "grouped_tc.cu",
                              _SLAB_DENSE_TPU)
SLAB_DENSE_FIRST = build.CudaKernel("slab_matmul", "slab_matmul.cu",
                                    _SLAB_DENSE_TPU,
                                    key="slab_matmul@slab_matmul.cu")
SLAB_NM = build.CudaKernel("slab_nm_matmul", "grouped_tc.cu", _SLAB_NM_TPU)
SLAB_NM_FIRST = build.CudaKernel("slab_nm_matmul", "slab_matmul.cu",
                                 _SLAB_NM_TPU,
                                 key="slab_nm_matmul@slab_matmul.cu")
_SLAB_LR_TPU = ("src/repro/kernels/slab_matmul.py:180 (slab_lr_matmul, "
                "pallas_call :193)")
SLAB_LR = build.CudaKernel("slab_lr_matmul", "grouped_tc.cu", _SLAB_LR_TPU)
SLAB_LR_FIRST = build.CudaKernel("slab_lr_matmul", "slab_matmul.cu",
                                 _SLAB_LR_TPU,
                                 key="slab_lr_matmul@slab_matmul.cu")

_SLAB_NM_LR_TPU = ("src/repro/kernels/slab_matmul.py:231 "
                   "(slab_nm_lr_matmul, pallas_call :247)")
SLAB_NM_LR = build.CudaKernel("slab_nm_lr_matmul", "grouped_tc.cu",
                              _SLAB_NM_LR_TPU)
SLAB_NM_LR_FIRST = build.CudaKernel("slab_nm_lr_matmul", "slab_matmul.cu",
                                    _SLAB_NM_LR_TPU,
                                    key="slab_nm_lr_matmul@slab_matmul.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_DENSE_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
# grouped_tc.cu's slab_matmul also takes the split's scratch (part,
# tickets) and plan (n_split, chunks per split)
_DENSE_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _P]
_NM_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# grouped_tc.cu's slab_nm_matmul also takes the split's scratch (part,
# tickets) and plan (n_split, chunks per split)
_NM_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, _I, _P]
_LR_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
# ... and grouped_tc.cu's slab_lr_matmul the split's scratch and plan
_LR_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_NM_LR_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# ... and grouped_tc.cu's slab_nm_lr_matmul the same scratch and plan
_NM_LR_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _P]

# The bf16 2:4 / 4:8 slab_nm_matmul runs grouped_tc.cu's kernel from
# NM_TC_MIN_ROWS rows (chip_smoke.py's M sweep through each library at
# (4096, 4096), PERF.md); fewer rows, f32 and the other patterns run the
# first design.
NM_TC_MIN_ROWS = 1
# ... and the bf16 2:4 / 4:8 slab_nm_lr_matmul from NM_LR_TC_MIN_ROWS rows
NM_LR_TC_MIN_ROWS = 1
# ... and the bf16 slab_matmul from SLAB_DENSE_TC_MIN_ROWS rows where one
# chunk of its tiles fits beside the ring (dense_split_cap)
SLAB_DENSE_TC_MIN_ROWS = 1
# ... and the bf16 slab_lr_matmul from SLAB_LR_TC_MIN_ROWS rows at K % 8
# == 0 where one chunk of x beside the ring fits (dense_split_cap's
# low-rank form)
SLAB_LR_TC_MIN_ROWS = 1
# grouped_tc.cu's kernel splits K so that a launch gives about
# NM_SPLIT_BLOCKS_PER_SM blocks of 128 rows to each SM, in splits of at
# most NM_MAX_SPLIT_CHUNKS chunks (plan_nm_splits).
NM_SPLIT_BLOCKS_PER_SM = 2
NM_MAX_SPLIT_CHUNKS = 16
CHUNK = 128          # columns of one chunk of the kernel's main loop
ROWS = 128           # output rows of one block
ELL_STEP = 64        # entries a gather group of 8 lanes takes a step
TC_SMEM = 227 * 1024  # shared memory an H100 block may opt into
TC_SMEM_HALF = 228 * 1024 // 2 - 1024   # ... where two blocks share an SM
# DenseSrc's 2-stage ring: 8 warps' 16 rows of 256 bytes, plus the 1024
# bytes that align it for the tensor map's 128-byte swizzle
DENSE_RING = 2 * 8 * 16 * 256 + 1024

_SCRATCH = {}        # per device: the split's partial sums and tickets


def _common_checks(x, b_packed, u, v, n: int):
    m, k = x.shape
    r = u.shape[0]
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    build.check_operand(b_packed, "b_packed", torch.int32, (n, k // 32), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    build.check_aligned(b_packed, "b_packed")
    return m, k, r, dev


def slab_matmul_plain(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Plain version of the dense-masked kernel; returns x.dtype."""
    y = x.float() @ w_s.float().T + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def slab_dense_split_plain(x, w_s, b_packed, u, v, n_split: int,
                           cps: int) -> torch.Tensor:
    """grouped_tc.cu's slab_matmul arithmetic under a split of K, in plain
    PyTorch (fp32, for the CPU tests): split s covers columns [s · cps ·
    CHUNK, (s + 1) · cps · CHUNK) and gives one partial, its W_S sum plus
    its ±1 term; the partials are summed in split order and rounded once
    to x.dtype. With ``w_s`` None the partial is the ±1 term alone:
    binlr_matmul's split (#9)."""
    k = x.shape[1]
    step = cps * CHUNK
    acc = torch.zeros(x.shape[0], b_packed.shape[0], device=x.device)
    for s in range(n_split):
        cols = slice(s * step, min(k, (s + 1) * step))
        words = slice(cols.start // 32, cols.stop // 32)
        part = binlr_term(x[:, cols], b_packed[:, words], u, v[:, cols])
        if w_s is not None:
            part = x[:, cols].float() @ w_s[:, cols].float().T + part
        acc = acc + part
    return acc.to(x.dtype)


def dense_tc_smem(r: int, cps: int, ntp: int = 1,
                  lowrank: bool = False) -> int:
    """Shared bytes of grouped_tc.cu's DenseSrc body at a run of ``cps``
    chunks with the 2-stage ring (DENSE_RING), as tc::pick_tc counts them:
    for slab_matmul / slab_matmul_g ``ntp`` tiles of 8 batch rows of x and
    of bf16(x ⊙ v_r) for each of the ``r`` ranks, cps chunks plus 8
    columns wide at 2 bytes, and u of one row tile for each rank; with
    ``lowrank`` (slab_lr_matmul) the x tile alone and the projection's
    sums, p (r, 8·ntp) and the 8 warps' partial sums, in fp32 (rounded up
    to 16 bytes)."""
    tile = 16 * ntp * (cps * CHUNK + 8)
    if lowrank:
        return tile + -(-(8 + 1) * r * 8 * ntp * 4 // 16) * 16 + DENSE_RING
    return tile * (1 + r) + r * ROWS * 2 + DENSE_RING


def plan_dense_splits(n: int, k: int, n_sm: int, e: int,
                      cap: int) -> tuple:
    """(n_split, cps) of grouped_tc.cu's slab_matmul / slab_matmul_g: as
    plan_nm_splits, but enough runs that ``e`` experts' ⌈n / ROWS⌉ row
    tiles x n_split blocks give at most NM_SPLIT_BLOCKS_PER_SM blocks to
    each of n_sm SMs (one wave, as plan_ell_splits; at least one run), no
    run longer than ``cap`` chunks (dense_split_cap), which may add runs.
    From shapes only."""
    tiles = e * -(-n // ROWS)
    chunks = -(-k // CHUNK)
    want = max(1, NM_SPLIT_BLOCKS_PER_SM * n_sm // tiles)
    cps = min(-(-chunks // min(want, chunks)), cap)
    return -(-chunks // cps), cps


def dense_split_cap(r: int, m: int = 1, lowrank: bool = False) -> int:
    """The widest run of K (in chunks) of grouped_tc.cu's slab_matmul (or
    with ``lowrank`` slab_lr_matmul) at rank ``r`` and ``m`` rows whose
    tiles and 2-stage ring let two blocks share an H100 SM (TC_SMEM_HALF;
    two blocks with 2 stages ran ahead of one with 4, PERF.md): at the
    most n-tiles M needs (up to 4) that fit one chunk, as tc::pick_tc
    then picks them. 0 when none fits. From shapes only."""
    for ntp in range(min(max(-(-m // 8), 1), 4), 0, -1):
        cps = 0
        while dense_tc_smem(r, cps + 1, ntp, lowrank) <= TC_SMEM_HALF:
            cps += 1
        if cps:
            return cps
    return 0


def slab_dense_kernel(dtype, m: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows and rank ``r`` runs:
    grouped_tc.cu for bf16 from SLAB_DENSE_TC_MIN_ROWS rows where a run of
    one chunk fits two blocks an SM (dense_split_cap), the first design
    for f32, fewer rows and higher ranks."""
    if dtype == torch.bfloat16 and m >= SLAB_DENSE_TC_MIN_ROWS \
            and dense_split_cap(r) >= 1:
        return SLAB_DENSE
    return SLAB_DENSE_FIRST


def slab_matmul(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Launch the dense-masked CUDA kernel on the current stream."""
    kern = slab_dense_kernel(x.dtype, x.shape[0], u.shape[0])
    return launch_slab_dense(kern, x, w_s, b_packed, u, v)


def launch_slab_dense(kern, x, w_s, b_packed, u, v) -> torch.Tensor:
    """slab_matmul through ``kern``'s library (SLAB_DENSE or
    SLAB_DENSE_FIRST), counted on its counter."""
    n = w_s.shape[0]
    m, k, r, dev = _common_checks(x, b_packed, u, v, n)
    build.check_operand(w_s, "w_s", x.dtype, (n, k), dev)
    build.check_aligned(w_s, "w_s")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
            b_packed.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is SLAB_DENSE:
        n_split, cps, _, part, tickets = tc_plan(dev, 1, m, n, k,
                                                 dense_rank=r)
        fn = build.function(kern.source, kern.name, _DENSE_TC_ARGS)
        err = fn(*head, ptr(part), ptr(tickets), m, n, k, r, n_split, cps,
                 build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _DENSE_ARGS)
        err = fn(*head, m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_nm_matmul_plain(x, vals, idx, m_pat: int, b_packed, u,
                         v) -> torch.Tensor:
    """Plain version of the N:M kernel; returns x.dtype."""
    w = expand_nm(vals, idx, m_pat, torch.float32)
    y = x.float() @ w.T + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def plan_nm_splits(n: int, k: int, n_sm: int, e: int = 1) -> tuple:
    """(n_split, cps): K's CHUNK-column chunks cut into n_split runs of
    cps chunks (the last may be shorter), enough that ``e`` experts'
    ⌈n / ROWS⌉ row tiles x n_split blocks give NM_SPLIT_BLOCKS_PER_SM
    blocks to each of n_sm SMs, never more runs than chunks and no run
    longer than NM_MAX_SPLIT_CHUNKS. From shapes only."""
    tiles = e * -(-n // ROWS)
    chunks = -(-k // CHUNK)
    want = -(-NM_SPLIT_BLOCKS_PER_SM * n_sm // tiles)
    cps = -(-chunks // max(1, min(want, chunks)))
    cps = min(cps, NM_MAX_SPLIT_CHUNKS)
    return -(-chunks // cps), cps


def plan_ell_splits(n: int, k: int, k_max: int, n_sm: int,
                    binary: bool = False) -> tuple:
    """(n_split, epb, cps) of grouped_tc.cu's split ELL gather (#1, #5):
    each row's K_max entries, counted from the 8-entry boundary at or
    below its first (K_max + 7 at most), cut into n_split runs of epb
    entries, a multiple of ELL_STEP (one step of a gather group), enough
    that the ⌈n / ROWS⌉ row tiles x n_split blocks give at most
    NM_SPLIT_BLOCKS_PER_SM blocks to each of n_sm SMs (at least one run,
    never more runs than steps). With ``binary`` (#1) the ±1 term's
    CHUNK-column chunks of K are cut into runs of cps chunks, one a
    split, no run longer than NM_MAX_SPLIT_CHUNKS (which may add splits
    with no entries); without, cps is 0. From shapes only."""
    tiles = -(-n // ROWS)
    steps = -(-(k_max + 7) // ELL_STEP)
    want = max(1, NM_SPLIT_BLOCKS_PER_SM * n_sm // tiles)
    sps = -(-steps // min(want, steps))
    n_split = -(-steps // sps)
    cps = 0
    if binary:
        chunks = -(-k // CHUNK)
        n_split = max(n_split, -(-chunks // NM_MAX_SPLIT_CHUNKS))
        cps = -(-chunks // n_split)
    return n_split, sps * ELL_STEP, cps


def ell_plan(dev, m: int, n: int, k: int, k_max: int,
             binary: bool = False, rank: int = 0):
    """(n_split, epb, cps, part, tickets) of a launch of grouped_tc.cu's
    split ELL gather on ``dev``: plan_ell_splits on its SMs and, for a
    split, the scratch: (n_split, m, n) partial sums, with ``rank`` (#5's
    low-rank term) then the (n_split, row tiles, m, rank) partial
    projections, and one ticket per row tile (None without a split)."""
    n_split, epb, cps = plan_ell_splits(
        n, k, k_max, build.sm_count(dev.index or 0), binary)
    part = tickets = None
    if n_split > 1:
        tiles = -(-n // ROWS)
        part, tickets = _scratch(dev, n_split * m * (n + tiles * rank),
                                 tiles)
    return n_split, epb, cps, part, tickets


def plan_tiles_per_block(n: int, e: int, n_split: int, n_sm: int) -> int:
    """Row tiles of ROWS rows that one block of grouped_tc.cu's ±1 body
    walks after staging x ⊙ v_r once: the fewest that bring the launch's
    e experts x n_split splits x ⌈n / ROWS⌉ tiles down to
    NM_SPLIT_BLOCKS_PER_SM blocks for each of n_sm SMs, one wave (at
    least 1, at most every tile of an expert). From shapes only."""
    tiles = -(-n // ROWS)
    want = NM_SPLIT_BLOCKS_PER_SM * n_sm
    for tpb in range(1, tiles):
        if e * n_split * -(-tiles // tpb) <= want:
            return tpb
    return tiles


def nm_tc_smem(r: int) -> int:
    """Shared bytes of grouped_tc.cu's slab_nm_matmul at its smallest
    launch: one tile of 8 batch rows of x and one of bf16(x ⊙ v_r) for
    each of the ``r`` ranks, each as wide as the widest split
    (NM_MAX_SPLIT_CHUNKS chunks) plus 8 columns, 2 bytes a column."""
    return (1 + r) * 8 * (NM_MAX_SPLIT_CHUNKS * CHUNK + 8) * 2


def _scratch(dev, n_part: int, n_tickets: int):
    """(part, tickets) on ``dev``: at least ``n_part`` fp32 partial sums
    and ``n_tickets`` zero int32 tickets, kept between launches (launches
    on one stream use them in turn; the kernel zeroes each ticket it used
    before it ends), so a launch allocates nothing."""
    part, tickets = _SCRATCH.get(dev, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                           device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 256), dtype=torch.int32,
                              device=dev)
    _SCRATCH[dev] = (part, tickets)
    return part, tickets


def tc_plan(dev, e: int, m: int, n: int, k: int, walk: bool = False,
            rank: int = 0, dense_rank: int = 0):
    """(n_split, cps, tpb, part, tickets) of a launch of grouped_tc.cu's
    split body on ``dev``: the split of K (plan_nm_splits; with
    ``dense_rank``, the rank of a DenseSrc launch, plan_dense_splits,
    capped by dense_split_cap: #3's and #16's ±1 tiles, or with ``rank``
    as well #6's projection sums), the row tiles a block walks
    (plan_tiles_per_block with ``walk``, else 1) and, for a split, the
    scratch: (n_split, e, m, n) partial sums, with ``rank`` (#7's and
    #6's low-rank term) then the (n_split, e, block columns, m, rank)
    partial projections, and one ticket per expert and block column (None
    without a split)."""
    n_sm = build.sm_count(dev.index or 0)
    if dense_rank:
        n_split, cps = plan_dense_splits(
            n, k, n_sm, e, dense_split_cap(dense_rank, m, bool(rank)))
    else:
        n_split, cps = plan_nm_splits(n, k, n_sm, e)
    tpb = plan_tiles_per_block(n, e, n_split, n_sm) if walk else 1
    part = tickets = None
    if n_split > 1:
        tiles = -(-n // ROWS)
        cols = -(-tiles // tpb)            # block columns of an expert
        part, tickets = _scratch(
            dev, n_split * e * m * (n + cols * rank), e * cols)
    return n_split, cps, tpb, part, tickets


def ptr(t) -> int:
    """A tensor's data pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def slab_nm_kernel(dtype, n_keep: int, m_pat: int, m: int,
                   r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows and rank ``r`` runs:
    grouped_tc.cu for bf16 2:4 / 4:8 from NM_TC_MIN_ROWS rows where its
    tiles fit TC_SMEM (nm_tc_smem), the first design for f32, the other
    patterns, fewer rows and higher ranks."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)) \
            and m >= NM_TC_MIN_ROWS and nm_tc_smem(r) <= TC_SMEM:
        return SLAB_NM
    return SLAB_NM_FIRST


def slab_nm_matmul(x, vals, idx, m_pat: int, b_packed, u, v) -> torch.Tensor:
    """Launch the N:M CUDA kernel on the current stream."""
    kern = slab_nm_kernel(x.dtype, vals.shape[-1], m_pat, x.shape[0],
                          u.shape[0])
    return launch_slab_nm(kern, x, vals, idx, m_pat, b_packed, u, v)


def launch_slab_nm(kern, x, vals, idx, m_pat: int, b_packed, u,
                   v) -> torch.Tensor:
    """slab_nm_matmul through ``kern``'s library (SLAB_NM or
    SLAB_NM_FIRST), counted on its counter."""
    n, n_grp, n_keep = vals.shape
    m, k, r, dev = _common_checks(x, b_packed, u, v, n)
    if n_grp * m_pat != k:
        raise ValueError(f"{n_grp} groups of {m_pat} do not cover K={k}")
    build.check_operand(vals, "vals", x.dtype, (n, n_grp, n_keep), dev)
    build.check_operand(idx, "idx", torch.int8, (n, n_grp, n_keep), dev)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} {n_keep}:{m_pat} R={r}"
    if kern is SLAB_NM:
        n_split, cps, _, part, tickets = tc_plan(dev, 1, m, n, k)
        fn = build.function(kern.source, kern.name, _NM_TC_ARGS)
        err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), b_packed.data_ptr(), u.data_ptr(),
                 v.data_ptr(), y.data_ptr(), ptr(part), ptr(tickets), m, n,
                 k, n_keep, m_pat, r, n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _NM_ARGS)
        err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), b_packed.data_ptr(), u.data_ptr(),
                 v.data_ptr(), y.data_ptr(), m, n, k, n_keep, m_pat, r,
                 build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_lr_matmul_plain(x, w_s, u, v) -> torch.Tensor:
    """Plain version of the dense-masked + low-rank kernel; returns
    x.dtype."""
    y = x.float() @ w_s.float().T + lowrank_term(x, u, v)
    return y.to(x.dtype)


def slab_lr_split_plain(x, w_s, u, v, n_split: int,
                        cps: int) -> torch.Tensor:
    """grouped_tc.cu's slab_lr_matmul arithmetic under a split of K, in
    plain PyTorch (fp32, for the CPU tests): split s covers columns [s ·
    cps · CHUNK, (s + 1) · cps · CHUNK) of the dense W_S (N, K) and gives
    a partial W_S sum and a partial projection x · V_sᵀ; both are summed
    in split order, then acc + p · U is rounded once to x.dtype (the
    reference's acc + acc_p · u). With ``u`` and ``v`` None there is no
    projection: acc alone (nm_matmul's split, #8)."""
    xf, wf = x.float(), w_s.float()
    k = x.shape[1]
    acc = torch.zeros(x.shape[0], w_s.shape[0], device=x.device)
    p = None if v is None else torch.zeros(x.shape[0], v.shape[0],
                                           device=x.device)
    for s in range(n_split):
        cols = slice(s * cps * CHUNK, min(k, (s + 1) * cps * CHUNK))
        acc = acc + xf[:, cols] @ wf[:, cols].T
        if p is not None:
            p = p + xf[:, cols] @ v[:, cols].float().T
    return (acc if p is None else acc + p @ u.float()).to(x.dtype)


def slab_lr_kernel(dtype, m: int, k: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows, ``k`` columns and rank ``r``
    runs: grouped_tc.cu for bf16 from SLAB_LR_TC_MIN_ROWS rows at K % 8 ==
    0 (the tensor map's row stride) where a run of one chunk fits two
    blocks an SM (dense_split_cap's low-rank form), the first design for
    f32, fewer rows, other K and higher ranks."""
    if dtype == torch.bfloat16 and m >= SLAB_LR_TC_MIN_ROWS and k % 8 == 0 \
            and dense_split_cap(r, lowrank=True) >= 1:
        return SLAB_LR
    return SLAB_LR_FIRST


def slab_lr_matmul(x, w_s, u, v) -> torch.Tensor:
    """Launch the dense-masked + low-rank CUDA kernel on the current
    stream."""
    m, k = x.shape
    kern = slab_lr_kernel(x.dtype, m, k, u.shape[0])
    return launch_slab_lr(kern, x, w_s, u, v)


def launch_slab_lr(kern, x, w_s, u, v) -> torch.Tensor:
    """slab_lr_matmul through ``kern``'s library (SLAB_LR or
    SLAB_LR_FIRST), counted on its counter."""
    m, k = x.shape
    n = w_s.shape[0]
    r = u.shape[0]
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    build.check_operand(w_s, "w_s", x.dtype, (n, k), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    build.check_aligned(w_s, "w_s")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
            u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is SLAB_LR:
        n_split, cps, _, part, tickets = tc_plan(dev, 1, m, n, k, rank=r,
                                                 dense_rank=r)
        fn = build.function(kern.source, kern.name, _LR_TC_ARGS)
        err = fn(*head, ptr(part), ptr(tickets), m, n, k, r, n_split, cps,
                 build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _LR_ARGS)
        err = fn(*head, m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_nm_lr_matmul_plain(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Plain version of the N:M + low-rank kernel; returns x.dtype."""
    w = expand_nm(vals, idx, m_pat, torch.float32)
    y = x.float() @ w.T + lowrank_term(x, u, v)
    return y.to(x.dtype)


def slab_nm_lr_split_plain(x, vals, idx, m_pat: int, u, v, n_split: int,
                           cps: int) -> torch.Tensor:
    """grouped_tc.cu's slab_nm_lr_matmul arithmetic under a split of K, in
    plain PyTorch (fp32, for the CPU tests): slab_lr_split_plain on the
    expanded W_S; with ``u`` and ``v`` None, nm_matmul's (#8; per expert,
    nm_matmul_g's, #15)."""
    return slab_lr_split_plain(x, expand_nm(vals, idx, m_pat, torch.float32),
                               u, v, n_split, cps)


def slab_nm_lr_kernel(dtype, n_keep: int, m_pat: int,
                      m: int) -> build.CudaKernel:
    """The library a launch at ``m`` rows runs: grouped_tc.cu for bf16
    2:4 / 4:8 from NM_LR_TC_MIN_ROWS rows (any K the pattern divides, any
    rank), the first design for f32, the other patterns and fewer rows."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)) \
            and m >= NM_LR_TC_MIN_ROWS:
        return SLAB_NM_LR
    return SLAB_NM_LR_FIRST


def slab_nm_lr_matmul(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Launch the N:M + low-rank CUDA kernel on the current stream."""
    kern = slab_nm_lr_kernel(x.dtype, vals.shape[-1], m_pat, x.shape[0])
    return launch_slab_nm_lr(kern, x, vals, idx, m_pat, u, v)


def launch_slab_nm_lr(kern, x, vals, idx, m_pat: int, u,
                      v) -> torch.Tensor:
    """slab_nm_lr_matmul through ``kern``'s library (SLAB_NM_LR or
    SLAB_NM_LR_FIRST), counted on its counter."""
    m, k = x.shape
    n, n_grp, n_keep = vals.shape
    r = u.shape[0]
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    if n_grp * m_pat != k:
        raise ValueError(f"{n_grp} groups of {m_pat} do not cover K={k}")
    build.check_operand(vals, "vals", x.dtype, (n, n_grp, n_keep), dev)
    build.check_operand(idx, "idx", torch.int8, (n, n_grp, n_keep), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} {n_keep}:{m_pat} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is SLAB_NM_LR:
        n_split, cps, _, part, tickets = tc_plan(dev, 1, m, n, k, rank=r)
        fn = build.function(kern.source, kern.name, _NM_LR_TC_ARGS)
        err = fn(*head, ptr(part), ptr(tickets), m, n, k, n_keep, m_pat, r,
                 n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _NM_LR_ARGS)
        err = fn(*head, m, n, k, n_keep, m_pat, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y
