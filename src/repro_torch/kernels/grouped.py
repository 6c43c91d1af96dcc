"""Grouped-expert SLaB linears: the hand-written CUDA kernels and their
plain PyTorch versions. Each computes, for every expert e of a bucket,
what its per-linear counterpart computes on x[e] and expert e's planes:

    ell_matmul_g         #4 per expert  (csrc/grouped_tc.cu; f32, 1-2
                                         rows per expert and K too
                                         wide to stage: ell.cu)
    ell_lr_matmul_g      #5 per expert  (the same)
    slab_ell_matmul_g    #1 per expert  (csrc/grouped_tc.cu; f32 and 1-2
                                         rows per expert: ell.cu)
    nm_matmul_g          #8 per expert  (csrc/grouped_tc.cu; f32 and
                                         patterns other than 2:4 / 4:8:
                                         nm_sparse.cu)
    slab_matmul_g        #3 per expert  (csrc/grouped_tc.cu; f32 and
                                         ranks whose tiles do not fit:
                                         slab_matmul.cu)
    slab_nm_matmul_g     #2 per expert  (csrc/grouped_tc.cu; f32,
                                         patterns other than 2:4 / 4:8
                                         and ranks whose tiles do not
                                         fit: slab_matmul.cu)
    slab_lr_matmul_g     #6 per expert  (csrc/grouped_tc.cu; f32, K not
                                         a multiple of 8 and K too wide
                                         to stage: slab_matmul.cu)
    slab_nm_lr_matmul_g  #7 per expert  (csrc/grouped_tc.cu; f32 and
                                         patterns other than 2:4 / 4:8:
                                         slab_matmul.cu)
    binlr_matmul_g       #9 per expert  (csrc/grouped_tc.cu; f32 and
                                         ranks past 4: slab_matmul.cu)

Replace the nine kernels of ``repro/kernels/grouped.py`` (TPU), one for
one. A CUDA kernel here is launched once for the whole bucket with the
expert as the grid's y dimension, never E launches: for the bf16
launches a kernel redesigned for Hopper (``csrc/grouped_tc.cu``: 128
output rows a block, x staged once per 8-32 batch rows; all but
ell_matmul_g, ell_lr_matmul_g and slab_ell_matmul_g on the tensor cores
through one body, ``tc::tc_body``; slab_lr_matmul_g's and
slab_matmul_g's dense rows streamed by bulk copies; slab_matmul_g,
slab_nm_matmul_g, binlr_matmul_g and nm_matmul_g with K split across
blocks and binlr_matmul_g's blocks walking several row tiles:
``slab_matmul.tc_plan``). Each keeps its first design (same C symbol in
``ell.cu`` / ``slab_matmul.cu`` / ``nm_sparse.cu``: the per-linear
kernel on the expert grid) for the launches the new kernel does not
take, and counts each library's launches apart. Operands use the kernel layout
with a leading expert dim: x (E, M, K), u (E, R, N), v (E, R, K),
planes (E, N, ...); ``kernels.ops`` maps the public layouts onto it.
The plain versions loop over the experts through the per-linear plain
versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import binlr as binlr_k
from repro_torch.kernels import build
from repro_torch.kernels import ell as ell_k
from repro_torch.kernels import nm_sparse as nm_k
from repro_torch.kernels import slab_matmul as slab_k

_SLAB_ELL_G_TPU = ("src/repro/kernels/grouped.py:128 (slab_ell_matmul_g, "
                   "pallas_call :142)")
SLAB_ELL_G = build.CudaKernel("slab_ell_matmul_g", "grouped_tc.cu",
                              _SLAB_ELL_G_TPU)
SLAB_ELL_G_FIRST = build.CudaKernel("slab_ell_matmul_g", "ell.cu",
                                    _SLAB_ELL_G_TPU,
                                    key="slab_ell_matmul_g@ell.cu")
_NM_G_TPU = "src/repro/kernels/grouped.py:183 (nm_matmul_g, pallas_call :195)"
NM_G = build.CudaKernel("nm_matmul_g", "grouped_tc.cu", _NM_G_TPU)
NM_G_FIRST = build.CudaKernel("nm_matmul_g", "nm_sparse.cu", _NM_G_TPU,
                              key="nm_matmul_g@nm_sparse.cu")
_SLAB_G_TPU = ("src/repro/kernels/grouped.py:230 (slab_matmul_g, "
               "pallas_call :242)")
SLAB_G = build.CudaKernel("slab_matmul_g", "grouped_tc.cu", _SLAB_G_TPU)
SLAB_G_FIRST = build.CudaKernel("slab_matmul_g", "slab_matmul.cu",
                                _SLAB_G_TPU,
                                key="slab_matmul_g@slab_matmul.cu")
_SLAB_NM_G_TPU = ("src/repro/kernels/grouped.py:280 (slab_nm_matmul_g, "
                  "pallas_call :297)")
SLAB_NM_G = build.CudaKernel("slab_nm_matmul_g", "grouped_tc.cu",
                             _SLAB_NM_G_TPU)
SLAB_NM_G_FIRST = build.CudaKernel("slab_nm_matmul_g", "slab_matmul.cu",
                                   _SLAB_NM_G_TPU,
                                   key="slab_nm_matmul_g@slab_matmul.cu")
_ELL_G_TPU = "src/repro/kernels/grouped.py:54 (ell_matmul_g, pallas_call :64)"
ELL_G = build.CudaKernel("ell_matmul_g", "grouped_tc.cu", _ELL_G_TPU)
ELL_G_FIRST = build.CudaKernel("ell_matmul_g", "ell.cu", _ELL_G_TPU,
                               key="ell_matmul_g@ell.cu")
_ELL_LR_G_TPU = ("src/repro/kernels/grouped.py:91 (ell_lr_matmul_g, "
                 "pallas_call :103)")
ELL_LR_G = build.CudaKernel("ell_lr_matmul_g", "grouped_tc.cu",
                            _ELL_LR_G_TPU)
ELL_LR_G_FIRST = build.CudaKernel("ell_lr_matmul_g", "ell.cu",
                                  _ELL_LR_G_TPU,
                                  key="ell_lr_matmul_g@ell.cu")
_SLAB_LR_G_TPU = ("src/repro/kernels/grouped.py:336 (slab_lr_matmul_g, "
                  "pallas_call :348)")
SLAB_LR_G = build.CudaKernel("slab_lr_matmul_g", "grouped_tc.cu",
                             _SLAB_LR_G_TPU)
SLAB_LR_G_FIRST = build.CudaKernel("slab_lr_matmul_g", "slab_matmul.cu",
                                   _SLAB_LR_G_TPU,
                                   key="slab_lr_matmul_g@slab_matmul.cu")
_SLAB_NM_LR_G_TPU = ("src/repro/kernels/grouped.py:387 (slab_nm_lr_matmul_g, "
                     "pallas_call :402)")
SLAB_NM_LR_G = build.CudaKernel("slab_nm_lr_matmul_g", "grouped_tc.cu",
                                _SLAB_NM_LR_G_TPU)
SLAB_NM_LR_G_FIRST = build.CudaKernel("slab_nm_lr_matmul_g",
                                      "slab_matmul.cu", _SLAB_NM_LR_G_TPU,
                                      key="slab_nm_lr_matmul_g@slab_matmul.cu")
_BINLR_G_TPU = ("src/repro/kernels/grouped.py:437 (binlr_matmul_g, "
                "pallas_call :450)")
BINLR_G = build.CudaKernel("binlr_matmul_g", "grouped_tc.cu", _BINLR_G_TPU)
BINLR_G_FIRST = build.CudaKernel("binlr_matmul_g", "slab_matmul.cu",
                                 _BINLR_G_TPU,
                                 key="binlr_matmul_g@slab_matmul.cu")

# The bf16 slab_ell_matmul_g runs grouped_tc.cu's kernel from this many
# rows per expert; below, ell.cu's first design, whose 2-byte gathers
# beat the tensor-core kernel's wider ones on an H100. chip_smoke.py
# times both libraries at M 1-32 on both MoE models' expert planes
# (PERF.md), deepseek-moe-16b's (1408, 2048) and phi3.5-moe's (6400,
# 4096); the crossover of each is recorded there.
TC_MIN_ROWS = 3
# The bf16 ell_matmul_g and ell_lr_matmul_g run grouped_tc.cu's gather
# kernel from ELL_TC_MIN_ROWS rows per expert (chip_smoke.py's M sweep on
# deepseek-moe-16b's planes, PERF.md) where its smallest tile fits an
# H100 block's ELL_TC_SMEM bytes of shared memory (ell_tc_smem). The
# rest runs the first design, which holds x at 2 bytes a column.
ELL_TC_MIN_ROWS = 3
ELL_TC_SMEM = slab_k.TC_SMEM
# The bf16 slab_lr_matmul_g runs grouped_tc.cu's kernel from
# LR_TC_MIN_ROWS rows per expert (chip_smoke.py's M sweep through each
# library on deepseek-moe-16b's planes, PERF.md) where K is a multiple of
# 8 (its rows, 16-byte aligned, are a tensor map's) and its smallest tile
# fits an H100 block (lr_tc_smem).
LR_TC_MIN_ROWS = 1
# The bf16 slab_nm_matmul_g (2:4 / 4:8) and binlr_matmul_g run
# grouped_tc.cu's ±1 body from these many rows per expert (chip_smoke.py's
# M sweeps through each library, on phi3.5-moe's and deepseek-moe-16b's
# planes, PERF.md) where their tiles fit an H100 block (nm_tc_smem; for
# binlr_matmul_g up to rank binlr.TC_MAX_RANK), and the bf16 nm_matmul_g
# (2:4 / 4:8) the same body without the ±1 term from NM_G_TC_MIN_ROWS
# (chip_smoke.py's M sweep on phi3.5-moe's planes).
SLAB_NM_G_TC_MIN_ROWS = 1
BINLR_G_TC_MIN_ROWS = 1
NM_G_TC_MIN_ROWS = 1
# ... and the bf16 slab_matmul_g from SLAB_G_TC_MIN_ROWS rows per expert
# where a run of one chunk fits two blocks an SM
# (slab_matmul.dense_split_cap)
SLAB_G_TC_MIN_ROWS = 1


def ell_tc_smem(k: int, r: int, idx_bytes: int) -> int:
    """Shared bytes of grouped_tc.cu's gather (ell_split_kernel, which
    #12 and #13 share with #1 and #5) at one tile of 8 batch rows: x as
    ell_kp(K) 16-byte columns, a ring of 4 steps of 8-entry blocks for
    each of 256 threads (vals and ids, 16 bytes per 8 vals or uint16 ids),
    and for a rank-``r`` projection its sums and the 8 warps' partial sums
    in fp32 (ell.ell_split_smem)."""
    return ell_k.ell_split_smem(k, r, idx_bytes)


def lr_tc_smem(k: int, r: int) -> int:
    """Shared bytes of grouped_tc.cu's slab_lr_matmul_g at its smallest
    launch (tc::pick_tc): one tile of 8 batch rows of x at K rounded up to
    128 plus 8 columns of 2 bytes, the projection sums of rank ``r`` and
    the 8 warps' partial sums in fp32, and a ring of 2 stages of 16 rows
    of 256 bytes for each of the 8 warps, aligned for the tensor map's
    swizzle (slab_matmul.DENSE_RING)."""
    kp = -(-k // 128) * 128
    sums = -(-(8 + 1) * r * 8 * 4 // 16) * 16
    return 8 * (kp + 8) * 2 + sums + slab_k.DENSE_RING


_P = ctypes.c_void_p
_I = ctypes.c_int
_SLAB_ELL_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _P]
_NM_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# grouped_tc.cu's nm_matmul_g also takes the split's scratch (part,
# tickets) and plan (n_split, chunks per split)
_NM_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _P]
_SLAB_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_SLAB_NM_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _P]
_ELL_ARGS = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_ELL_LR_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_LR_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_NM_LR_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_BINLR_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# grouped_tc.cu's slab_nm_matmul_g and binlr_matmul_g also take the
# split's scratch (part, tickets) and plan (n_split, chunks per split;
# binlr_matmul_g also the row tiles a block walks)
_SLAB_NM_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _P]
_SLAB_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _P]
_BINLR_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P]


def _per_expert(plain, x, *planes) -> torch.Tensor:
    """Stack ``plain`` over the experts; non-tensor arguments pass as is."""
    def at(a, e):
        return a[e] if isinstance(a, torch.Tensor) else a
    return torch.stack([plain(x[e], *(at(a, e) for a in planes))
                        for e in range(x.shape[0])])


def _check_x(x):
    e, m, k = x.shape
    build.check_operand(x, "x", x.dtype, (e, m, k), x.device)
    return e, m, k


def _check_rank(x, u, v, n: int):
    """The (E, R, N) / (E, R, K) rank stacks; returns (e, m, k, r)."""
    e, m, k = _check_x(x)
    r = u.shape[1]
    build.check_operand(u, "u", x.dtype, (e, r, n), x.device)
    build.check_operand(v, "v", x.dtype, (e, r, k), x.device)
    return e, m, k, r


def _check_binary(x, b_packed, u, v, n: int):
    """The sign words and rank stacks of the binary kernels."""
    e, m, k, r = _check_rank(x, u, v, n)
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    build.check_operand(b_packed, "b_packed", torch.int32, (e, n, k // 32),
                        x.device)
    build.check_aligned(b_packed, "b_packed")
    return e, m, k, r


def _check_ell(x, vals, idx):
    """The (E, N, K_max) ELL planes; returns (n, k_max)."""
    e = x.shape[0]
    n, k_max = vals.shape[1:]
    build.check_operand(vals, "vals", x.dtype, (e, n, k_max), x.device)
    if idx.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"ELL ids must be int16/int32 views, not {idx.dtype}")
    build.check_operand(idx, "idx", idx.dtype, (e, n, k_max), x.device)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    return n, k_max


def _check_nm(x, vals, idx, m_pat: int):
    e, _, k = x.shape
    n, n_grp, n_keep = vals.shape[1:]
    if n_grp * m_pat != k:
        raise ValueError(f"{n_grp} groups of {m_pat} do not cover K={k}")
    build.check_operand(vals, "vals", x.dtype, (e, n, n_grp, n_keep),
                        x.device)
    build.check_operand(idx, "idx", torch.int8, (e, n, n_grp, n_keep),
                        x.device)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    return n, n_keep


def slab_ell_matmul_g_plain(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    return _per_expert(ell_k.slab_ell_matmul_plain, x, vals, idx, b_packed,
                       u, v)


def slab_ell_g_kernel(dtype, m: int) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert runs: grouped_tc.cu
    for bf16 from TC_MIN_ROWS rows; f32 (1e-5, no TF32) and fewer rows
    the first design."""
    if dtype == torch.bfloat16 and m >= TC_MIN_ROWS:
        return SLAB_ELL_G
    return SLAB_ELL_G_FIRST


def slab_ell_matmul_g(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Launch the grouped ELL SLaB kernel (one launch for the bucket)."""
    _, m, _ = _check_x(x)
    return launch_slab_ell_g(slab_ell_g_kernel(x.dtype, m), x, vals, idx,
                             b_packed, u, v)


def launch_slab_ell_g(kern, x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """slab_ell_matmul_g through ``kern``'s library (SLAB_ELL_G or
    SLAB_ELL_G_FIRST), counted on its counter."""
    n, k_max = _check_ell(x, vals, idx)
    e, m, k, r = _check_binary(x, b_packed, u, v, n)
    dev = x.device
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    fn = build.function(kern.source, kern.name, _SLAB_ELL_ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), b_packed.data_ptr(),
             u.data_ptr(), v.data_ptr(), y.data_ptr(), e, m, n, k, k_max, r,
             build.stream_ptr(dev))
    build.check_launch(err, kern.key,
                       f"E={e} M={m} N={n} K={k} K_max={k_max} R={r}")
    kern.launches += 1
    return y


def nm_matmul_g_plain(x, vals, idx, m_pat: int) -> torch.Tensor:
    return _per_expert(nm_k.nm_matmul_plain, x, vals, idx, m_pat)


def nm_g_kernel(dtype, n_keep: int, m_pat: int,
                m: int) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert runs: grouped_tc.cu
    for bf16 2:4 / 4:8 from NM_G_TC_MIN_ROWS rows (any K the pattern
    divides); f32 (1e-5, no TF32), the other patterns and fewer rows the
    first design."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)) \
            and m >= NM_G_TC_MIN_ROWS:
        return NM_G
    return NM_G_FIRST


def nm_matmul_g(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Launch the grouped N:M kernel (one launch for the bucket)."""
    kern = nm_g_kernel(x.dtype, vals.shape[-1], m_pat, x.shape[1])
    return launch_nm_g(kern, x, vals, idx, m_pat)


def launch_nm_g(kern, x, vals, idx, m_pat: int) -> torch.Tensor:
    """nm_matmul_g through ``kern``'s library (NM_G or NM_G_FIRST),
    counted on its counter."""
    e, m, k = _check_x(x)
    n, n_keep = _check_nm(x, vals, idx, m_pat)
    dev = x.device
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"E={e} M={m} N={n} K={k} {n_keep}:{m_pat}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), y.data_ptr())
    if kern is NM_G:
        n_split, cps, _, part, tickets = slab_k.tc_plan(dev, e, m, n, k)
        fn = build.function(kern.source, kern.name, _NM_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), e, m, n, k,
                 n_keep, m_pat, n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _NM_ARGS)
        err = fn(*head, e, m, n, k, n_keep, m_pat, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_matmul_g_plain(x, w_s, b_packed, u, v) -> torch.Tensor:
    return _per_expert(slab_k.slab_matmul_plain, x, w_s, b_packed, u, v)


def slab_g_kernel(dtype, m: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert and rank ``r`` runs:
    grouped_tc.cu for bf16 from SLAB_G_TC_MIN_ROWS rows where a run of one
    chunk fits two blocks an SM (as #3's: slab_matmul.dense_split_cap);
    f32 (1e-5, no TF32), fewer rows and higher ranks the first design."""
    if dtype == torch.bfloat16 and m >= SLAB_G_TC_MIN_ROWS \
            and slab_k.dense_split_cap(r) >= 1:
        return SLAB_G
    return SLAB_G_FIRST


def slab_matmul_g(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Launch the grouped dense-masked SLaB kernel (one launch)."""
    kern = slab_g_kernel(x.dtype, x.shape[1], u.shape[1])
    return launch_slab_g(kern, x, w_s, b_packed, u, v)


def launch_slab_g(kern, x, w_s, b_packed, u, v) -> torch.Tensor:
    """slab_matmul_g through ``kern``'s library (SLAB_G or SLAB_G_FIRST),
    counted on its counter."""
    n = w_s.shape[1]
    e, m, k, r = _check_binary(x, b_packed, u, v, n)
    build.check_operand(w_s, "w_s", x.dtype, (e, n, k), x.device)
    build.check_aligned(w_s, "w_s")
    dev = x.device
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"E={e} M={m} N={n} K={k} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
            b_packed.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is SLAB_G:
        n_split, cps, _, part, tickets = slab_k.tc_plan(dev, e, m, n, k,
                                                        dense_rank=r)
        fn = build.function(kern.source, kern.name, _SLAB_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), e, m, n, k,
                 r, n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _SLAB_ARGS)
        err = fn(*head, e, m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def slab_nm_matmul_g_plain(x, vals, idx, m_pat: int, b_packed, u,
                           v) -> torch.Tensor:
    return _per_expert(slab_k.slab_nm_matmul_plain, x, vals, idx, m_pat,
                       b_packed, u, v)


def slab_nm_g_kernel(dtype, n_keep: int, m_pat: int, m: int,
                     r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert and rank ``r`` runs:
    grouped_tc.cu for bf16 2:4 / 4:8 from SLAB_NM_G_TC_MIN_ROWS rows where
    its tiles fit slab_matmul.TC_SMEM (as #2's: slab_matmul.nm_tc_smem);
    f32 (1e-5, no TF32), the other patterns, fewer rows and higher ranks
    the first design."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)) \
            and m >= SLAB_NM_G_TC_MIN_ROWS \
            and slab_k.nm_tc_smem(r) <= slab_k.TC_SMEM:
        return SLAB_NM_G
    return SLAB_NM_G_FIRST


def slab_nm_matmul_g(x, vals, idx, m_pat: int, b_packed, u,
                     v) -> torch.Tensor:
    """Launch the grouped N:M SLaB kernel (one launch for the bucket)."""
    kern = slab_nm_g_kernel(x.dtype, vals.shape[-1], m_pat, x.shape[1],
                            u.shape[1])
    return launch_slab_nm_g(kern, x, vals, idx, m_pat, b_packed, u, v)


def launch_slab_nm_g(kern, x, vals, idx, m_pat: int, b_packed, u,
                     v) -> torch.Tensor:
    """slab_nm_matmul_g through ``kern``'s library (SLAB_NM_G or
    SLAB_NM_G_FIRST), counted on its counter."""
    n = vals.shape[1]
    e, m, k, r = _check_binary(x, b_packed, u, v, n)
    _, n_keep = _check_nm(x, vals, idx, m_pat)
    dev = x.device
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"E={e} M={m} N={n} K={k} {n_keep}:{m_pat} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), b_packed.data_ptr(), u.data_ptr(), v.data_ptr(),
            y.data_ptr())
    if kern is SLAB_NM_G:
        n_split, cps, _, part, tickets = slab_k.tc_plan(dev, e, m, n, k)
        fn = build.function(kern.source, kern.name, _SLAB_NM_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), e, m, n, k,
                 n_keep, m_pat, r, n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _SLAB_NM_ARGS)
        err = fn(*head, e, m, n, k, n_keep, m_pat, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y


def ell_matmul_g_plain(x, vals, idx) -> torch.Tensor:
    return _per_expert(ell_k.ell_matmul_plain, x, vals, idx)


def ell_g_kernel(dtype, m: int, k: int, lowrank: bool = False, *,
                 r: int = 0, idx_bytes: int = 4) -> build.CudaKernel:
    """The library a launch of ell_matmul_g (``lowrank``: ell_lr_matmul_g
    at rank ``r``) at ``m`` rows per expert, ``k`` columns and ids of
    ``idx_bytes`` runs: grouped_tc.cu for bf16 from ELL_TC_MIN_ROWS rows
    where one tile fits ELL_TC_SMEM; f32 (1e-5, no TF32), fewer rows and
    shapes that do not fit the first design."""
    if dtype == torch.bfloat16 and m >= ELL_TC_MIN_ROWS \
            and ell_tc_smem(k, r if lowrank else 0, idx_bytes) <= ELL_TC_SMEM:
        return ELL_LR_G if lowrank else ELL_G
    return ELL_LR_G_FIRST if lowrank else ELL_G_FIRST


def ell_matmul_g(x, vals, idx) -> torch.Tensor:
    """Launch the grouped ELL kernel (one launch for the bucket)."""
    _, m, k = _check_x(x)
    kern = ell_g_kernel(x.dtype, m, k, idx_bytes=idx.element_size())
    return launch_ell_g(kern, x, vals, idx)


def launch_ell_g(kern, x, vals, idx) -> torch.Tensor:
    """ell_matmul_g through ``kern``'s library (ELL_G or ELL_G_FIRST),
    counted on its counter."""
    e, m, k = _check_x(x)
    n, k_max = _check_ell(x, vals, idx)
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(kern.source, kern.name, _ELL_ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), y.data_ptr(), e, m, n, k,
             k_max, build.stream_ptr(x.device))
    build.check_launch(err, kern.key,
                       f"E={e} M={m} N={n} K={k} K_max={k_max}")
    kern.launches += 1
    return y


def ell_lr_matmul_g_plain(x, vals, idx, u, v) -> torch.Tensor:
    return _per_expert(ell_k.ell_lr_matmul_plain, x, vals, idx, u, v)


def ell_lr_matmul_g(x, vals, idx, u, v) -> torch.Tensor:
    """Launch the grouped ELL + low-rank kernel (one launch)."""
    _, m, k = _check_x(x)
    kern = ell_g_kernel(x.dtype, m, k, lowrank=True, r=u.shape[1],
                        idx_bytes=idx.element_size())
    return launch_ell_lr_g(kern, x, vals, idx, u, v)


def launch_ell_lr_g(kern, x, vals, idx, u, v) -> torch.Tensor:
    """ell_lr_matmul_g through ``kern``'s library (ELL_LR_G or
    ELL_LR_G_FIRST), counted on its counter."""
    n, k_max = _check_ell(x, vals, idx)
    e, m, k, r = _check_rank(x, u, v, n)
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(kern.source, kern.name, _ELL_LR_ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
             y.data_ptr(), e, m, n, k, k_max, r, build.stream_ptr(x.device))
    build.check_launch(err, kern.key,
                       f"E={e} M={m} N={n} K={k} K_max={k_max} R={r}")
    kern.launches += 1
    return y


def slab_lr_matmul_g_plain(x, w_s, u, v) -> torch.Tensor:
    return _per_expert(slab_k.slab_lr_matmul_plain, x, w_s, u, v)


def slab_lr_g_kernel(dtype, m: int, k: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert, ``k`` columns and
    rank ``r`` runs: grouped_tc.cu for bf16 from LR_TC_MIN_ROWS rows where
    K % 8 == 0 and its smallest tile fits slab_matmul.TC_SMEM; f32 (1e-5,
    no TF32), fewer rows and other shapes the first design."""
    if dtype == torch.bfloat16 and m >= LR_TC_MIN_ROWS and k % 8 == 0 \
            and lr_tc_smem(k, r) <= slab_k.TC_SMEM:
        return SLAB_LR_G
    return SLAB_LR_G_FIRST


def slab_lr_matmul_g(x, w_s, u, v) -> torch.Tensor:
    """Launch the grouped dense-masked + low-rank kernel (one launch)."""
    _, m, k = _check_x(x)
    kern = slab_lr_g_kernel(x.dtype, m, k, u.shape[1])
    return launch_slab_lr_g(kern, x, w_s, u, v)


def launch_slab_lr_g(kern, x, w_s, u, v) -> torch.Tensor:
    """slab_lr_matmul_g through ``kern``'s library (SLAB_LR_G or
    SLAB_LR_G_FIRST), counted on its counter."""
    n = w_s.shape[1]
    e, m, k, r = _check_rank(x, u, v, n)
    build.check_operand(w_s, "w_s", x.dtype, (e, n, k), x.device)
    build.check_aligned(w_s, "w_s")
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(kern.source, kern.name, _LR_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
             u.data_ptr(), v.data_ptr(), y.data_ptr(), e, m, n, k, r,
             build.stream_ptr(x.device))
    build.check_launch(err, kern.key, f"E={e} M={m} N={n} K={k} R={r}")
    kern.launches += 1
    return y


def slab_nm_lr_matmul_g_plain(x, vals, idx, m_pat: int, u,
                              v) -> torch.Tensor:
    return _per_expert(slab_k.slab_nm_lr_matmul_plain, x, vals, idx, m_pat,
                       u, v)


def slab_nm_lr_g_kernel(dtype, n_keep: int, m_pat: int) -> build.CudaKernel:
    """The library a launch runs: grouped_tc.cu for bf16 2:4 / 4:8, the
    first design for f32 and the other patterns."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)):
        return SLAB_NM_LR_G
    return SLAB_NM_LR_G_FIRST


def slab_nm_lr_matmul_g(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Launch the grouped N:M + low-rank kernel (one launch)."""
    kern = slab_nm_lr_g_kernel(x.dtype, vals.shape[-1], m_pat)
    return launch_slab_nm_lr_g(kern, x, vals, idx, m_pat, u, v)


def launch_slab_nm_lr_g(kern, x, vals, idx, m_pat: int, u,
                        v) -> torch.Tensor:
    """slab_nm_lr_matmul_g through ``kern``'s library (SLAB_NM_LR_G or
    SLAB_NM_LR_G_FIRST), counted on its counter."""
    n, n_keep = _check_nm(x, vals, idx, m_pat)
    e, m, k, r = _check_rank(x, u, v, n)
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(kern.source, kern.name, _NM_LR_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(), e, m,
             n, k, n_keep, m_pat, r, build.stream_ptr(x.device))
    build.check_launch(err, kern.key,
                       f"E={e} M={m} N={n} K={k} {n_keep}:{m_pat} R={r}")
    kern.launches += 1
    return y


def binlr_matmul_g_plain(x, b_packed, u, v) -> torch.Tensor:
    return _per_expert(binlr_k.binlr_matmul_plain, x, b_packed, u, v)


def binlr_g_kernel(dtype, m: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows per expert and rank ``r`` runs:
    grouped_tc.cu for bf16 from BINLR_G_TC_MIN_ROWS rows up to rank
    binlr.TC_MAX_RANK (as #9's: binlr.binlr_kernel); f32 (1e-5, no TF32),
    fewer rows and higher ranks the first design."""
    if dtype == torch.bfloat16 and m >= BINLR_G_TC_MIN_ROWS \
            and r <= binlr_k.TC_MAX_RANK:
        return BINLR_G
    return BINLR_G_FIRST


def binlr_matmul_g(x, b_packed, u, v) -> torch.Tensor:
    """Launch the grouped binary ⊙ rank-r kernel (one launch)."""
    kern = binlr_g_kernel(x.dtype, x.shape[1], u.shape[1])
    return launch_binlr_g(kern, x, b_packed, u, v)


def launch_binlr_g(kern, x, b_packed, u, v) -> torch.Tensor:
    """binlr_matmul_g through ``kern``'s library (BINLR_G or
    BINLR_G_FIRST), counted on its counter; grouped_tc.cu's blocks walk
    several row tiles (slab_matmul.plan_tiles_per_block)."""
    n = b_packed.shape[1]
    e, m, k, r = _check_binary(x, b_packed, u, v, n)
    dev = x.device
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"E={e} M={m} N={n} K={k} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), b_packed.data_ptr(),
            u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is BINLR_G:
        n_split, cps, tpb, part, tickets = slab_k.tc_plan(dev, e, m, n, k,
                                                          walk=True)
        fn = build.function(kern.source, kern.name, _BINLR_TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), e, m, n, k,
                 r, n_split, cps, tpb, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK} tiles={tpb}"
    else:
        fn = build.function(kern.source, kern.name, _BINLR_ARGS)
        err = fn(*head, e, m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y
