"""The binary ⊙ rank-r linear with no sparse part: the hand-written CUDA
kernels and their plain PyTorch version.

    y = Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r,   B ∈ {±1} packed 32 to a word

Replaces ``repro/kernels/binlr.py::binlr_matmul`` (TPU). Operands use
the kernel layout: x (M, K) with K % 32 == 0, b_packed (N, K/32) sign
words (uint32 bits in int32), u (R, N), v (R, K). ``x ⊙ v_r`` is
rounded to x's dtype before the ±1 contraction; accumulation is fp32.

Two libraries under one C name, each counting its launches on its own
``CudaKernel``: the tensor-core kernel of ``csrc/grouped_tc.cu`` (bf16 up
to rank TC_MAX_RANK; K split across blocks by
``slab_matmul.plan_nm_splits``, blocks walking row tiles by
``slab_matmul.plan_tiles_per_block``: #20's body at one expert) and the
first design of ``csrc/slab_matmul.cu`` (f32, one row, higher ranks);
``binlr_kernel`` picks one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import slab_matmul as slab_k
from repro_torch.kernels.common import binlr_term

_BINLR_TPU = "src/repro/kernels/binlr.py:51 (binlr_matmul, pallas_call :65)"
BINLR = build.CudaKernel("binlr_matmul", "grouped_tc.cu", _BINLR_TPU)
BINLR_FIRST = build.CudaKernel("binlr_matmul", "slab_matmul.cu", _BINLR_TPU,
                               key="binlr_matmul@slab_matmul.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
# grouped_tc.cu's binlr_matmul also takes the split's scratch (part,
# tickets) and plan (n_split, chunks per split, row tiles a block walks)
_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

# The bf16 binlr_matmul runs grouped_tc.cu's kernel from BINLR_TC_MIN_ROWS
# rows (chip_smoke.py's M sweep through each library at (4096, 4096),
# PERF.md: at one row the first design's single pass over K, no split,
# is faster on an H100) up to rank TC_MAX_RANK; fewer rows, f32 and higher
# ranks run the first design.
BINLR_TC_MIN_ROWS = 2
# grouped_tc.cu's ±1 body without W_S (#9 and the grouped #20) keeps one
# fp32 accumulator a rank in registers (tc::kMaxR)
TC_MAX_RANK = 4


def binlr_matmul_plain(x, b_packed, u, v) -> torch.Tensor:
    """Plain version: unpack B to ±1, fp32 matmuls; returns x.dtype."""
    return binlr_term(x, b_packed, u, v).to(x.dtype)


def binlr_kernel(dtype, m: int, r: int = 1) -> build.CudaKernel:
    """The library a launch at ``m`` rows and rank ``r`` runs:
    grouped_tc.cu for bf16 from BINLR_TC_MIN_ROWS rows up to rank
    TC_MAX_RANK (its x ⊙ v_r tiles then fit a block at any K, the split
    keeping them within NM_MAX_SPLIT_CHUNKS chunks); f32 (1e-5, no TF32),
    fewer rows and higher ranks the first design."""
    if dtype == torch.bfloat16 and m >= BINLR_TC_MIN_ROWS \
            and r <= TC_MAX_RANK:
        return BINLR
    return BINLR_FIRST


def binlr_matmul(x, b_packed, u, v) -> torch.Tensor:
    """Launch the binlr CUDA kernel on PyTorch's current stream."""
    kern = binlr_kernel(x.dtype, x.shape[0], u.shape[0])
    return launch_binlr(kern, x, b_packed, u, v)


def launch_binlr(kern, x, b_packed, u, v) -> torch.Tensor:
    """binlr_matmul through ``kern``'s library (BINLR or BINLR_FIRST),
    counted on its counter; grouped_tc.cu's blocks walk several row tiles
    (slab_matmul.plan_tiles_per_block)."""
    m, k = x.shape
    n = b_packed.shape[0]
    r = u.shape[0]
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    build.check_operand(b_packed, "b_packed", torch.int32, (n, k // 32), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    build.check_aligned(b_packed, "b_packed")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    detail = f"M={m} N={n} K={k} R={r}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), b_packed.data_ptr(),
            u.data_ptr(), v.data_ptr(), y.data_ptr())
    if kern is BINLR:
        n_split, cps, tpb, part, tickets = slab_k.tc_plan(dev, 1, m, n, k,
                                                          walk=True)
        fn = build.function(kern.source, kern.name, _TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), m, n, k, r,
                 n_split, cps, tpb, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK} tiles={tpb}"
    else:
        fn = build.function(kern.source, kern.name, _ARGS)
        err = fn(*head, m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y
