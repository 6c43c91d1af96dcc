"""The binary ⊙ rank-r linear with no sparse part: the hand-written CUDA
kernel (``binlr_matmul`` in ``csrc/slab_matmul.cu``) and its plain
PyTorch version.

    y = Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r,   B ∈ {±1} packed 32 to a word

Replaces ``repro/kernels/binlr.py::binlr_matmul`` (TPU). Operands use
the kernel layout: x (M, K) with K % 32 == 0, b_packed (N, K/32) sign
words (uint32 bits in int32), u (R, N), v (R, K). ``x ⊙ v_r`` is
rounded to x's dtype before the ±1 contraction; accumulation is fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import binlr_term

BINLR = build.CudaKernel(
    "binlr_matmul", "slab_matmul.cu",
    "src/repro/kernels/binlr.py:51 (binlr_matmul, pallas_call :65)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def binlr_matmul_plain(x, b_packed, u, v) -> torch.Tensor:
    """Plain version: unpack B to ±1, fp32 matmuls; returns x.dtype."""
    return binlr_term(x, b_packed, u, v).to(x.dtype)


def binlr_matmul(x, b_packed, u, v) -> torch.Tensor:
    """Launch the binlr CUDA kernel on PyTorch's current stream."""
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
    fn = build.function(BINLR.source, BINLR.name, _ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), b_packed.data_ptr(),
             u.data_ptr(), v.data_ptr(), y.data_ptr(), m, n, k, r,
             build.stream_ptr(dev))
    build.check_launch(err, BINLR.name, f"M={m} N={n} K={k} R={r}")
    BINLR.launches += 1
    return y
