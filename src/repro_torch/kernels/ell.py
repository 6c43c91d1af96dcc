"""Row-padded ELL linears: the hand-written CUDA kernels (``csrc/ell.cu``)
and their plain PyTorch versions. W_S streams as vals (N, K_max) +
column ids (N, K_max):

    ell_matmul       y = x @ W_Sᵀ
    ell_lr_matmul    y = x @ W_Sᵀ + (x @ Vᵀ) @ U        (fp32 projection)
    slab_ell_matmul  y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r

Replace ``repro/kernels/ell.py::{ell_matmul, ell_lr_matmul,
slab_ell_matmul}`` (TPU). Operands use the kernel layout: x (M, K),
u (R, N), v (R, K); ``kernels.ops`` maps the public layouts onto it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import as_unsigned
from repro_torch.kernels import build
from repro_torch.kernels.common import binlr_term, lowrank_term

SLAB_ELL = build.CudaKernel(
    "slab_ell_matmul", "ell.cu",
    "src/repro/kernels/ell.py:191 (slab_ell_matmul, pallas_call :209)")
ELL = build.CudaKernel(
    "ell_matmul", "ell.cu",
    "src/repro/kernels/ell.py:92 (ell_matmul, pallas_call :105)")
ELL_LR = build.CudaKernel(
    "ell_lr_matmul", "ell.cu",
    "src/repro/kernels/ell.py:134 (ell_lr_matmul, pallas_call :149)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_ELL_ARGS = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_ELL_LR_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


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


def ell_matmul(x, vals, idx) -> torch.Tensor:
    """Launch the ELL CUDA kernel on PyTorch's current stream."""
    m, k, n, k_max = _check_ell(x, vals, idx)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(ELL.source, ELL.name, _ELL_ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), y.data_ptr(), m, n, k, k_max,
             build.stream_ptr(x.device))
    build.check_launch(err, ELL.name, f"M={m} N={n} K={k} K_max={k_max}")
    ELL.launches += 1
    return y


def ell_lr_matmul_plain(x, vals, idx, u, v) -> torch.Tensor:
    """Plain version: dense rebuild of W_S, fp32 matmul, plus the fp32
    low-rank projection term; returns x.dtype."""
    y = x.float() @ _dense_of(vals, idx, x.shape[1]).T \
        + lowrank_term(x, u, v)
    return y.to(x.dtype)


def ell_lr_matmul(x, vals, idx, u, v) -> torch.Tensor:
    """Launch the ELL + low-rank CUDA kernel on the current stream."""
    m, k, n, k_max = _check_ell(x, vals, idx)
    r = u.shape[0]
    build.check_operand(u, "u", x.dtype, (r, n), x.device)
    build.check_operand(v, "v", x.dtype, (r, k), x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn = build.function(ELL_LR.source, ELL_LR.name, _ELL_LR_ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
             y.data_ptr(), m, n, k, k_max, r, build.stream_ptr(x.device))
    build.check_launch(err, ELL_LR.name,
                       f"M={m} N={n} K={k} K_max={k_max} R={r}")
    ELL_LR.launches += 1
    return y


def slab_ell_matmul_plain(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Plain version: scatter the ELL rows to a dense W_S, fp32 matmul,
    plus the binary ⊙ rank-r term; returns x.dtype."""
    y = x.float() @ _dense_of(vals, idx, x.shape[1]).T \
        + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def slab_ell_matmul(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
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
    fn = build.function(SLAB_ELL.source, SLAB_ELL.name, _ARGS)
    err = fn(build.dtype_code(x.dtype), idx.element_size(), x.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), b_packed.data_ptr(),
             u.data_ptr(), v.data_ptr(), y.data_ptr(), m, n, k, k_max, r,
             build.stream_ptr(dev))
    build.check_launch(err, SLAB_ELL.name, f"M={m} N={n} K={k} "
                       f"K_max={k_max} R={r}")
    SLAB_ELL.launches += 1
    return y
