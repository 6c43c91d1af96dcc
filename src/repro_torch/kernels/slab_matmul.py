"""Fused SLaB linears with a dense-masked or an N:M packed sparse part:
the hand-written CUDA kernels (``csrc/slab_matmul.cu``) and their plain
PyTorch versions.

    slab_matmul, slab_nm_matmul  y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r
    slab_lr_matmul               y = x @ W_Sᵀ + (x @ Vᵀ) @ U  (no binary)
    slab_nm_lr_matmul            the same with an N:M W_S   (no binary)

Replace ``repro/kernels/slab_matmul.py::{slab_matmul, slab_nm_matmul,
slab_lr_matmul, slab_nm_lr_matmul}`` (TPU). Operands use the kernel layout: x (M, K),
u (R, N), v (R, K).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import binlr_term, expand_nm, lowrank_term

SLAB_DENSE = build.CudaKernel(
    "slab_matmul", "slab_matmul.cu",
    "src/repro/kernels/slab_matmul.py:64 (slab_matmul, pallas_call :77)")
SLAB_NM = build.CudaKernel(
    "slab_nm_matmul", "slab_matmul.cu",
    "src/repro/kernels/slab_matmul.py:117 (slab_nm_matmul, pallas_call :135)")
SLAB_LR = build.CudaKernel(
    "slab_lr_matmul", "slab_matmul.cu",
    "src/repro/kernels/slab_matmul.py:180 (slab_lr_matmul, pallas_call :193)")

SLAB_NM_LR = build.CudaKernel(
    "slab_nm_lr_matmul", "slab_matmul.cu",
    "src/repro/kernels/slab_matmul.py:231 (slab_nm_lr_matmul, pallas_call "
    ":247)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_DENSE_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_NM_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_LR_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_NM_LR_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


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


def slab_matmul(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Launch the dense-masked CUDA kernel on the current stream."""
    n = w_s.shape[0]
    m, k, r, dev = _common_checks(x, b_packed, u, v, n)
    build.check_operand(w_s, "w_s", x.dtype, (n, k), dev)
    build.check_aligned(w_s, "w_s")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    fn = build.function(SLAB_DENSE.source, SLAB_DENSE.name, _DENSE_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
             b_packed.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(),
             m, n, k, r, build.stream_ptr(dev))
    build.check_launch(err, SLAB_DENSE.name, f"M={m} N={n} K={k} R={r}")
    SLAB_DENSE.launches += 1
    return y


def slab_nm_matmul_plain(x, vals, idx, m_pat: int, b_packed, u,
                         v) -> torch.Tensor:
    """Plain version of the N:M kernel; returns x.dtype."""
    w = expand_nm(vals, idx, m_pat, torch.float32)
    y = x.float() @ w.T + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def slab_nm_matmul(x, vals, idx, m_pat: int, b_packed, u, v) -> torch.Tensor:
    """Launch the N:M CUDA kernel on the current stream."""
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
    fn = build.function(SLAB_NM.source, SLAB_NM.name, _NM_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), b_packed.data_ptr(), u.data_ptr(), v.data_ptr(),
             y.data_ptr(), m, n, k, n_keep, m_pat, r, build.stream_ptr(dev))
    build.check_launch(err, SLAB_NM.name,
                       f"M={m} N={n} K={k} {n_keep}:{m_pat} R={r}")
    SLAB_NM.launches += 1
    return y


def slab_lr_matmul_plain(x, w_s, u, v) -> torch.Tensor:
    """Plain version of the dense-masked + low-rank kernel; returns
    x.dtype."""
    y = x.float() @ w_s.float().T + lowrank_term(x, u, v)
    return y.to(x.dtype)


def slab_lr_matmul(x, w_s, u, v) -> torch.Tensor:
    """Launch the dense-masked + low-rank CUDA kernel on the current
    stream."""
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
    fn = build.function(SLAB_LR.source, SLAB_LR.name, _LR_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), w_s.data_ptr(),
             u.data_ptr(), v.data_ptr(), y.data_ptr(), m, n, k, r,
             build.stream_ptr(dev))
    build.check_launch(err, SLAB_LR.name, f"M={m} N={n} K={k} R={r}")
    SLAB_LR.launches += 1
    return y


def slab_nm_lr_matmul_plain(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Plain version of the N:M + low-rank kernel; returns x.dtype."""
    w = expand_nm(vals, idx, m_pat, torch.float32)
    y = x.float() @ w.T + lowrank_term(x, u, v)
    return y.to(x.dtype)


def slab_nm_lr_matmul(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Launch the N:M + low-rank CUDA kernel on the current stream."""
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
    fn = build.function(SLAB_NM_LR.source, SLAB_NM_LR.name, _NM_LR_ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(), m, n,
             k, n_keep, m_pat, r, build.stream_ptr(dev))
    build.check_launch(err, SLAB_NM_LR.name,
                       f"M={m} N={n} K={k} {n_keep}:{m_pat} R={r}")
    SLAB_NM_LR.launches += 1
    return y
