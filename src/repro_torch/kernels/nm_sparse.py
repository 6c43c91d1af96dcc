"""N:M semi-structured sparse linear: the hand-written CUDA kernel
(``csrc/nm_sparse.cu``) and its plain PyTorch version.

    y = x @ expand(vals, idx)ᵀ,  vals / idx (N, K/m, n), idx the int8
    position of each kept value inside its m-group

Replaces ``repro/kernels/nm_sparse.py::nm_matmul`` (TPU). Values are in
x's dtype; accumulation is fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import expand_nm

NM = build.CudaKernel(
    "nm_matmul", "nm_sparse.cu",
    "src/repro/kernels/nm_sparse.py:41 (nm_matmul, pallas_call :54)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def nm_matmul_plain(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Plain version: expand to a dense fp32 W_S, fp32 matmul; returns
    x.dtype."""
    y = x.float() @ expand_nm(vals, idx, m_pat, torch.float32).T
    return y.to(x.dtype)


def nm_matmul(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Launch the N:M CUDA kernel on PyTorch's current stream."""
    m, k = x.shape
    n, n_grp, n_keep = vals.shape
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    if n_grp * m_pat != k:
        raise ValueError(f"{n_grp} groups of {m_pat} do not cover K={k}")
    build.check_operand(vals, "vals", x.dtype, (n, n_grp, n_keep), dev)
    build.check_operand(idx, "idx", torch.int8, (n, n_grp, n_keep), dev)
    build.check_aligned(vals, "vals")
    build.check_aligned(idx, "idx")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    fn = build.function(NM.source, NM.name, _ARGS)
    err = fn(build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), y.data_ptr(), m, n, k, n_keep, m_pat,
             build.stream_ptr(dev))
    build.check_launch(err, NM.name, f"M={m} N={n} K={k} {n_keep}:{m_pat}")
    NM.launches += 1
    return y
