"""Row-padded ELL SLaB linear: the hand-written CUDA kernel
(``csrc/ell.cu``) and its plain PyTorch version.

    y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r,
    W_S streamed as vals (N, K_max) + column ids (N, K_max)

Replaces ``repro/kernels/ell.py::slab_ell_matmul`` (TPU). Operands use
the kernel layout: x (M, K), u (R, N), v (R, K); ``kernels.ops`` maps
the public layouts onto it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import as_unsigned
from repro_torch.kernels import build
from repro_torch.kernels.common import binlr_term

SLAB_ELL = build.CudaKernel(
    "slab_ell_matmul", "ell.cu",
    "src/repro/kernels/ell.py:191 (slab_ell_matmul, pallas_call :209)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def slab_ell_matmul_plain(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Plain version: scatter the ELL rows to a dense W_S, fp32 matmul,
    plus the binary ⊙ rank-r term; returns x.dtype."""
    n, k = vals.shape[0], x.shape[1]
    w = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, as_unsigned(idx), vals.float())
    y = x.float() @ w.T + binlr_term(x, b_packed, u, v)
    return y.to(x.dtype)


def slab_ell_matmul(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    m, k = x.shape
    n, k_max = vals.shape
    r = u.shape[0]
    dev = x.device
    build.check_operand(x, "x", x.dtype, (m, k), dev)
    build.check_operand(vals, "vals", x.dtype, (n, k_max), dev)
    if idx.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"ELL ids must be int16/int32 views, not {idx.dtype}")
    build.check_operand(idx, "idx", idx.dtype, (n, k_max), dev)
    build.check_operand(b_packed, "b_packed", torch.int32, (n, k // 32), dev)
    build.check_operand(u, "u", x.dtype, (r, n), dev)
    build.check_operand(v, "v", x.dtype, (r, k), dev)
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    for t, nm in ((vals, "vals"), (idx, "idx"), (b_packed, "b_packed")):
        build.check_aligned(t, nm)
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
