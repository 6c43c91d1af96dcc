"""N:M semi-structured sparse linear: the hand-written CUDA kernels and
their plain PyTorch version.

    y = x @ expand(vals, idx)ᵀ,  vals / idx (N, K/m, n), idx the int8
    position of each kept value inside its m-group

Replaces ``repro/kernels/nm_sparse.py::nm_matmul`` (TPU). Values are in
x's dtype; accumulation is fp32.

Two libraries under one C name, each counting its launches on its own
``CudaKernel``: the tensor-core kernel of ``csrc/grouped_tc.cu`` (bf16
2:4 / 4:8, K split across blocks by ``slab_matmul.plan_nm_splits``) and
the first design of ``csrc/nm_sparse.cu`` (f32, other patterns);
``nm_kernel`` picks one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import slab_matmul as slab_k
from repro_torch.kernels.common import expand_nm

_NM_TPU = "src/repro/kernels/nm_sparse.py:41 (nm_matmul, pallas_call :54)"
NM = build.CudaKernel("nm_matmul", "grouped_tc.cu", _NM_TPU)
NM_FIRST = build.CudaKernel("nm_matmul", "nm_sparse.cu", _NM_TPU,
                            key="nm_matmul@nm_sparse.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# grouped_tc.cu's nm_matmul also takes the split's scratch (part,
# tickets) and plan (n_split, chunks per split)
_TC_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

# The bf16 2:4 / 4:8 nm_matmul runs grouped_tc.cu's kernel from
# NM_TC_MIN_ROWS rows (chip_smoke.py's M sweep through each library at
# (4096, 4096), PERF.md); fewer rows, f32 and the other patterns run the
# first design.
NM_TC_MIN_ROWS = 1


def nm_matmul_plain(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Plain version: expand to a dense fp32 W_S, fp32 matmul; returns
    x.dtype."""
    y = x.float() @ expand_nm(vals, idx, m_pat, torch.float32).T
    return y.to(x.dtype)


def nm_kernel(dtype, n_keep: int, m_pat: int, m: int) -> build.CudaKernel:
    """The library a launch at ``m`` rows runs: grouped_tc.cu for bf16
    2:4 / 4:8 from NM_TC_MIN_ROWS rows (any K the pattern divides), the
    first design for f32, the other patterns and fewer rows."""
    if dtype == torch.bfloat16 and (n_keep, m_pat) in ((2, 4), (4, 8)) \
            and m >= NM_TC_MIN_ROWS:
        return NM
    return NM_FIRST


def nm_matmul(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Launch the N:M CUDA kernel on PyTorch's current stream."""
    kern = nm_kernel(x.dtype, vals.shape[-1], m_pat, x.shape[0])
    return launch_nm(kern, x, vals, idx, m_pat)


def launch_nm(kern, x, vals, idx, m_pat: int) -> torch.Tensor:
    """nm_matmul through ``kern``'s library (NM or NM_FIRST), counted on
    its counter."""
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
    detail = f"M={m} N={n} K={k} {n_keep}:{m_pat}"
    head = (build.dtype_code(x.dtype), x.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), y.data_ptr())
    if kern is NM:
        n_split, cps, _, part, tickets = slab_k.tc_plan(dev, 1, m, n, k)
        fn = build.function(kern.source, kern.name, _TC_ARGS)
        err = fn(*head, slab_k.ptr(part), slab_k.ptr(tickets), m, n, k,
                 n_keep, m_pat, n_split, cps, build.stream_ptr(dev))
        detail += f" splits={n_split}x{cps * slab_k.CHUNK}"
    else:
        fn = build.function(kern.source, kern.name, _ARGS)
        err = fn(*head, m, n, k, n_keep, m_pat, build.stream_ptr(dev))
    build.check_launch(err, kern.key, detail)
    kern.launches += 1
    return y
