"""Forward ops of SLaB-compressed linears in plain PyTorch (port of
``repro.core.apply``).

The rank-1 Hadamard structure gives the serving identity

    x @ (u vᵀ ⊙ B)ᵀ = ((x ⊙ v) @ Bᵀ) ⊙ u

so a compressed linear is one sparse matmul, one binary matmul and two
vector scalings. These forms are the oracles of the CUDA kernels
(``kernels.ops.slab_linear_kernel`` serves a ``SLaBPacked`` bundle);
no serving path runs them.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import (ELLPacked, NMPacked, SLaBPacked,
                                      ell_unpack, unpack_nm,
                                      unpack_sign_bits)
from repro_torch.core.slab import (SLaBDecomposition, low_rank_times_binary,
                                   reconstruct)


def slab_linear(x: torch.Tensor, dec: SLaBDecomposition) -> torch.Tensor:
    """y = x @ (W_S + W_L ⊙ W_B)ᵀ for x (..., D_in): the rank-1 identity
    when both terms are present at rank 1, else W_L ⊙ W_B materialized
    (general ranks and the ablations without one of the terms)."""
    dt = x.dtype
    y = x @ dec.w_s.to(dt).T
    has_lr = dec.u is not None and dec.u.numel() > 0
    has_b = dec.w_b is not None and dec.w_b.numel() > 0
    if has_lr and has_b and dec.u.shape[-1] == 1:
        u = dec.u[:, 0].to(dt)
        v = dec.v[:, 0].to(dt)
        y = y + ((x * v) @ dec.w_b.T.to(dt)) * u
    elif has_lr or has_b:
        y = y + x @ low_rank_times_binary(dec).to(dt).T
    return y


def slab_linear_packed(x: torch.Tensor, p: SLaBPacked) -> torch.Tensor:
    """The same from a rank-1 packed bundle, unpacking the sparse part
    and the sign words on the fly (the kernel does it tile by tile)."""
    dt = x.dtype
    if isinstance(p.sparse, NMPacked):
        w_s = unpack_nm(p.sparse)
    elif isinstance(p.sparse, ELLPacked):
        w_s = ell_unpack(p.sparse)
    else:
        w_s = p.sparse
    b = unpack_sign_bits(p.b_packed, p.d_in, dtype=dt)
    y = x @ w_s.to(dt).T
    return y + ((x * p.v.to(dt)) @ b.T) * p.u.to(dt)


def to_dense(dec: SLaBDecomposition, dtype=torch.bfloat16) -> torch.Tensor:
    """Ŵ = W_S + W_L ⊙ W_B materialized at ``dtype`` (swapped into dense
    params for evaluation)."""
    return reconstruct(dec).to(dtype)
