"""Plain fp32 oracles of the ported kernels (port of
``repro.kernels.ref``): every sparse part is unpacked to a dense matrix
and everything is computed in fp32.

Low-rank factors follow the ops-wrapper convention: ``u`` is (N,) or
(N, R), ``v`` is (K,) or (K, R).
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import (ELLPacked, NMPacked, ell_unpack,
                                      unpack_nm, unpack_sign_bits)


def _cols(u: torch.Tensor) -> torch.Tensor:
    return u[:, None] if u.dim() == 1 else u


def binlr_ref(x, b_packed, u, v) -> torch.Tensor:
    """y = Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r."""
    b = unpack_sign_bits(b_packed, x.shape[-1], dtype=torch.float32)
    uu, vv = _cols(u).float(), _cols(v).float()
    xf = x.float()
    out = torch.zeros((*x.shape[:-1], b.shape[0]), dtype=torch.float32,
                      device=x.device)
    for r in range(uu.shape[1]):
        out = out + ((xf * vv[:, r]) @ b.T) * uu[:, r]
    return out


def lowrank_ref(x, u, v) -> torch.Tensor:
    """y = (x @ V) @ Uᵀ, the rank-r term without a binary matrix."""
    return (x.float() @ _cols(v).float()) @ _cols(u).float().T


def nm_matmul_ref(x, vals, idx, m: int) -> torch.Tensor:
    n = vals.shape[-1]
    w = unpack_nm(NMPacked(vals, idx, n, m, vals.shape[1] * m))
    return x.float() @ w.float().T


def ell_matmul_ref(x, vals, idx, d_in: int) -> torch.Tensor:
    w = ell_unpack(ELLPacked(vals, idx, d_in))
    return x.float() @ w.float().T


def ell_lr_matmul_ref(x, vals, idx, d_in: int, u, v) -> torch.Tensor:
    """ELL sparse + rank-r low-rank, no binary."""
    return ell_matmul_ref(x, vals, idx, d_in) + lowrank_ref(x, u, v)


def slab_ell_matmul_ref(x, vals, idx, d_in: int, b_packed, u, v):
    """Fused SLaB linear with ELL sparse part."""
    return ell_matmul_ref(x, vals, idx, d_in) + binlr_ref(x, b_packed, u, v)


def slab_matmul_ref(x, w_s, b_packed, u, v):
    """y = x @ W_Sᵀ + Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r (dense-masked W_S)."""
    return x.float() @ w_s.float().T + binlr_ref(x, b_packed, u, v)


def slab_nm_matmul_ref(x, vals, idx, m: int, b_packed, u, v):
    """Fused SLaB linear with N:M packed sparse part."""
    return nm_matmul_ref(x, vals, idx, m) + binlr_ref(x, b_packed, u, v)


def slab_lr_matmul_ref(x, w_s, u, v):
    """Sparse + rank-r low-rank, no binary: y = x @ W_Sᵀ + (x @ V) @ Uᵀ."""
    return x.float() @ w_s.float().T + lowrank_ref(x, u, v)


def slab_nm_lr_matmul_ref(x, vals, idx, m: int, u, v) -> torch.Tensor:
    """N:M sparse + rank-r low-rank, no binary."""
    return nm_matmul_ref(x, vals, idx, m) + lowrank_ref(x, u, v)


def flash_decode_ref(q, k, v, lengths, k_scale=None, v_scale=None):
    """Grouped decode attention oracle. q (B,KV,G,dh) pre-scaled;
    k/v (B,S,KV,dh); lengths (B,). Returns (B,KV,G,dh). A length-0 row
    gets uniform weights over the S slots (the reference oracle's
    softmax of an all-masked row)."""
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    logits = torch.einsum("bkgd,bskd->bkgs", q.float(), kf)
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, vf).to(q.dtype)
