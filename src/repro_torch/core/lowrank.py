"""Low-rank primitives (port of ``repro.core.lowrank``).

SLaB needs the rank-1 truncated SVD of the non-negative |W - W_S|. Power
iteration from a positive start vector converges to the entry-wise
non-negative dominant pair (paper Prop. 2). Rank r > 1 (the ablations of
Table III) goes through ``truncated_svd``: the exact SVD for small
matrices, subspace iteration otherwise.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a), min=1e-30)


def power_rank1(y: torch.Tensor, iters: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dominant singular triple (sigma, u, v) of ``y`` by power
    iteration, started from the normalised column-abs-sum vector."""
    y = y.float()
    v = _unit(y.abs().sum(0))
    for _ in range(iters):
        u = _unit(y @ v)
        v = _unit(y.T @ u)
    u = y @ v
    sigma = torch.linalg.vector_norm(u)
    u = u / torch.clamp(sigma, min=1e-30)
    return sigma, u, v


def subspace_svd(y: torch.Tensor, r: int, iters: int = 24
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-r singular triples by orthogonal (subspace) iteration from a
    deterministic DCT-like start on the column sums. Returns (sigmas
    (r,), U (Do, r), V (Di, r))."""
    y = y.float()
    d_out, d_in = y.shape
    r = min(r, d_out, d_in)
    k = torch.arange(d_in, dtype=torch.float32, device=y.device)[:, None]
    j = torch.arange(r, dtype=torch.float32, device=y.device)[None, :]
    v0 = torch.cos(math.pi * (k + 0.5) * j / d_in) \
        * (1.0 + y.abs().sum(0))[:, None]
    q = torch.linalg.qr(v0).Q
    for _ in range(iters):
        qz = torch.linalg.qr(y @ q).Q
        q = torch.linalg.qr(y.T @ qz).Q
    ub, s, vtb = torch.linalg.svd(y @ q, full_matrices=False)
    return s[:r], ub[:, :r], q @ vtb.T[:, :r]


def truncated_svd(y: torch.Tensor, r: int, iters: int = 32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-r SVD: power iteration at r = 1, the exact SVD when the larger
    side is at most 1024, subspace iteration otherwise."""
    if r == 1:
        s, u, v = power_rank1(y, iters=max(iters, 48))
        return s[None], u[:, None], v[:, None]
    if max(y.shape) <= 1024:
        u, s, vt = torch.linalg.svd(y.float(), full_matrices=False)
        return s[:r], u[:, :r], vt[:r].T
    return subspace_svd(y, r, iters=iters)


def slab_rank1_factors(y_abs: torch.Tensor, iters: int = 64
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. (6): U = sqrt(sigma0) u0, V = sqrt(sigma0) v0 of |Y_BL|,
    clipped to the non-negative orthant."""
    sigma, u, v = power_rank1(y_abs, iters=iters)
    root = torch.sqrt(torch.clamp(sigma, min=0.0))
    return torch.clamp(u, min=0.0) * root, torch.clamp(v, min=0.0) * root


def low_rank_matrix(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W_L = U V^T for (Do, r), (Di, r) factors (r may be 1)."""
    if u.dim() == 1:
        u = u[:, None]
    if v.dim() == 1:
        v = v[:, None]
    return u @ v.T
