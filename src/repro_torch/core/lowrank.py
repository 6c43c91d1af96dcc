"""Low-rank primitives (port of ``repro.core.lowrank``, rank-1 path).

SLaB needs the rank-1 truncated SVD of the non-negative |W - W_S|. Power
iteration from a positive start vector converges to the entry-wise
non-negative dominant pair (paper Prop. 2).
"""
from __future__ import annotations

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
