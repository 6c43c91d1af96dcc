"""Activation-aware pruning scores (port of ``repro.core.scores``).

Paper Algorithm 1, line 3: ``S_X = diag(sqrt(X^T X))``, the column-wise
L2 norm of the calibration activations feeding a linear layer.
"""
from __future__ import annotations

from typing import Optional

import torch


def wanda_score(w: torch.Tensor, act_norms: torch.Tensor) -> torch.Tensor:
    """S_ij = |W_ij| * ||X_j||_2 (Wanda); ``act_norms`` is (D_in,)."""
    return w.float().abs() * act_norms.float()[None, :]


def magnitude_score(w: torch.Tensor) -> torch.Tensor:
    return w.float().abs()


def weighted_fro_error(w: torch.Tensor, w_hat: torch.Tensor,
                       act_norms: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """||(W - W_hat) diag(n)||_F (plain Frobenius when act_norms is None)."""
    d = (w - w_hat).float()
    if act_norms is not None:
        d = d * act_norms.float()[None, :]
    return torch.sqrt((d * d).sum())
