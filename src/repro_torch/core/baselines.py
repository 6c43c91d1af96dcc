"""One-shot pruning baselines the paper compares against, Table I (port of
``repro.core.baselines``).

- magnitude: |W| scores.
- Wanda (Sun et al. 2023): |W| · ‖X‖₂ scores, no weight update.
- SparseGPT (Frantar & Alistarh 2023): Hessian-aware OBS pruning with
  column-blocked weight updates. Runs in torch on the weight's device
  with the reference's precisions: float64 for the damped inverse, its
  Cholesky factor and the per-column scores, float32 for the weights
  being walked (the reference does the same in numpy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import scores as scores_lib
from repro_torch.core import sparsity


def magnitude_prune(w: torch.Tensor, keep_frac: float,
                    group: Tuple[int, int] = (1, 0),
                    pattern: Optional[str] = None) -> torch.Tensor:
    mask = sparsity.prune_mask(scores_lib.magnitude_score(w), keep_frac,
                               group, pattern)
    return torch.where(mask, w, torch.zeros_like(w))


def wanda_prune(w: torch.Tensor, act_norms: torch.Tensor, keep_frac: float,
                group: Tuple[int, int] = (1, 0),
                pattern: Optional[str] = None) -> torch.Tensor:
    mask = sparsity.prune_mask(scores_lib.wanda_score(w, act_norms),
                               keep_frac, group, pattern)
    return torch.where(mask, w, torch.zeros_like(w))


def _prune_lowest(score: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the ``k`` lowest scores of each row."""
    order = torch.argsort(score, dim=1, stable=True)[:, :k]
    mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    return mask.scatter_(1, order, True)


def sparsegpt_prune(w: torch.Tensor, hessian: torch.Tensor,
                    keep_frac: float, pattern: Optional[str] = None,
                    blocksize: int = 128,
                    percdamp: float = 0.01) -> torch.Tensor:
    """SparseGPT on one (D_out, D_in) layer; ``hessian`` = X^T X.

    Damp the Hessian, take the triangular factor of its inverse, then
    walk column blocks: pick the block's prune mask from w² / Hinv_diag²
    (unstructured: per-row lowest of the block; N:M: per m-group), zero
    the pruned weights and push their error onto the columns not yet
    visited. Each update is taken in float64 and stored in float32, as
    numpy's mixed-precision in-place updates do in the reference."""
    wd = w.float().clone()
    d_out, d_in = wd.shape
    h = hessian.double().clone()
    dead = torch.diagonal(h) == 0
    dead_ids = dead.nonzero().squeeze(1)
    h[dead_ids, dead_ids] = 1.0
    wd[:, dead] = 0.0
    diag_ids = torch.arange(d_in, device=h.device)
    h[diag_ids, diag_ids] += percdamp * float(torch.diagonal(h).mean())

    hinv = torch.linalg.inv(h)
    hinv = torch.linalg.cholesky(hinv.flip(0, 1)).flip(0, 1).T.contiguous()

    nm = sparsity.parse_pattern(pattern) if pattern is not None else None
    prune_frac = 1.0 - keep_frac

    for i1 in range(0, d_in, blocksize):
        i2 = min(i1 + blocksize, d_in)
        cnt = i2 - i1
        w_blk = wd[:, i1:i2].clone()
        err_blk = torch.zeros_like(w_blk)
        hinv_blk = hinv[i1:i2, i1:i2]
        diag = torch.diagonal(hinv_blk).clone()
        diag[diag == 0] = 1e-8

        mask_prune = torch.zeros(w_blk.shape, dtype=torch.bool,
                                 device=w_blk.device)
        if nm is None:
            k_prune = int(round(prune_frac * cnt))
            if k_prune > 0:
                score = (w_blk ** 2).double() / diag[None, :] ** 2
                mask_prune = _prune_lowest(score, k_prune)

        for j in range(cnt):
            if nm is not None and j % nm[1] == 0:
                m = nm[1]
                sub = ((w_blk[:, j:j + m] ** 2).double()
                       / diag[None, j:j + m] ** 2)
                mask_prune[:, j:j + m] = _prune_lowest(sub, m - nm[0])
            col = w_blk[:, j]
            q = torch.where(mask_prune[:, j], torch.zeros_like(col), col)
            e = (col - q).double() / diag[j]
            w_blk[:, j:] = (w_blk[:, j:].double()
                            - torch.outer(e, hinv_blk[j, j:])).float()
            w_blk[:, j] = q
            err_blk[:, j] = e.float()

        wd[:, i1:i2] = w_blk
        if i2 < d_in:
            wd[:, i2:] = (wd[:, i2:].double()
                          - err_blk.double() @ hinv[i1:i2, i2:]).float()
    return wd.to(w.dtype)
