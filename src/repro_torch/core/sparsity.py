"""Sparsification primitives (port of ``repro.core.sparsity``):
comparison-group top-k and N:M semi-structured masks.

Ties break by lower index, exactly as ``jax.lax.top_k`` does: the top-k
comes from a *stable* descending sort (``torch.topk`` leaves the tie
order unspecified).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _exact_topk_mask_rows(scores2d: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k mask per row of a 2-D score array (ties by index)."""
    if k <= 0:
        return torch.zeros_like(scores2d, dtype=torch.bool)
    if k >= scores2d.shape[1]:
        return torch.ones_like(scores2d, dtype=torch.bool)
    order = torch.sort(scores2d, dim=1, descending=True, stable=True).indices
    mask = torch.zeros_like(scores2d, dtype=torch.bool)
    return mask.scatter_(1, order[:, :k], True)


def group_topk_mask(scores: torch.Tensor, keep_frac: float,
                    group: Tuple[int, int] = (1, 0)) -> torch.Tensor:
    """Keep the top ``floor(keep_frac * group_size)`` scores inside each
    ``(g_rows, g_cols)`` group (0 = the full extent of that dim)."""
    d_out, d_in = scores.shape
    g_rows = group[0] or d_out
    g_cols = group[1] or d_in
    if d_out % g_rows or d_in % g_cols:
        g_rows = math.gcd(g_rows, d_out)
        g_cols = math.gcd(g_cols, d_in)
    gsz = g_rows * g_cols
    k = int(math.floor(keep_frac * gsz))
    s = scores.reshape(d_out // g_rows, g_rows, d_in // g_cols, g_cols)
    s = s.permute(0, 2, 1, 3).reshape(-1, gsz)
    m = _exact_topk_mask_rows(s, k)
    m = m.reshape(d_out // g_rows, d_in // g_cols, g_rows, g_cols)
    return m.permute(0, 2, 1, 3).reshape(d_out, d_in)


def nm_mask(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Keep the n best of every m consecutive elements along D_in."""
    d_out, d_in = scores.shape
    if d_in % m:
        raise ValueError(f"D_in={d_in} not divisible by m={m}")
    mask = _exact_topk_mask_rows(scores.reshape(-1, m), n)
    return mask.reshape(d_out, d_in)


def parse_pattern(pattern: str) -> Tuple[int, int]:
    n, m = pattern.split(":")
    return int(n), int(m)


def prune_mask(scores: torch.Tensor, keep_frac: float,
               group: Tuple[int, int] = (1, 0),
               pattern: Optional[str] = None) -> torch.Tensor:
    """Optional N:M pre-mask, then group top-k among survivors (pruned
    entries get a -inf score so they are never re-kept)."""
    scores = scores.float()
    if pattern is not None:
        n, m = parse_pattern(pattern)
        if keep_frac > n / m + 1e-9:
            raise ValueError(
                f"keep_frac={keep_frac:.4f} exceeds the {pattern} "
                f"ceiling {n}/{m}")
        pre = nm_mask(scores, n, m)
        scores = torch.where(pre, scores, torch.full_like(scores,
                                                          -math.inf))
    return group_topk_mask(scores, keep_frac, group)



def mask_nnz_per_row_uniform(mask: torch.Tensor) -> Optional[int]:
    """The nnz every row has, when every row has the same (true for
    (1, D_in) comparison groups), else None. Decides ELL packability."""
    nnz = mask.sum(1)
    first = int(nnz[0])
    return first if bool((nnz == first).all()) else None
