"""SLaB: Sparse-Lowrank-Binary decomposition, paper Algorithm 1 (port of
``repro.core.slab``, with the ablation modes of Table III).

    W  ≈  W_S + W_L ⊙ W_B,    W_L = U Vᵀ (rank-r, ≥ 0),  W_B ∈ {±1}

Each alternating iteration:
    W_B ← sign(W − W_S)                      (sign(0) := +1)
    U,V ← rank-1 truncated SVD of |W − W_S|
    S   ← |W − UVᵀ ⊙ W_B| ⊙ ‖X‖₂
    W_S ← mask_topk(S) ⊙ (W − UVᵀ ⊙ W_B)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import lowrank, scores, sparsity


@dataclasses.dataclass(frozen=True)
class SLaBConfig:
    """Hyper-parameters of the decomposition (paper §II-B)."""

    cr: float = 0.5                 # compression ratio (Eq. 9)
    bits: int = 16                  # bit-width b of W_S values and U/V
    iters: int = 20                 # alternating-optimization steps
    group: Tuple[int, int] = (1, 0)  # comparison group (1, D_in)
    pattern: Optional[str] = None   # "2:4" | "4:8" | None (unstructured)
    rank: int = 1
    # Ablation switches (Table III):
    include_binary: bool = True     # False -> W_S + W_L (signed low rank)
    include_lowrank: bool = True    # False with include_binary -> W_S only
    factor_mode: bool = False       # True -> W_S + factor-vector ⊙ W_B
    svd_iters: int = 48


class SLaBDecomposition(NamedTuple):
    """w_s (D_out, D_in) dense-masked; u (D_out, r); v (D_in, r);
    w_b (D_out, D_in) int8 in {+1, -1}."""

    w_s: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w_b: torch.Tensor


def keep_fraction(cr: float, bits: int, d_out: int, d_in: int, *,
                  rank: int = 1, include_binary: bool = True,
                  include_lowrank: bool = True) -> float:
    """Paper Eq. (10): k/(Do·Di) = 1 − CR − 1/b − r(1/Do + 1/Di); the 1/b
    term pays for the 1-bit binary matrix, the r(…) terms for U and V.
    Ablation variants drop the terms of components they do not store."""
    f = 1.0 - cr
    if include_binary:
        f -= 1.0 / bits
    if include_lowrank:
        f -= rank * (1.0 / d_out + 1.0 / d_in)
    if f <= 0:
        raise ValueError(
            f"CR={cr} infeasible for shape ({d_out},{d_in}) at b={bits}")
    return f


def compressed_bits(dec: SLaBDecomposition, bits: int = 16) -> int:
    """Exact storage cost in bits (Eq. 9 numerator)."""
    total = int((dec.w_s != 0).sum()) * bits
    if dec.w_b is not None and dec.w_b.numel():
        total += dec.w_b.shape[0] * dec.w_b.shape[1]
    if dec.u is not None and dec.u.numel():
        r = dec.u.shape[1] if dec.u.dim() > 1 else 1
        total += bits * r * (dec.u.shape[0] + dec.v.shape[0])
    return total


def compression_ratio(dec: SLaBDecomposition, bits: int = 16) -> float:
    d_out, d_in = dec.w_s.shape
    return 1.0 - compressed_bits(dec, bits) / (bits * d_out * d_in)


def low_rank_times_binary(dec: SLaBDecomposition) -> torch.Tensor:
    """W_L ⊙ W_B (zero when a term is absent)."""
    d_out, d_in = dec.w_s.shape
    if dec.u is None or not dec.u.numel():
        lr = torch.zeros((d_out, d_in), dtype=torch.float32,
                         device=dec.w_s.device)
    else:
        lr = lowrank.low_rank_matrix(dec.u, dec.v)
    if dec.w_b is None or not dec.w_b.numel():
        return lr
    return lr * dec.w_b.float()


def reconstruct(dec: SLaBDecomposition) -> torch.Tensor:
    """Ŵ = W_S + W_L ⊙ W_B."""
    return dec.w_s.float() + low_rank_times_binary(dec)


def _fit_residual(y_bl: torch.Tensor, cfg: SLaBConfig):
    """(u, v, w_b) fitted to the residual Y_BL = W − W_S under cfg's
    ablation flags; absent components are empty tensors."""
    d_out, d_in = y_bl.shape
    f32 = y_bl.float()
    dev = y_bl.device
    empty_u = torch.zeros((d_out, 0), dtype=torch.float32, device=dev)
    empty_v = torch.zeros((d_in, 0), dtype=torch.float32, device=dev)
    empty_b = torch.zeros((0, 0), dtype=torch.int8, device=dev)
    if not cfg.include_lowrank and not cfg.include_binary:
        return empty_u, empty_v, empty_b
    if cfg.include_binary:
        w_b = torch.where(f32 >= 0, 1, -1).to(torch.int8)   # sign(0) := +1
        if not cfg.include_lowrank:
            return empty_u, empty_v, w_b
        y_abs = f32.abs()
        if cfg.factor_mode:
            # Table III "factor ⊙ W_B": a per-row scale, rank 1 with v = 1
            return (y_abs.mean(1, keepdim=True),
                    torch.ones((d_in, 1), dtype=torch.float32, device=dev),
                    w_b)
        if cfg.rank == 1:
            u, v = lowrank.slab_rank1_factors(y_abs, iters=cfg.svd_iters)
            return u[:, None], v[:, None], w_b
        s, u, v = lowrank.truncated_svd(y_abs, cfg.rank, iters=cfg.svd_iters)
        root = torch.sqrt(torch.clamp(s, min=0.0))
        return u * root[None, :], v * root[None, :], w_b
    # low rank only (Table III "W_S + W_L"): signed SVD, no binary term
    s, u, v = lowrank.truncated_svd(f32, cfg.rank, iters=cfg.svd_iters)
    root = torch.sqrt(torch.clamp(s, min=0.0))
    return u * root[None, :], v * root[None, :], empty_b


def slab_decompose(w: torch.Tensor, act_norms: Optional[torch.Tensor],
                   cfg: SLaBConfig = SLaBConfig()) -> SLaBDecomposition:
    """Run Algorithm 1 on one (D_out, D_in) weight matrix. ``act_norms``
    is diag(sqrt(X^T X)); None falls back to all-ones."""
    d_out, d_in = w.shape
    w32 = w.float()
    if act_norms is None:
        act_norms = torch.ones(d_in, dtype=torch.float32, device=w.device)
    act_norms = act_norms.float()
    frac = keep_fraction(cfg.cr, cfg.bits, d_out, d_in, rank=cfg.rank,
                         include_binary=cfg.include_binary,
                         include_lowrank=cfg.include_lowrank)
    w_s = torch.zeros_like(w32)
    u = v = w_b = None
    for _ in range(max(cfg.iters, 1)):
        u, v, w_b = _fit_residual(w32 - w_s, cfg)
        y_s = w32 - low_rank_times_binary(SLaBDecomposition(w_s, u, v, w_b))
        s = y_s.abs() * act_norms[None, :]
        mask = sparsity.prune_mask(s, frac, group=cfg.group,
                                   pattern=cfg.pattern)
        w_s = torch.where(mask, y_s, torch.zeros_like(y_s))
    return SLaBDecomposition(w_s.to(w.dtype), u, v, w_b)


def decomposition_error(w: torch.Tensor, dec: SLaBDecomposition,
                        act_norms: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    return scores.weighted_fro_error(w.float(), reconstruct(dec), act_norms)
