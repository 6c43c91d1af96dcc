"""Pluggable per-linear weight compressors (port of
``repro.core.compressor``): the protocol, the registry, ``slab`` and the
paper's baselines.

A ``Compressor`` turns one (D_out, D_in) weight plus its tapped
calibration statistics into a ``CompressedLinear``: a dense equivalent,
the structured decomposition for the packed kernel path, and the
measured compression ratio. ``needs`` names the statistics the pipeline
must tap for it (a subset of {"norms", "hessian"}), so a method that
does not use X^T X never pays for the Gram accumulation.

Built-ins: ``slab`` (Algorithm 1 and its Table III ablations), the
baselines ``wanda`` / ``magnitude`` / ``sparsegpt``, ``hassle`` (a
HASSLE-free-style alternating sparse + low-rank decomposition in the
X^T X metric) and ``sola`` (a soft-thresholded activation-aware pruner).
Pruners return a sparse-only decomposition, so their layers pack too.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, NamedTuple, Optional, Type

import torch

from repro_torch.core import baselines as base_lib
from repro_torch.core import sparsity as sparsity_lib
from repro_torch.core.slab import (SLaBConfig, SLaBDecomposition,
                                   compression_ratio, keep_fraction,
                                   reconstruct, slab_decompose)


class LinearStats(NamedTuple):
    """norms: (D_in,) ‖X_j‖₂ column norms, or None if not collected;
    hessian: (D_in, D_in) Gram matrix X^T X, or None unless the
    compressor's ``needs`` asked for it."""

    norms: Optional[torch.Tensor] = None
    hessian: Optional[torch.Tensor] = None


class CompressedLinear(NamedTuple):
    """dense: (D_out, D_in) fp32 dense equivalent; dec: decomposition for
    the packed path (None = dense only); cr: measured compression ratio."""

    dense: torch.Tensor
    dec: Optional[SLaBDecomposition] = None
    cr: Optional[float] = None


class Compressor:
    """Protocol: subclasses set ``needs`` and implement ``compress``;
    ``scfg`` carries the per-rule hyper-parameters, extra keyword options
    go to ``__init__``."""

    name: str = ""
    needs: FrozenSet[str] = frozenset()

    def __init__(self, scfg: SLaBConfig = SLaBConfig()):
        self.scfg = scfg

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        raise NotImplementedError

    def keep_fraction_for(self, cr: float, d_out: int, d_in: int) -> float:
        """Fraction of W_S entries this method keeps at compression ratio
        ``cr`` on a (d_out, d_in) matrix: the budget allocator's probe
        hook (``core.allocator``). The base is pure pruning (survivors
        keep their full bit-width); methods that spend budget on binary
        or low-rank terms override. <= 0 means ``cr`` is infeasible."""
        return 1.0 - cr


_REGISTRY: Dict[str, Type[Compressor]] = {}


def register(name: str):
    """Class decorator: ``@register("mymethod")``."""

    def deco(cls: Type[Compressor]) -> Type[Compressor]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str, scfg: SLaBConfig = SLaBConfig(), **kw) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; "
                       f"available: {available()}")
    return _REGISTRY[name](scfg, **kw)


def available() -> list:
    return sorted(_REGISTRY)


def _pruned_cr(dense: torch.Tensor) -> float:
    """Measured CR of a pruning-only result: the zero fraction."""
    return float((dense == 0).float().mean())


def _sparse_only_dec(w_s: torch.Tensor) -> SLaBDecomposition:
    """A decomposition with no binary or low-rank term: zero-width u / v
    and a (0, 0) w_b."""
    d_out, d_in = w_s.shape
    dev = w_s.device
    return SLaBDecomposition(
        w_s=w_s,
        u=torch.zeros((d_out, 0), dtype=torch.float32, device=dev),
        v=torch.zeros((d_in, 0), dtype=torch.float32, device=dev),
        w_b=torch.zeros((0, 0), dtype=torch.int8, device=dev))


def _norms_or_ones(stats: LinearStats, d_in: int, device) -> torch.Tensor:
    if stats.norms is not None:
        return stats.norms.float()
    return torch.ones(d_in, dtype=torch.float32, device=device)


@register("slab")
class SLaBCompressor(Compressor):
    """Paper Algorithm 1: W ≈ W_S + W_L ⊙ W_B (incl. ablation modes)."""

    needs = frozenset({"norms"})

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        dec = slab_decompose(w, stats.norms, self.scfg)
        return CompressedLinear(reconstruct(dec), dec,
                                compression_ratio(dec, self.scfg.bits))

    def keep_fraction_for(self, cr: float, d_out: int, d_in: int) -> float:
        try:
            return keep_fraction(cr, self.scfg.bits, d_out, d_in,
                                 rank=self.scfg.rank,
                                 include_binary=self.scfg.include_binary,
                                 include_lowrank=self.scfg.include_lowrank)
        except ValueError:
            return 0.0


@register("wanda")
class WandaCompressor(Compressor):
    """|W| · ‖X‖₂ scoring, no weight update (Sun et al. 2023)."""

    needs = frozenset({"norms"})

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        an = _norms_or_ones(stats, w.shape[1], w.device)
        out = base_lib.wanda_prune(w, an, 1.0 - self.scfg.cr,
                                   group=self.scfg.group,
                                   pattern=self.scfg.pattern)
        return CompressedLinear(out, _sparse_only_dec(out), _pruned_cr(out))


@register("magnitude")
class MagnitudeCompressor(Compressor):
    """|W| scoring; needs no calibration statistics at all."""

    needs = frozenset()

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        out = base_lib.magnitude_prune(w, 1.0 - self.scfg.cr,
                                       group=self.scfg.group,
                                       pattern=self.scfg.pattern)
        return CompressedLinear(out, _sparse_only_dec(out), _pruned_cr(out))


@register("sparsegpt")
class SparseGPTCompressor(Compressor):
    """Hessian-aware OBS pruning with error propagation."""

    needs = frozenset({"hessian"})

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        if stats.hessian is None:
            raise ValueError("sparsegpt needs the tapped X^T X Hessian")
        out = base_lib.sparsegpt_prune(w, stats.hessian, 1.0 - self.scfg.cr,
                                       pattern=self.scfg.pattern)
        return CompressedLinear(out, _sparse_only_dec(out), _pruned_cr(out))


@register("hassle")
class HassleFreeCompressor(Compressor):
    """HASSLE-free-style alternating sparse + low-rank decomposition,
    W ≈ W_S + U Vᵀ with no binary term (Makni et al. 2025). Both steps
    are solved in the calibration metric H = X^T X = L_c L_cᵀ:

      L-step: rank-r truncated SVD of (W − W_S) L_c, mapped back
              through L_c⁻¹;
      S-step: SparseGPT pruning of W − U Vᵀ under the same Hessian, at
              the Eq.-10 keep fraction that charges U and V to the CR.

    Runs in float64 on the weight's device, as the reference does in
    numpy; ``alt_iters`` rounds of one SVD and one SparseGPT sweep."""

    needs = frozenset({"norms", "hessian"})

    def __init__(self, scfg: SLaBConfig = SLaBConfig(),
                 alt_iters: int = 3, percdamp: float = 0.01):
        super().__init__(scfg)
        self.alt_iters = int(alt_iters)
        self.percdamp = float(percdamp)

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        if stats.hessian is None:
            raise ValueError("hassle needs the tapped X^T X Hessian")
        d_out, d_in = w.shape
        r = max(self.scfg.rank, 1)
        frac = keep_fraction(self.scfg.cr, self.scfg.bits, d_out, d_in,
                             rank=r, include_binary=False,
                             include_lowrank=True)
        h = stats.hessian.double().clone()
        dead = torch.diagonal(h) == 0
        dead_ids = dead.nonzero().squeeze(1)
        h[dead_ids, dead_ids] = 1.0
        diag_ids = torch.arange(d_in, device=h.device)
        h[diag_ids, diag_ids] += self.percdamp * float(torch.diagonal(h).mean())
        lc = torch.linalg.cholesky(h)                    # H = L_c L_cᵀ

        w64 = w.double().clone()
        w64[:, dead] = 0.0
        w_s = torch.zeros_like(w64)
        low = torch.zeros_like(w64)
        u_f = torch.zeros((d_out, r), dtype=torch.float64, device=w.device)
        v_f = torch.zeros((d_in, r), dtype=torch.float64, device=w.device)
        for _ in range(max(self.alt_iters, 1)):
            um, sv, vtm = torch.linalg.svd((w64 - w_s) @ lc,
                                           full_matrices=False)
            um, sv, vtm = um[:, :r], sv[:r], vtm[:r]
            mr = (um * sv[None, :]) @ vtm                # (D_out, D_in)
            low = torch.linalg.solve(lc.T, mr.T).T       # M_r L_c⁻¹
            root = torch.sqrt(torch.clamp(sv, min=0.0))
            u_f = um * root[None, :]
            v_f = torch.linalg.solve(lc.T, vtm.T) * root[None, :]
            w_s = base_lib.sparsegpt_prune(
                (w64 - low).float(), h.float(), frac,
                pattern=self.scfg.pattern, percdamp=self.percdamp).double()

        dec = SLaBDecomposition(
            w_s=w_s.float(), u=u_f.float(), v=v_f.float(),
            w_b=torch.zeros((0, 0), dtype=torch.int8, device=w.device))
        return CompressedLinear((w_s + low).float(), dec,
                                compression_ratio(dec, self.scfg.bits))

    def keep_fraction_for(self, cr: float, d_out: int, d_in: int) -> float:
        try:
            return keep_fraction(cr, self.scfg.bits, d_out, d_in,
                                 rank=max(self.scfg.rank, 1),
                                 include_binary=False, include_lowrank=True)
        except ValueError:
            return 0.0


@register("sola")
class SoLACompressor(Compressor):
    """SoLA-style soft activation-aware sparsity. The Wanda score
    s = |W| · ‖X‖₂ picks the kept positions, and the survivors pass
    through the score-space soft threshold

        w_ij ← sign(w_ij) · (|w_ij| − softness · λ / ‖X_j‖₂)₊

    with λ the smallest kept score. ``softness=0`` is ``wanda``; it stays
    < 1 so that every survivor stays non-zero and the support (hence the
    packed variant) equals Wanda's."""

    needs = frozenset({"norms"})

    def __init__(self, scfg: SLaBConfig = SLaBConfig(),
                 softness: float = 0.5):
        super().__init__(scfg)
        if not 0.0 <= softness < 1.0:
            raise ValueError(f"softness must be in [0, 1), got {softness}")
        self.softness = float(softness)

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        an = torch.clamp(_norms_or_ones(stats, w.shape[1], w.device),
                         min=1e-12)
        w32 = w.float()
        s = w32.abs() * an[None, :]
        mask = sparsity_lib.prune_mask(s, 1.0 - self.scfg.cr,
                                       group=self.scfg.group,
                                       pattern=self.scfg.pattern)
        lam = torch.where(mask, s, torch.full_like(s, float("inf"))).min()
        shrink = self.softness * lam / an[None, :]
        out = torch.where(
            mask, torch.sign(w32) * torch.clamp(w32.abs() - shrink, min=0.0),
            torch.zeros_like(w32))
        return CompressedLinear(out, _sparse_only_dec(out), _pruned_cr(out))
