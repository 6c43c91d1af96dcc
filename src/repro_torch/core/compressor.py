"""Pluggable per-linear weight compressors (port of
``repro.core.compressor``): the protocol, the registry and ``slab``.

A ``Compressor`` turns one (D_out, D_in) weight plus its tapped
calibration statistics into a ``CompressedLinear``: a dense equivalent,
the structured decomposition for the packed kernel path, and the
measured compression ratio.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Type

import torch

from repro_torch.core.slab import (SLaBConfig, SLaBDecomposition,
                                   compression_ratio, reconstruct,
                                   slab_decompose)


class LinearStats(NamedTuple):
    """norms: (D_in,) ‖X_j‖₂ column norms, or None if not collected."""

    norms: Optional[torch.Tensor] = None


class CompressedLinear(NamedTuple):
    """dense: (D_out, D_in) fp32 dense equivalent; dec: decomposition for
    the packed path (None = dense only); cr: measured compression ratio."""

    dense: torch.Tensor
    dec: Optional[SLaBDecomposition] = None
    cr: Optional[float] = None


class Compressor:
    """Protocol: subclasses implement ``compress``; ``scfg`` carries the
    per-rule hyper-parameters."""

    name: str = ""

    def __init__(self, scfg: SLaBConfig = SLaBConfig()):
        self.scfg = scfg

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        raise NotImplementedError


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


@register("slab")
class SLaBCompressor(Compressor):
    """Paper Algorithm 1: W ≈ W_S + W_L ⊙ W_B."""

    def compress(self, w: torch.Tensor, stats: LinearStats
                 ) -> CompressedLinear:
        dec = slab_decompose(w, stats.norms, self.scfg)
        return CompressedLinear(reconstruct(dec), dec,
                                compression_ratio(dec, self.scfg.bits))

