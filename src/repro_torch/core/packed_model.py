"""Packed-weight serving (port of ``repro.core.packed_model``, the
per-linear variants of the dense serve path).

Every compressed linear lives in an on-device packed format and forwards
through a hand-written CUDA kernel, picked by the variant tag:

  variant        terms                        kernel
  -------------  ---------------------------  --------------------------
  slab-ell       ELL W_S + W_B ⊙ rank-r UV    kernels.ops.slab_ell_matmul
  slab-nm        N:M W_S + W_B ⊙ rank-r UV    kernels.ops.slab_nm_matmul
  slab-dense     dense W_S + W_B ⊙ rank-r UV  kernels.ops.slab_matmul
  lowrank-ell    ELL W_S + rank-r UV          kernels.ops.ell_lr_matmul
  lowrank-dense  dense W_S + rank-r UV        kernels.ops.slab_lr_matmul
  sparse-ell     ELL W_S                      kernels.ops.ell_matmul
  sparse-nm      N:M W_S                      kernels.ops.nm_matmul
  sparse-dense   dense W_S                    x @ W_Sᵀ (a plain matmul)
  lowrank-nm     N:M W_S + rank-r UV          kernels.ops.slab_nm_lr_matmul
  binlr          W_B ⊙ rank-r UV              kernels.ops.binlr
  lowrank        rank-r UV                    (x @ V) @ Uᵀ (two matmuls)

Unstructured sparse parts route to row-padded ELL whenever it wins on
bytes at the serving dtype (``packing.ell_wins_bytes``), else they stay
dense-masked. ``PackedStack`` is not ported: the port keeps one
PackedLinear per layer.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.packing import (ell_pack, ell_row_nnz_max,
                                      ell_wins_bytes, pack_nm,
                                      pack_sign_bits)
from repro_torch.core.slab import SLaBDecomposition
from repro_torch.models.common import tap_record

VARIANTS = ("slab-nm", "slab-dense", "slab-ell", "binlr", "lowrank-nm",
            "lowrank-dense", "lowrank-ell", "lowrank", "sparse-nm",
            "sparse-dense", "sparse-ell")


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """One compressed linear, model orientation: computes x @ Wᵀ for the
    paper's (D_out, D_in) W, a drop-in for x @ w with w (D_in, D_out).
    Planes a variant does not store are None.

    sparse_vals : (D_out, D_in) dense-masked W_S, (D_out, D_in/m, n) N:M
                  values, or (D_out, K_max) ELL values.
    sparse_idx  : (D_out, D_in/m, n) int8 N:M positions, (D_out, K_max)
                  ELL column ids (uint16 bits in int16), or None.
    b_packed    : (D_out, D_in/32) sign words (uint32 bits in int32).
    u, v        : (D_out, r) / (D_in, r) low-rank factors.
    """

    sparse_vals: Optional[torch.Tensor]
    sparse_idx: Optional[torch.Tensor]
    b_packed: Optional[torch.Tensor]
    u: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    variant: str = "slab-dense"
    m_pat: int = 0
    d_in: int = 0
    d_out: int = 0
    rank: int = 0

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.sparse_vals, self.sparse_idx,
                             self.b_packed, self.u, self.v)
                   if a is not None)


def _dec_rank(dec: SLaBDecomposition) -> int:
    if dec.u is None or not dec.u.numel():
        return 0
    return dec.u.shape[1] if dec.u.dim() == 2 else 1


def _unstructured_kind(w_s: torch.Tensor, itemsize: Optional[int] = None,
                       k_max: Optional[int] = None) -> str:
    """"ell" when row-padded ELL beats the dense bytes of this sparse part
    at the serving value width ``itemsize``, else "dense"."""
    itemsize = w_s.element_size() if itemsize is None else itemsize
    if k_max is None:
        k_max = ell_row_nnz_max(w_s)
    return "ell" if ell_wins_bytes(k_max, w_s.shape[1], itemsize) \
        else "dense"


def variant_of(dec: SLaBDecomposition, pattern: Optional[str],
               itemsize: Optional[int] = None,
               k_max: Optional[int] = None) -> Optional[str]:
    """Classify one decomposition into its packed-serving variant (None =
    not representable). The binary term counts only beside a low-rank
    factor: W_L ⊙ W_B with an empty W_L is identically zero."""
    if dec.w_s is None or dec.w_s.dim() != 2:
        return None
    rank = _dec_rank(dec)
    has_b = dec.w_b is not None and dec.w_b.numel() > 0 and rank > 0
    if not has_b and rank == 0:
        # pruning only: an all-zero W_S packs as width-1 ELL serving zeros
        kind = "nm" if pattern else _unstructured_kind(dec.w_s, itemsize,
                                                       k_max)
        return f"sparse-{kind}"
    has_s = bool(dec.w_s.numel()) and bool((dec.w_s != 0).any())
    kind = None
    if has_s:
        kind = "nm" if pattern else _unstructured_kind(dec.w_s, itemsize,
                                                       k_max)
    if has_b:
        return f"slab-{kind}" if kind else "binlr"
    return f"lowrank-{kind}" if kind else "lowrank"


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown packed variant {variant!r}")


def pack_linear(dec: SLaBDecomposition, pattern: Optional[str],
                dtype=torch.float32, variant: Optional[str] = None,
                ell_nnz: Optional[int] = None) -> PackedLinear:
    """Pack one decomposition into its variant's storage format.
    ``ell_nnz`` overrides the ELL pad width K_max."""
    d_out, d_in = dec.w_s.shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if variant is None:
        variant = variant_of(dec, pattern, itemsize=itemsize, k_max=ell_nnz)
    if variant is None:
        raise ValueError("decomposition has no packable terms")
    _check_variant(variant)
    rank = _dec_rank(dec)
    u = v = bp = vals = idx = None
    m_pat = 0
    if rank:
        u = (dec.u if dec.u.dim() == 2 else dec.u[:, None]).to(dtype)
        v = (dec.v if dec.v.dim() == 2 else dec.v[:, None]).to(dtype)
    if variant.startswith("slab-") or variant == "binlr":
        bp = pack_sign_bits(dec.w_b)
    if variant.endswith("-nm"):
        n, m_pat = map(int, pattern.split(":"))
        nm = pack_nm(dec.w_s.to(dtype), n, m_pat, strict=True)
        vals, idx = nm.values, nm.indices
    elif variant.endswith("-ell"):
        ep = ell_pack(dec.w_s.to(dtype), nnz=ell_nnz)
        vals, idx = ep.values, ep.indices
    elif variant.endswith("-dense") or variant.startswith("sparse"):
        vals = dec.w_s.to(dtype)

    def plane(a):
        return None if a is None else a.contiguous()

    return PackedLinear(plane(vals), plane(idx), plane(bp), plane(u),
                        plane(v), variant=variant, m_pat=m_pat, d_in=d_in,
                        d_out=d_out, rank=rank)


def packed_matmul(x: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    """x (..., D_in) @ Wᵀ through the variant's kernel wrapper."""
    from repro_torch.kernels import ops
    var = w.variant
    _check_variant(var)
    if var == "slab-ell":
        y = ops.slab_ell_matmul(x, w.sparse_vals, w.sparse_idx, w.b_packed,
                                w.u, w.v)
    elif var == "slab-nm":
        y = ops.slab_nm_matmul(x, w.sparse_vals, w.sparse_idx, w.m_pat,
                               w.b_packed, w.u, w.v)
    elif var == "slab-dense":
        y = ops.slab_matmul(x, w.sparse_vals, w.b_packed, w.u, w.v)
    elif var == "lowrank-ell":
        y = ops.ell_lr_matmul(x, w.sparse_vals, w.sparse_idx, w.u, w.v)
    elif var == "lowrank-dense":
        y = ops.slab_lr_matmul(x, w.sparse_vals, w.u, w.v)
    elif var == "lowrank-nm":
        y = ops.slab_nm_lr_matmul(x, w.sparse_vals, w.sparse_idx, w.m_pat,
                                  w.u, w.v)
    elif var == "binlr":
        y = ops.binlr(x, w.b_packed, w.u, w.v)
    elif var == "sparse-ell":
        y = ops.ell_matmul(x, w.sparse_vals, w.sparse_idx)
    elif var == "sparse-nm":
        y = ops.nm_matmul(x, w.sparse_vals, w.sparse_idx, w.m_pat)
    elif var == "sparse-dense":
        # dense-masked bytes equal dense bytes: a plain matmul is the serve
        y = x @ w.sparse_vals.to(x.dtype).T
    else:
        # lowrank: r(D_in + D_out) weights per token, already minimal
        y = (x.float() @ w.v.float()) @ w.u.float().T
    return y.to(x.dtype)


def linear(x: torch.Tensor, w, tap: Optional[str] = None) -> torch.Tensor:
    """Dispatch point used by the model layers: dense ``x @ w`` or the
    packed kernel. ``tap`` names this linear for activation capture."""
    if tap is not None:
        tap_record(tap, x)
    if isinstance(w, PackedLinear):
        return packed_matmul(x, w)
    return x @ w


# ------------------------------------------------------------------
# Whole-model packing
# ------------------------------------------------------------------

class PackReport(NamedTuple):
    """What pack_model did: packed-linear counts per variant, the packed
    paths, and per-variant (packed, dense) bytes per linear."""
    n_packed: int
    by_variant: Dict[str, int]
    paths: List[str]
    bytes_by_variant: Dict[str, Tuple[float, float]]


def pack_model(params: dict,
               decs: Dict[Tuple[int, str], SLaBDecomposition],
               pattern: Optional[str] = None,
               dtype=torch.float32) -> Tuple[dict, PackReport]:
    """Replace every decomposed linear of the per-layer params with its
    PackedLinear at the serving ``dtype``. ``decs`` comes from
    ``core.pipeline.compress_model(keep_decompositions=True)``. Returns
    (params, PackReport); the input params are not modified."""
    from repro_torch.core.pipeline import _copy_tree, _get, _set
    out = dict(params)
    out["layers"] = _copy_tree(params["layers"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    by_variant: Dict[str, int] = {}
    agg: Dict[str, List[float]] = {}
    paths: List[str] = []
    for (l, name) in sorted(decs, key=lambda k: (k[1], k[0])):
        dec = decs[(l, name)]
        old = _get(out["layers"][l], name)
        k_max = None if pattern else ell_row_nnz_max(dec.w_s)
        var = variant_of(dec, pattern, itemsize=itemsize, k_max=k_max)
        pl = pack_linear(dec, pattern, dtype, variant=var,
                         ell_nnz=k_max if var.endswith("-ell") else None)
        _set(out["layers"][l], name, pl)
        by_variant[var] = by_variant.get(var, 0) + 1
        a = agg.setdefault(var, [0.0, 0.0, 0])
        a[0] += pl.nbytes()
        a[1] += old.numel() * old.element_size()
        a[2] += 1
        if name not in paths:
            paths.append(name)
    per_linear = {var: (p / n, d / n) for var, (p, d, n) in agg.items()}
    for var, (p, d) in sorted(per_linear.items()):
        if p > d:
            warnings.warn(
                f"packed variant {var!r} stores {p / d:.2f}x its dense "
                f"bytes ({p / 1e3:.1f} kB vs {d / 1e3:.1f} kB per linear)",
                stacklevel=2)
    return out, PackReport(sum(by_variant.values()), by_variant, paths,
                           per_linear)
