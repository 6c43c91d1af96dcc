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
dense-masked. ``PackedStack`` has no class here: the port keeps one leaf
per layer (a PackedLinear, or the dense weight where a plan left the
layer dense), so each layer of a path already carries its own variant
and there is no layer scan to keep whole. The reference's segments
(maximal runs of layers with the same packed signature,
``segment_runs``) are still reported, as ``PackReport.segments``.

A 3-D MoE expert leaf packs into an ``ExpertPackedStack``: experts with
the same packed signature stack into one group (planes with a leading
expert dim) that one grouped-kernel launch serves (``expert_matmul``:
the ``kernels.ops.*_g`` form of the variant's kernel above, for every
variant but sparse-dense and lowrank, which stay batched matmuls as in
the reference); ELL experts first bucket by their realized K_max, so a
few dense experts do not widen every expert's pad.

Tensor parallelism (``runtime.sharding``): every stored plane except
``v`` leads with d_out (behind the expert dim of a stack), so a packed
leaf shards by rows on "model" (``packed_axes``); an expert stack's
groups shard by experts first. Under a mesh each rank holds its rows and
runs the variant's kernel on them, and the output features are gathered
(``linear``, ``expert_matmul``); a leaf whose d_out the mesh does not
divide is whole on every rank and runs whole. A dense weight the planner
cut over "model" is a ``meshctx.Shard`` whose spec says which dim: cut
on its output dim it runs on the rank's columns and the features are
gathered, on its input dim on the rank's rows of the contraction, the
ranks' partial products summed; dense experts cut on the expert dim run
the rank's experts, then the expert dim is gathered.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.packing import (ell_pack, ell_row_nnz_max,
                                      ell_wins_bytes, pack_nm,
                                      pack_sign_bits)
from repro_torch.core.slab import SLaBDecomposition
from repro_torch.models.common import tap_record
from repro_torch.runtime.meshctx import (Shard, current_mesh, gather_model,
                                         model_dim, model_shards,
                                         reduce_model)

# Rank threshold for sharding the low-rank u factor on "model": below it
# the (D_out, r) plane is a few KB and stays whole on every rank (each
# slices its rows at call time); at or above it u row-shards with the
# other d_out planes. v (D_in, r) always replicates.
LR_SHARD_RANK = 8

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
               k_max: Optional[int] = None,
               has_s: Optional[bool] = None) -> Optional[str]:
    """Classify one decomposition into its packed-serving variant (None =
    not representable). The binary term counts only beside a low-rank
    factor: W_L ⊙ W_B with an empty W_L is identically zero. ``has_s``
    (is the sparse part non-zero) skips that reduction when the caller
    has it already."""
    if dec.w_s is None or dec.w_s.dim() != 2:
        return None
    rank = _dec_rank(dec)
    has_b = dec.w_b is not None and dec.w_b.numel() > 0 and rank > 0
    if not has_b and rank == 0:
        # pruning only: an all-zero W_S packs as width-1 ELL serving zeros
        kind = "nm" if pattern else _unstructured_kind(dec.w_s, itemsize,
                                                       k_max)
        return f"sparse-{kind}"
    if has_s is None:
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


# ------------------------------------------------------------------
# Logical axes for the sharding planner (tensor-parallel serving)
# ------------------------------------------------------------------

def packed_linear_axes(pl: PackedLinear,
                       lr_shard_rank: int = LR_SHARD_RANK,
                       _lead: Tuple[str, ...] = ()) -> PackedLinear:
    """The logical-axes leaf of one packed linear: a PackedLinear with the
    same static fields whose planes are axes tuples. Every plane but
    ``v`` leads with d_out ("packed_out"); N:M groups and ELL rows run
    along d_in and are never split by a row shard. ``u`` shards only at
    rank >= ``lr_shard_rank``. ``_lead`` prefixes the leading axes (an
    expert stack's "experts")."""
    def ax(a, row_sharded=True):
        if a is None:
            return None
        nd = a.dim() - len(_lead)
        return _lead + ("packed_out" if row_sharded else None,) \
            + (None,) * (nd - 1)

    return dataclasses.replace(
        pl, sparse_vals=ax(pl.sparse_vals), sparse_idx=ax(pl.sparse_idx),
        b_packed=ax(pl.b_packed), u=ax(pl.u, pl.rank >= lr_shard_rank),
        v=ax(pl.v, False))


def expert_stack_axes(eps: "ExpertPackedStack",
                      lr_shard_rank: int = LR_SHARD_RANK
                      ) -> "ExpertPackedStack":
    """Axes of an ExpertPackedStack: each group's planes lead with the
    expert dim ("experts", expert parallelism) ahead of the per-plane
    "packed_out" rows; the planner drops "experts" where a group's size
    does not divide the mesh and row-shards instead. The dense remainder
    is (E_d, D_in, D_out)."""
    lead = ("experts",)
    groups = tuple(packed_linear_axes(g, lr_shard_rank, _lead=lead)
                   for g in eps.groups)
    dense = lead + (None, "packed_out") if eps.dense is not None else None
    return dataclasses.replace(eps, groups=groups, dense=dense)


def packed_axes(leaf, lr_shard_rank: int = LR_SHARD_RANK):
    """Axes of any packed leaf (PackedLinear or ExpertPackedStack)."""
    if isinstance(leaf, ExpertPackedStack):
        return expert_stack_axes(leaf, lr_shard_rank)
    return packed_linear_axes(leaf, lr_shard_rank)


def merge_packed_axes(axes_tree, params_tree):
    """A dense logical-axes tree (``lm.param_axes``) with the packed axes
    substituted wherever ``params_tree`` holds a packed leaf; the result
    feeds ``runtime.sharding.Planner.tree_specs`` unchanged."""
    if isinstance(params_tree, (PackedLinear, ExpertPackedStack)):
        return packed_axes(params_tree)
    if isinstance(params_tree, dict):
        return {k: merge_packed_axes(axes_tree[k], v)
                for k, v in params_tree.items()}
    if isinstance(params_tree, list):
        return [merge_packed_axes(a, v)
                for a, v in zip(axes_tree, params_tree)]
    return axes_tree


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


# ------------------------------------------------------------------
# MoE experts: one grouped-kernel launch per bucket of experts
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExpertPackedStack:
    """One layer's 3-D MoE leaf, packed per expert.

    ``groups[g]`` is a PackedLinear whose every plane leads with the
    experts ``members[g]`` (ascending ids); one grouped-kernel launch
    serves a group. ``dense`` holds the model-orientation (E_d, D_in,
    D_out) slices of the experts with no packable terms,
    ``dense_members``."""

    groups: Tuple[PackedLinear, ...]
    dense: Optional[torch.Tensor]
    members: Tuple[Tuple[int, ...], ...]
    dense_members: Tuple[int, ...]
    n_experts: int

    def variant_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for grp, mem in zip(self.groups, self.members):
            out[grp.variant] = out.get(grp.variant, 0) + len(mem)
        return out

    def describe(self) -> str:
        """One line: each group's variant, pad width or pattern, rank and
        expert count, then the dense members."""
        parts = []
        for grp, mem in zip(self.groups, self.members):
            d = grp.variant
            if grp.m_pat:
                d += f"({grp.sparse_vals.shape[-1]}:{grp.m_pat})"
            elif grp.variant.endswith("-ell"):
                d += f"(kmax={grp.sparse_vals.shape[-1]})"
            if grp.rank:
                d += f" r{grp.rank}"
            parts.append(f"{d} x{len(mem)}")
        if self.dense_members:
            parts.append(f"dense x{len(self.dense_members)}")
        return "experts[" + " | ".join(parts) + "]"


def _stack_group(pls: Sequence[PackedLinear]) -> PackedLinear:
    """Stack same-signature PackedLinears on a new leading expert dim."""
    def stack(name):
        a = [getattr(pl, name) for pl in pls]
        return None if a[0] is None else torch.stack(a).contiguous()

    p0 = pls[0]
    return dataclasses.replace(p0, **{n: stack(n) for n in (
        "sparse_vals", "sparse_idx", "b_packed", "u", "v")})


def _dtype_name(t: torch.Tensor) -> str:
    """The reference's dtype name of a plane: the int16 / int32 planes
    (ELL ids, sign words) are unsigned views."""
    name = str(t.dtype).replace("torch.", "")
    return {"int16": "uint16", "int32": "uint32"}.get(name, name)


def _pack_signature(pl: PackedLinear) -> Tuple:
    """Full stacking key: the metadata plus each plane's (shape, dtype),
    in the reference's terms so that sorting by ``str`` orders groups as
    the reference does."""
    aux = (pl.variant, pl.m_pat, pl.d_in, pl.d_out, pl.rank)
    leaves = tuple(None if a is None else (tuple(a.shape), _dtype_name(a))
                   for a in (pl.sparse_vals, pl.sparse_idx, pl.b_packed,
                             pl.u, pl.v))
    return aux + leaves


# How many buckets the per-expert realized ELL K_max is cut into: within
# a bucket the experts pad to the bucket's realized max, so a few dense
# experts do not widen every pad, and a leaf takes at most this many
# ELL launches.
EXPERT_KMAX_BUCKETS = 4


def pack_expert_stack(old: torch.Tensor,
                      e_decs: Sequence[SLaBDecomposition],
                      pattern: Optional[str], dtype=torch.float32
                      ) -> ExpertPackedStack:
    """Pack one layer's (E, D_in, D_out) expert leaf ``old`` from its
    per-expert (D_out, D_in) decompositions. Every expert classifies
    from one fused reduction (realized row-nnz K_max and total nnz);
    ELL experts bucket by K_max — bucket width ``ceil(max K_max /
    EXPERT_KMAX_BUCKETS)`` — and pad to their bucket's realized max. Experts
    sharing a packed signature stack into one group; groups sort by
    ``str`` of their signature, members ascend. Experts with no sparse
    plane stay dense (``old``'s slices)."""
    n_exp = len(e_decs)
    itemsize = torch.empty((), dtype=dtype).element_size()
    servable = [e for e, d in enumerate(e_decs)
                if d.w_s is not None and d.w_s.dim() == 2]
    kmaxes = [1] * n_exp
    variants: List[Optional[str]] = [None] * n_exp
    if servable:
        nz = torch.stack([e_decs[e].w_s for e in servable]) != 0
        row_nnz = nz.sum(-1).amax(-1).tolist()
        tot_nnz = nz.sum((1, 2)).tolist()
        for i, e in enumerate(servable):
            kmaxes[e] = max(1, int(row_nnz[i]))
            variants[e] = variant_of(e_decs[e], pattern, itemsize,
                                     k_max=kmaxes[e],
                                     has_s=bool(tot_nnz[i]))
    q = max(1, -(-max(kmaxes) // EXPERT_KMAX_BUCKETS))
    pads: Dict[int, int] = {}
    for e, var in enumerate(variants):
        if var is not None and var.endswith("-ell"):
            b = (kmaxes[e] - 1) // q
            pads[b] = max(pads.get(b, 0), kmaxes[e])
    by_sig: Dict[Tuple, List[Tuple[int, PackedLinear]]] = {}
    dense_members: List[int] = []
    for e, (dec, var) in enumerate(zip(e_decs, variants)):
        if var is None:
            dense_members.append(e)
            continue
        nnz = (pads[(kmaxes[e] - 1) // q] if var.endswith("-ell")
               else kmaxes[e])
        pl = pack_linear(dec, pattern, dtype, variant=var, ell_nnz=nnz)
        by_sig.setdefault(_pack_signature(pl), []).append((e, pl))
    groups, members = [], []
    for key in sorted(by_sig, key=str):
        es = by_sig[key]
        groups.append(_stack_group([pl for _, pl in es]))
        members.append(tuple(e for e, _ in es))
    dense = (torch.stack([old[e] for e in dense_members]).contiguous()
             if dense_members else None)
    return ExpertPackedStack(tuple(groups), dense, tuple(members),
                             tuple(dense_members), n_exp)


def expert_stacks(params: dict) -> List[Tuple[int, str, ExpertPackedStack]]:
    """Every ExpertPackedStack of the per-layer params, as (layer, path,
    stack)."""
    out = []
    for l, lp in enumerate(params["layers"]):
        for name, sub in sorted(lp.items()):
            if not isinstance(sub, dict):
                continue
            for leaf, w in sorted(sub.items()):
                if isinstance(w, ExpertPackedStack):
                    out.append((l, f"{name}.{leaf}", w))
    return out


def packed_matmul_grouped(x: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    """x (E, M, D_in) against an expert-stacked PackedLinear (every plane
    leads with E) -> (E, M, D_out): one grouped-kernel launch (two
    batched matmuls for the sparse-dense and lowrank variants, as in the
    reference)."""
    from repro_torch.kernels import ops
    var = w.variant
    _check_variant(var)
    if var == "slab-ell":
        y = ops.slab_ell_matmul_g(x, w.sparse_vals, w.sparse_idx,
                                  w.b_packed, w.u, w.v)
    elif var == "slab-nm":
        y = ops.slab_nm_matmul_g(x, w.sparse_vals, w.sparse_idx, w.m_pat,
                                 w.b_packed, w.u, w.v)
    elif var == "slab-dense":
        y = ops.slab_matmul_g(x, w.sparse_vals, w.b_packed, w.u, w.v)
    elif var == "lowrank-ell":
        y = ops.ell_lr_matmul_g(x, w.sparse_vals, w.sparse_idx, w.u, w.v)
    elif var == "lowrank-dense":
        y = ops.slab_lr_matmul_g(x, w.sparse_vals, w.u, w.v)
    elif var == "lowrank-nm":
        y = ops.slab_nm_lr_matmul_g(x, w.sparse_vals, w.sparse_idx, w.m_pat,
                                    w.u, w.v)
    elif var == "binlr":
        y = ops.binlr_g(x, w.b_packed, w.u, w.v)
    elif var == "sparse-ell":
        y = ops.ell_matmul_g(x, w.sparse_vals, w.sparse_idx)
    elif var == "sparse-nm":
        y = ops.nm_matmul_g(x, w.sparse_vals, w.sparse_idx, w.m_pat)
    elif var == "sparse-dense":
        # dense-masked bytes equal dense bytes: a batched matmul is the
        # serve, as in the reference
        y = torch.einsum("emk,enk->emn", x, w.sparse_vals.to(x.dtype))
    else:
        # lowrank: two skinny batched matmuls, already minimal bytes
        y = torch.einsum("emk,ekr->emr", x.float(), w.v.float())
        y = torch.einsum("emr,enr->emn", y, w.u.float())
    return y.to(x.dtype)


def _group_matmul_sharded(x: torch.Tensor, mem: Tuple[int, ...],
                          grp: PackedLinear) -> torch.Tensor:
    """One expert group on this rank's shard, under a mesh: its experts
    (expert-sharded: the rank's run of ``mem``, the expert dim gathered
    after) or its rows (row-sharded: the output features gathered
    after), or the whole group where the planner replicated it. Returns
    (len(mem), M, D_out)."""
    held = _held(grp, 0)
    if held != len(mem):
        c = model_shards()[0]
        mine = mem[c * held:(c + 1) * held]
        xg = x.index_select(0, torch.tensor(mine, device=x.device))
        return gather_model(packed_matmul_grouped(xg, grp), dim=0)
    xg = x.index_select(0, torch.tensor(mem, device=x.device))
    rows = _held(grp, 1)
    if rows == grp.d_out:
        return packed_matmul_grouped(xg, grp)
    return gather_model(packed_matmul_grouped(xg, _row_slice(grp, rows, 1)))


def expert_matmul(x: torch.Tensor, w: ExpertPackedStack) -> torch.Tensor:
    """Per-expert packed linear: x (E, M, D_in) -> (E, M, D_out), one
    grouped-kernel launch per group, the experts gathered into their
    groups and scattered back; a single group covering every expert in
    order skips the gathers. Under a mesh each group runs on this rank's
    shard (``_group_matmul_sharded``) and every expert's output is whole
    on every rank before the combine."""
    n = w.n_experts
    sharded = current_mesh() is not None
    if (len(w.groups) == 1 and not w.dense_members
            and w.members[0] == tuple(range(n)) and not sharded):
        return packed_matmul_grouped(x, w.groups[0])
    parts: List[torch.Tensor] = []
    order: List[int] = []
    for mem, grp in zip(w.members, w.groups):
        if sharded:
            parts.append(_group_matmul_sharded(x, mem, grp))
        else:
            xg = x.index_select(0, torch.tensor(mem, device=x.device))
            parts.append(packed_matmul_grouped(xg, grp))
        order.extend(mem)
    if w.dense is not None:
        xd = x.index_select(0, torch.tensor(w.dense_members,
                                            device=x.device))
        parts.append(dense_experts(xd, w.dense))
        order.extend(w.dense_members)
    y = torch.cat(parts, dim=0)
    inv = [0] * n
    for pos, eid in enumerate(order):
        inv[eid] = pos
    return y.index_select(0, torch.tensor(inv, device=x.device))


def _held(w: PackedLinear, dim: int) -> int:
    """How much of dim ``dim`` of ``w``'s row planes this rank holds (the
    d_out rows at dim 0 of a linear, 1 of an expert group; a group's
    experts at 0): read off its first row plane."""
    for a in (w.sparse_vals, w.sparse_idx, w.b_packed, w.u):
        if a is not None:
            return a.shape[dim]
    raise ValueError(f"{w.variant} leaf without planes")


def _row_slice(w: PackedLinear, rows: int, lead: int = 0) -> PackedLinear:
    """``w`` with a whole ``u`` (rank below LR_SHARD_RANK) cut to this
    rank's ``rows`` (u's row dim sits after ``lead`` leading dims)."""
    if w.u is None or w.u.shape[lead] == rows:
        return w
    c = model_shards()[0]
    return dataclasses.replace(w, u=w.u.narrow(lead, c * rows, rows))


def _rank_slice(t: torch.Tensor, dim: int, n_local: int) -> torch.Tensor:
    """This "model" rank's ``n_local`` entries of ``t`` along ``dim``."""
    return t.narrow(dim, model_shards()[0] * n_local, n_local)


def _model_dim_of(w: Shard) -> int:
    """The dim a layer's dense ``Shard`` is split on over "model" (its
    "data" dims were gathered by ``meshctx.gather_dense``)."""
    d = model_dim(w)
    if d is None:
        raise ValueError(f"a dense Shard of spec {w.spec} not split over "
                         "\"model\": gather its layer's leaves first")
    return d


def dense_matmul(x: torch.Tensor, w: Shard) -> torch.Tensor:
    """``x @ w`` for a ``Shard`` of a dense (D_in, D_out) weight cut over
    "model": on its output dim the rank's columns, features gathered; on
    its input dim the rank's rows of the contraction against its slice
    of x, the partial products (f32) summed."""
    if _model_dim_of(w) == 1:
        return gather_model(x @ w.local)
    xk = _rank_slice(x, -1, w.local.shape[0])
    return reduce_model(xk.float() @ w.local.float()).to(x.dtype)


def dense_experts(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert ``x[e] @ w[e]``: x (E, M, D_in), w a dense (E, D_in,
    D_out) leaf or a ``Shard`` of one cut over "model" on one dim: the
    expert dim (the rank's experts, gathered after), the output dim
    (columns, gathered) or the input dim (partial products summed)."""
    if not isinstance(w, Shard):
        return torch.einsum("emk,ekn->emn", x, w.to(x.dtype)).to(x.dtype)
    d = _model_dim_of(w)
    loc = w.local.to(x.dtype)
    if d == 0:
        xe = _rank_slice(x, 0, loc.shape[0])
        return gather_model(torch.einsum("emk,ekn->emn", xe, loc), dim=0)
    if d == 2:
        return gather_model(torch.einsum("emk,ekn->emn", x, loc))
    xk = _rank_slice(x, -1, loc.shape[1])
    return reduce_model(torch.einsum("emk,ekn->emn", xk.float(),
                                     loc.float())).to(x.dtype)


def linear(x: torch.Tensor, w, tap: Optional[str] = None) -> torch.Tensor:
    """Dispatch point used by the model layers: dense ``x @ w`` or the
    packed kernel. ``tap`` names this linear for activation capture.

    Under a mesh a row-sharded PackedLinear runs its kernel on this
    rank's rows and the output features are gathered over "model" (the
    reference's output pin); a whole one (d_out not divisible) runs
    whole. A dense ``Shard`` runs tensor-parallel (``dense_matmul``)."""
    if tap is not None:
        tap_record(tap, x)
    if isinstance(w, PackedLinear):
        if current_mesh() is not None:
            rows = _held(w, 0)
            if rows != w.d_out:
                return gather_model(packed_matmul(x, _row_slice(w, rows)))
        return packed_matmul(x, w)
    if isinstance(w, Shard):
        return dense_matmul(x, w)
    return x @ w


def linear_cols(x: torch.Tensor, w, n_local: int,
                tap: Optional[str] = None) -> torch.Tensor:
    """This "model" rank's ``n_local`` output features of ``linear(x,
    w)``, where the features split evenly over the "model" ranks (a
    Mamba layer's heads): the rank's rows of a row-sharded PackedLinear
    or columns of a column-sharded ``Shard``, with no gather; a whole
    leaf runs whole and is sliced."""
    if tap is not None:
        tap_record(tap, x)
    if isinstance(w, PackedLinear):
        rows = _held(w, 0)
        if rows == w.d_out:
            return _rank_slice(packed_matmul(x, w), -1, n_local)
        if rows != n_local:
            raise ValueError(f"a packed leaf of {rows} rows a rank for "
                             f"{n_local} features a rank")
        return packed_matmul(x, _row_slice(w, rows))
    if isinstance(w, Shard):
        if _model_dim_of(w) != 1 or w.local.shape[1] != n_local:
            raise ValueError(f"a weight of spec {w.spec} and local shape "
                             f"{tuple(w.local.shape)} where {n_local} "
                             "output features a rank are asked")
        return x @ w.local
    return x @ _rank_slice(w, 1, n_local)


# ------------------------------------------------------------------
# Layer segments (the reference's scan groups, over the per-layer list)
# ------------------------------------------------------------------

def describe(leaf) -> str:
    """A packed leaf's descriptor as the reference prints it: variant,
    N:M pattern or ELL pad width, rank; an expert stack's groups; a
    dense weight is "dense"."""
    if isinstance(leaf, ExpertPackedStack):
        return leaf.describe()
    if not isinstance(leaf, PackedLinear):
        return "dense"
    d = leaf.variant
    if leaf.m_pat:
        d += f"({leaf.sparse_vals.shape[-1]}:{leaf.m_pat})"
    elif leaf.variant.endswith("-ell"):
        d += f"(kmax={leaf.sparse_vals.shape[-1]})"
    if leaf.rank:
        d += f" r{leaf.rank}"
    return d


def leaf_signature(leaf) -> Optional[Tuple]:
    """The reference's layer-stacking key of one layer's leaf: two layers
    of a path with equal signatures would share a stacked group there.
    None for a dense weight (the reference's dense remainder)."""
    if isinstance(leaf, ExpertPackedStack):
        return (("experts", leaf.members, leaf.dense_members,
                 leaf.n_experts)
                + tuple(_pack_signature(g) for g in leaf.groups)
                + ((None if leaf.dense is None
                    else (tuple(leaf.dense.shape),
                          _dtype_name(leaf.dense))),))
    if isinstance(leaf, PackedLinear):
        return _pack_signature(leaf)
    return None


def _leaf_paths(lp: dict, prefix: str = "") -> List[str]:
    out = []
    for k, v in sorted(lp.items()):
        if isinstance(v, dict):
            out += _leaf_paths(v, f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def segment_runs(layers: list, n_layers: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """The layer axis of the per-layer list ``layers`` (a model's
    ``params["layers"]``) cut into maximal contiguous runs [lo, hi) in
    which every leaf keeps one packed signature (``leaf_signature``):
    where the reference scans one stacked segment a run. A homogeneous
    model is one run."""
    from repro_torch.core.pipeline import _get
    paths = _leaf_paths(layers[0]) if n_layers else []

    def sig(l):
        return [leaf_signature(_get(layers[l], p)) for p in paths]

    runs: List[Tuple[int, int]] = []
    lo, prev = 0, sig(0) if n_layers else None
    for l in range(1, n_layers):
        cur = sig(l)
        if cur != prev:
            runs.append((lo, l))
            lo, prev = l, cur
    runs.append((lo, n_layers))
    return tuple(runs)


def has_hetero(layers: list) -> bool:
    """True when some path's layers carry different packed signatures
    (the reference holds such a path as a ``PackedStack``)."""
    return len(segment_runs(layers, len(layers))) > 1


def layer_slice_range(layers: list, lo: int, hi: int) -> list:
    """The per-layer leaves of the run [lo, hi)."""
    if not 0 <= lo < hi <= len(layers):
        raise ValueError(f"layers [{lo},{hi}) outside 0..{len(layers)}")
    return layers[lo:hi]


class Segment(NamedTuple):
    """One contiguous same-signature layer run of a packed model."""
    lo: int
    hi: int                            # exclusive
    sig: Tuple[Tuple[str, str], ...]   # (path, descriptor) per packed path


def _model_segments(layers: list, n_layers: int,
                    paths: Sequence[str]) -> Tuple[Segment, ...]:
    """``segment_runs`` with, per run, the (path, descriptor) of each
    packed path at the run's first layer (what ``serve`` prints)."""
    from repro_torch.core.pipeline import _get
    return tuple(Segment(lo, hi, tuple((p, describe(_get(layers[lo], p)))
                                       for p in paths))
                 for lo, hi in segment_runs(layers, n_layers))


# ------------------------------------------------------------------
# Whole-model packing
# ------------------------------------------------------------------

class PackReport(NamedTuple):
    """What pack_model did: packed-linear counts per variant (each expert
    of a MoE leaf counts as one linear), the packed paths, per-variant
    (packed, dense) bytes per linear with the weights left dense under
    ``"dense-fallback"``, the (layer, path) linears left dense for want
    of packable terms (an expert as ``path[expert e]``), and the layer
    segments."""
    n_packed: int
    by_variant: Dict[str, int]
    paths: List[str]
    bytes_by_variant: Dict[str, Tuple[float, float]]
    fallback: Tuple[Tuple[int, str], ...] = ()
    segments: Tuple[Segment, ...] = ()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pack_model(params: dict,
               decs: Dict[Tuple[int, str], SLaBDecomposition],
               plan=None,
               dtype=torch.float32,
               place=None) -> Tuple[dict, PackReport]:
    """Replace every servable decomposed linear of the per-layer params
    with its PackedLinear at the serving ``dtype``, and every 3-D expert
    leaf (whose decs arrive as a tuple, one per expert) with an
    ``ExpertPackedStack``. ``decs`` comes from
    ``core.pipeline.compress_model(keep_decompositions=True)``, and
    ``plan`` (anything ``CompressionPlan.parse`` takes) is the one they
    were compressed under: each dec packs with the N:M pattern of its
    own resolved rule, so one path may mix variants across layers. With
    no plan every dec packs unstructured. A dec with no packable terms
    stays dense and is listed in ``fallback``.

    The bytes are the reference's ``pack_plan_decs``': still-dense bytes
    (unservable decs, the layers of a packed path that the plan left
    uncovered, unservable experts) aggregate under ``"dense-fallback"``,
    so a partially packed model's bytes are its true bytes. As there, an
    unservable dec of a path packed elsewhere counts both as a fallback
    and as an uncovered layer. The hybrid's shared-block decs, keyed
    ``(firing layer, "shared.<path>")``, pack once into a copy of
    ``params["shared_attn"]`` as plain PackedLinears, which every
    invocation of the block runs; they count in ``by_variant`` and the
    bytes, and their paths close ``PackReport.paths`` (segments cover
    the layer list only). Returns (params, PackReport); the input params
    are not modified.

    ``place``, when given, takes each packed leaf as soon as it is packed
    and returns what the model keeps (``runtime.sharding.PackPlacer``
    cuts this rank's shards there, so no rank holds more than one whole
    packed leaf beyond its shards); the report counts the whole leaves.
    """
    from repro_torch.core.pipeline import _copy_tree, _get, _set
    if plan is not None:
        from repro_torch.core.plan import CompressionPlan
        plan = CompressionPlan.parse(plan)
    layers = params["layers"]
    n_layers = len(layers)
    out = dict(params)
    out["layers"] = _copy_tree(layers)
    itemsize = torch.empty((), dtype=dtype).element_size()
    by_variant: Dict[str, int] = {}
    agg: Dict[str, List[float]] = {}
    fallback: List[Tuple[int, str]] = []
    covered: Dict[str, List[int]] = {}          # 2-D paths: packed layers
    expert_layers: Dict[str, List[int]] = {}
    shared_paths: List[str] = []
    if "shared_attn" in params:
        out["shared_attn"] = _copy_tree(params["shared_attn"])

    def account(var: str, packed_b: float, dense_b: float, n: int = 1):
        a = agg.setdefault(var, [0.0, 0.0, 0])
        a[0] += packed_b
        a[1] += dense_b
        a[2] += n
        if var != "dense-fallback":
            by_variant[var] = by_variant.get(var, 0) + n

    for (l, name) in sorted(decs, key=lambda k: (k[1], k[0])):
        dec = decs[(l, name)]
        shared = name.startswith("shared.")
        old = (_get(out.get("shared_attn", {}), name.split(".", 1)[1])
               if shared else _get(out["layers"][l], name))
        r = plan.resolve(l, name) if plan is not None else None
        pattern = r.scfg.pattern if r is not None else None
        if old is None:
            fallback.append((l, name))
            continue
        if type(dec) is tuple:          # one dec per expert of a 3-D leaf
            eps = pack_expert_stack(old, dec, pattern, dtype)
            expert_layers.setdefault(name, []).append(l)
            per_e = _nbytes(old[0])
            for grp, mem in zip(eps.groups, eps.members):
                account(grp.variant, grp.nbytes(), per_e * len(mem),
                        len(mem))
            for e in eps.dense_members:
                fallback.append((l, f"{name}[expert {e}]"))
                account("dense-fallback", per_e, per_e)
            _set(out["layers"][l], name, place(eps) if place else eps)
            continue
        var = k_max = None
        if dec.w_s is not None and dec.w_s.dim() == 2:
            k_max = None if pattern else ell_row_nnz_max(dec.w_s)
            var = variant_of(dec, pattern, itemsize=itemsize, k_max=k_max)
        if var is None:
            fallback.append((l, name))
            continue
        pl = pack_linear(dec, pattern, dtype, variant=var,
                         ell_nnz=k_max if var.endswith("-ell") else None)
        account(var, pl.nbytes(), _nbytes(old))
        if place is not None:
            pl = place(pl)
        if shared:
            _set(out["shared_attn"], name.split(".", 1)[1], pl)
            shared_paths.append(name)
            continue
        _set(out["layers"][l], name, pl)
        covered.setdefault(name, []).append(l)

    # the layers of a packed path that no dec covered stay dense
    for name, got in covered.items():
        for l in range(n_layers):
            if l not in got:
                b = _nbytes(_get(layers[l], name))
                account("dense-fallback", b, b)
    for name, got in expert_layers.items():
        for l in range(n_layers):
            if l not in got:
                w = _get(layers[l], name)
                account("dense-fallback", _nbytes(w), _nbytes(w),
                        w.shape[0])
    # unservable decs stayed dense: their bytes count toward the model
    for (l, fname) in fallback:
        if fname.startswith("shared."):
            w = _get(params.get("shared_attn", {}), fname.split(".", 1)[1])
            if w is not None:
                account("dense-fallback", _nbytes(w), _nbytes(w))
        elif "[expert " not in fname:       # expert slices counted above
            w = _get(layers[l], fname)
            if w is not None:
                account("dense-fallback", _nbytes(w), _nbytes(w))

    per_linear = {var: (p / n, d / n) for var, (p, d, n) in agg.items()}
    for var, (p, d) in sorted(per_linear.items()):
        if p > d:
            warnings.warn(
                f"packed variant {var!r} stores {p / d:.2f}x its dense "
                f"bytes ({p / 1e3:.1f} kB vs {d / 1e3:.1f} kB per linear)",
                stacklevel=2)
    layer_paths = sorted(covered) + sorted(expert_layers)
    segments = _model_segments(out["layers"], n_layers, layer_paths)
    paths = layer_paths + sorted(shared_paths)
    return out, PackReport(sum(by_variant.values()), by_variant, paths,
                           per_linear,
                           tuple(sorted(fallback, key=lambda k: (k[1], k[0]))),
                           segments)
