"""Divisibility-aware sharding planner: logical axes -> per-dim mesh axes
(port of ``repro.runtime.sharding``), and the placement of a params
tree on this rank's shards.

Rules (train and serve share the 2-D layout: FSDP over "data", TP over
"model"):

  logical name  candidate mesh axes (first that divides wins)
  ------------  -----------------------------------------------
  vocab         ("model",)
  embed         ("pod","data") -> ("data",)     [FSDP; ZeRO over pod]
  heads/kv      ("model",)  with whole-head alignment (unit=d_head)
  ffn           ("model",)
  experts       ("model",)                      [EP]
  ssm           ("model",)  unit=ssm_headdim
  ssm_heads     ("model",)
  batch         ("pod","data") -> ("data",)     [activations/caches]
  kv_seq        ("model",)                      [split-softmax decode]
  packed_out    ("model",)                      [packed-linear d_out rows]
  kv_blocks     never sharded (a global free pool)
  kv_heads      ("model",)                      [paged KV pools]
  layers        never sharded

A rule applies only if the dim divides by the product of its mesh axes
AND the per-shard slice keeps logical units whole; a mesh axis serves
one dim of a leaf at most. Otherwise the dim replicates (degraded but
correct). A spec is a tuple with one entry per dim: None, an axis name,
or a tuple of names — the entries of the reference's ``PartitionSpec``.

Placement follows the specs (``Planner.tree_specs``), dense and packed
leaves alike, as the reference's ``tree_shardings`` do. A dense leaf cut
over "data" (FSDP) is gathered over "data" before its layer runs; what
is cut over "model" stays cut and runs tensor-parallel, as XLA runs the
reference's: a linear on its columns (features gathered) or rows
(partial products summed), dense experts on the rank's experts, a Mamba
layer on its heads, the vocab-sharded table and head on their rows
(``core.packed_model.linear``, ``models``). Packed planes are
row-sharded.

``shard`` cuts this rank's slice of one tensor, ``tree_shard`` of a
tree. A sharded dense leaf becomes a ``meshctx.Shard``; the planes of a
packed leaf stay plain tensors, the leaf's static ``d_out`` and expert
members telling their layout. ``unshard`` gathers a tree back over the
process groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.packed_model import (ExpertPackedStack, PackedLinear,
                                           packed_axes)
from repro_torch.runtime.meshctx import Shard
from repro_torch.tree import tree_map

AxisRule = Sequence[Tuple[str, ...]]     # candidates, in priority order
PLANES = ("sparse_vals", "sparse_idx", "b_packed", "u", "v")


def logical_rules(multi_pod: bool) -> Dict[str, AxisRule]:
    fsdp = [("pod", "data"), ("data",)] if multi_pod else [("data",)]
    return {
        "vocab": [("model",)],
        "embed": fsdp,
        "heads": [("model",)],
        "kv": [("model",)],
        "ffn": [("model",)],
        "experts": [("model",)],
        "ssm": [("model",)],
        "ssm_heads": [("model",)],
        "batch": fsdp,
        "kv_seq": [("model",)],
        # every stored plane of a PackedLinear except v leads with d_out:
        # TP is row sharding on "model"
        "packed_out": [("model",)],
        "layers": [],
        # paged KV pools: any request may own any block, so the block dim
        # is never sharded; TP splits the kv-head dim
        "kv_blocks": [],
        "kv_heads": [("model",)],
    }


def axis_constraints(cfg) -> Dict[str, int]:
    """Units that must stay whole inside one shard."""
    return {
        "heads": cfg.d_head,
        "kv": cfg.d_head,
        "ssm": max(cfg.ssm_headdim, 1),
    }


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (names or None), not a NamedTuple node."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(a is None or isinstance(a, str) for a in x))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Planner:
    """Maps logical axes to mesh axes for ``mesh`` (anything with
    ``axis_names`` and a ``shape`` dict) and the units of ``cfg``."""

    def __init__(self, mesh, cfg, rules: Optional[Dict[str, AxisRule]] = None):
        self.mesh = mesh
        self.cfg = cfg
        multi_pod = "pod" in mesh.axis_names
        self.rules = rules if rules is not None else logical_rules(multi_pod)
        self.units = axis_constraints(cfg)

    def _pick(self, name: Optional[str], dim: int
              ) -> Optional[Tuple[str, ...]]:
        if name is None:
            return None
        for cand in self.rules.get(name, []):
            if any(a not in self.mesh.axis_names for a in cand):
                continue
            n_shards = math.prod(self.mesh.shape[a] for a in cand)
            if dim % n_shards:
                continue
            unit = self.units.get(name, 1)
            if (dim // n_shards) % unit:
                continue
            return cand
        return None

    def spec(self, axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> tuple:
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} for a shape {shape}")
        used: set = set()
        parts: List[Any] = []
        for name, dim in zip(axes, shape):
            cand = self._pick(name, dim)
            if cand is not None and not (set(cand) & used):
                used.update(cand)
                parts.append(cand if len(cand) > 1 else cand[0])
            else:
                parts.append(None)
        return tuple(parts)

    def tree_specs(self, axes_tree: Any, tree: Any) -> Any:
        """The spec of every tensor of ``tree`` from the matching axes of
        ``axes_tree`` (``tree``'s structure; a packed leaf pairs with its
        axes leaf, ``core.packed_model.packed_axes``). A packed leaf met
        by a dense axes tuple was placed already (``PackPlacer``) and gets
        None, as ``tree_shard`` leaves it."""
        return _map(lambda ax, t, plane: self.spec(ax, tuple(t.shape)),
                    axes_tree, tree, keep=False)

    def act_spec(self, *names: Optional[str], shape: Tuple[int, ...]
                 ) -> tuple:
        return self.spec(tuple(names), shape)

    def batch_axes(self) -> Tuple[str, ...]:
        for cand in self.rules["batch"]:
            if all(a in self.mesh.axis_names for a in cand):
                return cand
        return ()


# ----------------------------------------------------------------------
# tree walks
# ----------------------------------------------------------------------

def _is_packed(x) -> bool:
    return isinstance(x, (PackedLinear, ExpertPackedStack))


def _map(fn: Callable, ax: Any, t: Any, *rest: Any, keep: bool = True
         ) -> Any:
    """``fn(ax, leaf, *rest_leaves, plane=...)`` over the tensors of ``t``
    (and the matching leaves of ``rest``), walking ``t``'s structure:
    dicts, lists, NamedTuples, PackedLinear planes (``plane`` True) and
    an ExpertPackedStack's groups and dense remainder. None, Python
    scalars and Shards pass through; a packed leaf paired with a dense
    axes tuple was placed already and comes back as it is (``keep``) or
    None."""
    if t is None:
        return None
    if _is_packed(t) and not isinstance(ax, type(t)):
        return t if keep else None
    if isinstance(t, PackedLinear):
        return dataclasses.replace(t, **{
            f: (None if getattr(t, f) is None else
                fn(getattr(ax, f), getattr(t, f),
                   *(getattr(r, f) for r in rest), plane=True))
            for f in PLANES})
    if isinstance(t, ExpertPackedStack):
        groups = tuple(_map(fn, a, g, *(r.groups[i] for r in rest))
                       for i, (a, g) in enumerate(zip(ax.groups, t.groups)))
        dense = (None if t.dense is None else
                 fn(ax.dense, t.dense, *(r.dense for r in rest),
                    plane=False))
        return dataclasses.replace(t, groups=groups, dense=dense)
    if isinstance(t, dict):
        return {k: _map(fn, ax[k], v, *(r[k] for r in rest), keep=keep)
                for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_map(fn, a, v, *(r[i] for r in rest), keep=keep)
                         for i, (a, v) in enumerate(zip(ax, t))))
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, a, v, *(r[i] for r in rest), keep=keep)
                       for i, (a, v) in enumerate(zip(ax, t)))
    if isinstance(t, (torch.Tensor, Shard)):
        return fn(ax, t, *rest, plane=False)
    return t


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------

def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: ``t`` itself where
    nothing is sharded, else a contiguous copy of its block."""
    out = t
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = mesh.n(axes)
        if n == 1:
            continue
        k = t.shape[d] // n
        out = out.narrow(d, mesh.index(axes) * k, k)
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def tree_shard(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` with every tensor cut to this rank's slice by ``specs``
    (``Planner.tree_specs``): a sharded dense tensor as a ``Shard``, a
    packed leaf's planes as plain tensors."""
    def cut(spec, t, plane):
        local = shard(t, spec, mesh)
        if plane or local is t:
            return local
        return Shard(local, spec, tuple(t.shape))
    return _map(cut, specs, tree)


def _gather(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for d, entry in enumerate(spec):
        t = mesh.all_gather(t, _entry_axes(entry), d)
    return t


def unshard(tree: Any, specs: Any, mesh) -> Any:
    """The whole tree back from this rank's shards, gathered over the
    mesh's process groups (every rank gets it)."""
    return _map(lambda spec, t, plane: _gather(
        t.local if isinstance(t, Shard) else t, spec, mesh), specs, tree)


def gather_shards(tree: Any, mesh) -> Any:
    """A tree of dense leaves (params, moments, a train state) with every
    ``Shard`` gathered whole by its own spec (every rank gets it); plain
    tensors, replicated, as they are."""
    return tree_map(lambda t: _gather(t.local, t.spec, mesh)
                    if isinstance(t, Shard) else t, tree)


def local_tensors(tree: Any) -> Any:
    """The tensors this rank holds: each ``Shard``'s ``local``."""
    return tree_map(lambda t: t.local if isinstance(t, Shard) else t, tree)


def _checksum(leaf) -> Tuple[int, int]:
    """Two int64 sums over a packed leaf's words: the plain sum and one
    weighted by position (wrapping, identical on identical bytes)."""
    planes: List[torch.Tensor] = []
    groups = leaf.groups if isinstance(leaf, ExpertPackedStack) else (leaf,)
    for g in groups:
        planes += [getattr(g, f) for f in PLANES if getattr(g, f) is not None]
    if isinstance(leaf, ExpertPackedStack) and leaf.dense is not None:
        planes.append(leaf.dense)
    s1 = s2 = 0
    for p in planes:
        w = p.contiguous().view(-1).view(torch.uint8)
        w = (w.view(torch.int32) if w.numel() % 4 == 0 else w).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        s1 += int(w.sum())
        s2 += int((w * pos).sum())
    return s1 & (2 ** 63 - 1), s2 & (2 ** 63 - 1)


class PackPlacer:
    """``core.packed_model.pack_model``'s ``place``: each packed leaf, as
    soon as it is packed, cut to this rank's shards by the planner (so no
    rank ever holds the whole packed model), its checksum kept for
    ``verify``."""

    def __init__(self, planner: Planner, mesh):
        self.planner, self.mesh = planner, mesh
        self.checksums: List[Tuple[int, int]] = []
        self.bytes_whole = 0

    def __call__(self, leaf):
        self.checksums.append(_checksum(leaf))
        self.bytes_whole += leaf_nbytes(leaf)
        specs = self.planner.tree_specs(packed_axes(leaf), leaf)
        return tree_shard(leaf, specs, self.mesh)

    def verify(self) -> int:
        """Raise unless every rank packed the same leaves, bit for bit (one
        gather of the checksums); returns the number of leaves."""
        local = torch.tensor(self.checksums, dtype=torch.int64,
                             device=self.mesh.comm_device()).reshape(-1, 2)
        every = self.mesh.all_gather(local[None], self.mesh.axis_names, 0)
        bad = (every != every[:1]).any(dim=(0, 2)).nonzero().reshape(-1)
        if bad.numel():
            raise RuntimeError(
                f"ranks packed different models: {bad.numel()} of "
                f"{local.shape[0]} leaves differ (first: leaf "
                f"{int(bad[0])})")
        return local.shape[0]


def leaf_nbytes(leaf) -> int:
    """The bytes of a packed leaf's planes (an expert stack's dense
    remainder too) as this rank holds them."""
    if isinstance(leaf, ExpertPackedStack):
        d = leaf.dense.local if isinstance(leaf.dense, Shard) else leaf.dense
        return (sum(g.nbytes() for g in leaf.groups)
                + (0 if d is None else d.numel() * d.element_size()))
    return leaf.nbytes()


def dense_bytes(tree) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the whole) of the dense tensors
    of a params tree (a ``Shard``'s local slice against its global shape;
    packed planes not counted)."""
    held = whole = 0
    for t in _dense_leaves(tree):
        if isinstance(t, Shard):
            held += t.local.numel() * t.local.element_size()
            whole += math.prod(t.shape) * t.local.element_size()
        else:
            held += t.numel() * t.element_size()
            whole += t.numel() * t.element_size()
    return held, whole


def _dense_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _dense_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _dense_leaves(v)
    elif isinstance(tree, (torch.Tensor, Shard)):
        yield tree


def packed_bytes(tree) -> int:
    """The bytes of every packed leaf's planes in a params tree, as this
    rank holds them."""
    if isinstance(tree, (PackedLinear, ExpertPackedStack)):
        return leaf_nbytes(tree)
    if isinstance(tree, dict):
        return sum(packed_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(packed_bytes(v) for v in tree)
    return 0
