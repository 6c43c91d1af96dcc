"""The ambient process mesh and the explicit collectives of tensor-
parallel serving (port of ``repro.runtime.meshctx``).

Entry points enter ``with use_mesh(mesh):``; model code reads
``current_mesh()``. Where the reference drops sharding *hints* and lets
XLA insert the collectives, the port calls them itself, and only these:

  * ``gather_model(y, dim)`` — a dim sharded over "model" made whole
    (a column-sharded linear's output features, an expert dim, kv heads,
    a Mamba layer's heads);
  * ``reduce_model(y)`` — the sum of the "model" ranks' partial products
    (a row-sharded dense linear: each rank contracts its input rows);
  * ``gather_data(t, dim, axes)`` — a dim sharded over the data axes
    made whole (greedy_decode's batch rows, split by ``batch_rows``);
  * ``merge_model(t)`` — elementwise, at most one "model" rank holds a
    non-zero: every rank gets that value, bit for bit (the vocab-sharded
    embedding lookup);
  * ``lse_combine(...)`` — the split softmax over a position-sharded KV
    cache: the max, the sum of the exponentials, then the sum of the
    ranks' weighted V;
  * ``gather_dense(tree)`` — a layer's dense leaves gathered over "data"
    (FSDP) before the layer runs; what the planner cut over "model" stays
    a ``Shard`` and runs tensor-parallel on it
    (``core.packed_model.linear``); ``whole(t)`` gathers a ``Shard``
    over every axis.

Each is the identity without a mesh, so every single-device path runs
exactly the code it ran before. A ``Shard`` exists only under a mesh.

A ``RowSplit`` says which rows of a global batch this rank runs where
the batch axes split them (the train step, a prefill). It is handed to
``models.lm.forward`` as an argument, not set in a context, so that a
checkpointed layer recomputed in the backward pass (on the autograd
engine's thread) sees it: the attention mask reads the global batch's
first row, and the MoE layer routes by the global batch's groups.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)

DP = ("pod", "data")   # the batch / data-parallel axes of this framework


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def model_shards() -> Tuple[int, int]:
    """(this rank's index, number of ranks) along "model"; (0, 1) without
    a mesh."""
    mesh = _MESH.get()
    if mesh is None or "model" not in mesh.shape:
        return 0, 1
    return mesh.index(("model",)), mesh.shape["model"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's slice ``local`` of a dense leaf of global ``shape``
    that the planner sharded by ``spec`` (one entry per dim: None, a mesh
    axis name, or a tuple of them). Packed planes are never wrapped: a
    PackedLinear's static ``d_out`` tells its layout."""

    local: torch.Tensor
    spec: tuple
    shape: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This rank's rows [lo, hi) of a global batch of ``b`` rows, split
    over the mesh axes ``axes`` of ``mesh`` (every rank's rows in the
    order of its index along them). ``first`` is row 0 of the global
    batch's positions ((S,), or (S, 3) under M-RoPE), or None where the
    batch came without positions (every row then has the same ones)."""

    mesh: Any
    axes: Tuple[str, ...]
    lo: int
    hi: int
    b: int
    first: Optional[Any] = None


def model_dim(t) -> Optional[int]:
    """The dim of a ``Shard`` that is split over "model" (more than one
    rank), or None."""
    if not isinstance(t, Shard):
        return None
    mesh = _MESH.get()
    for d, entry in enumerate(t.spec):
        if "model" in _axes(entry) and mesh.n(_axes(entry)) > 1:
            return d
    return None


def whole(t, keep: Tuple[int, ...] = ()):
    """A ``Shard`` gathered along every sharded dim but those in ``keep``;
    anything else as it is."""
    if not isinstance(t, Shard):
        return t
    mesh = _MESH.get()
    out = t.local
    for d, entry in enumerate(t.spec):
        if d not in keep and _axes(entry):
            out = mesh.all_gather(out, _axes(entry), d)
    return out


def _gather_data_dims(t):
    """A ``Shard`` gathered along its data dims (every entry but "model"):
    the whole tensor, or a ``Shard`` of what stays split over "model"."""
    if not isinstance(t, Shard):
        return t
    mesh = _MESH.get()
    out, spec = t.local, []
    for d, entry in enumerate(t.spec):
        if mesh.n(_axes(entry)) == 1:
            spec.append(None)
        elif "model" in _axes(entry):
            spec.append(entry)
        else:
            out = mesh.all_gather(out, _axes(entry), d)
            spec.append(None)
    if all(e is None for e in spec):
        return out
    return Shard(out, tuple(spec), t.shape)


def gather_dense(tree):
    """A layer's params with every dense ``Shard`` gathered over "data"
    (an expert stack's dense remainder too); a leaf split over "model"
    stays a ``Shard`` of its "model" slice, packed leaves stay as they
    are."""
    if _MESH.get() is None:
        return tree
    from repro_torch.core.packed_model import ExpertPackedStack
    if isinstance(tree, dict):
        return {k: gather_dense(v) for k, v in tree.items()}
    if isinstance(tree, ExpertPackedStack) and isinstance(tree.dense, Shard):
        return dataclasses.replace(tree,
                                   dense=_gather_data_dims(tree.dense))
    return _gather_data_dims(tree)


def gather_model(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None:
        return y
    return mesh.all_gather(y, ("model",), dim)


def reduce_model(y: torch.Tensor) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None:
        return y
    return mesh.all_reduce(y, ("model",), "sum")


def gather_data(t: torch.Tensor, dim: int = 0,
                axes: Tuple[str, ...] = DP) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None:
        return t
    return mesh.all_gather(t, axes, dim)


def merge_model(t: torch.Tensor) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None:
        return t
    return mesh.merge(t, ("model",))


def lse_combine(logits: torch.Tensor, weigh_v) -> torch.Tensor:
    """Softmax over the last dim of ``logits`` (f32), split across the
    "model" ranks, each holding its positions, in the single-device
    arithmetic: the global max and the global sum of p = exp(logits -
    max), each an all_reduce, give this rank's normalised probabilities;
    ``weigh_v(probs)`` gives its Σ probs · V (f32, the position dim
    contracted), and the ranks' sums are added. Returns that sum, f32."""
    mesh = _MESH.get()
    m = logits.amax(dim=-1, keepdim=True)
    m = mesh.all_reduce(m, ("model",), "max")
    p = torch.exp(logits - m)
    z = mesh.all_reduce(p.sum(dim=-1, keepdim=True), ("model",), "sum")
    return mesh.all_reduce(weigh_v(p / z), ("model",), "sum")


def batch_rows(cfg, b: int, mesh=None):
    """(lo, hi, axes): the batch rows [lo, hi) this rank runs, split over
    ``axes`` where the planner puts "batch" on them (b divisible by their
    size), or None without a mesh or where the batch replicates (every
    rank runs every row). ``mesh`` defaults to the ambient one."""
    mesh = _MESH.get() if mesh is None else mesh
    if mesh is None:
        return None
    from repro_torch.runtime.sharding import Planner
    entry = Planner(mesh, cfg).act_spec("batch", shape=(b,))[0]
    n = mesh.n(_axes(entry))
    if n == 1:
        return None
    i, k = mesh.index(_axes(entry)), b // n
    return i * k, (i + 1) * k, _axes(entry)


def row_split(cfg, b: int, first=None, mesh=None) -> Optional[RowSplit]:
    """``batch_rows`` as a ``RowSplit`` (``first``: row 0 of the global
    batch's positions), or None where every rank runs every row."""
    mesh = _MESH.get() if mesh is None else mesh
    rows = batch_rows(cfg, b, mesh)
    if rows is None:
        return None
    lo, hi, axes = rows
    return RowSplit(mesh, axes, lo, hi, b, first)
