"""The ambient process mesh and the explicit collectives of tensor-
parallel serving (port of ``repro.runtime.meshctx``).

Entry points enter ``with use_mesh(mesh):``; model code reads
``current_mesh()``. Where the reference drops sharding *hints* and lets
XLA insert the collectives, the port calls them itself, and only these:

  * ``gather_model(y, dim)`` — a dim sharded over "model" made whole
    (a row-sharded linear's output features, an expert dim, kv heads);
  * ``gather_data(t, dim, axes)`` — a dim sharded over the data axes
    made whole (greedy_decode's batch rows, split by ``batch_rows``);
  * ``merge_model(t)`` — elementwise, at most one "model" rank holds a
    non-zero: every rank gets that value, bit for bit (the vocab-sharded
    embedding lookup);
  * ``lse_combine(...)`` — the split softmax over a position-sharded KV
    cache: the max, the sum of the exponentials, then the sum of the
    ranks' weighted V;
  * ``whole(t)`` / ``gather_dense(tree)`` — a dense leaf sharded over
    "data" (a ``Shard``; ``sharding.Planner.placement`` cuts one over
    "model" only on a vocab dim) gathered whole before use, layer by
    layer.

Each is the identity without a mesh, so every single-device path runs
exactly the code it ran before. A ``Shard`` exists only under a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Tuple

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


def gather_dense(tree):
    """A layer's params with every dense ``Shard`` gathered whole (an
    expert stack's dense remainder too); packed leaves stay as they
    are."""
    if _MESH.get() is None:
        return tree
    from repro_torch.core.packed_model import ExpertPackedStack
    if isinstance(tree, dict):
        return {k: gather_dense(v) for k, v in tree.items()}
    if isinstance(tree, ExpertPackedStack) and isinstance(tree.dense, Shard):
        return dataclasses.replace(tree, dense=whole(tree.dense))
    return whole(tree)


def gather_model(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None:
        return y
    return mesh.all_gather(y, ("model",), dim)


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
