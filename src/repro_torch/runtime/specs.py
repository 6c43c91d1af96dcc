"""Abstract input and state specs of a (data, model) mesh (port of
``repro.runtime.specs``): every leaf a ``meshctx.Shard`` whose ``local``
is a ``meta`` tensor of this rank's shape, whose ``spec`` is the
reference's ``PartitionSpec`` as a tuple and whose ``shape`` is the
global shape. Nothing is allocated.

The specs are ``Planner.tree_specs``, the reference's
``tree_shardings``, by which the port also places a params tree and a
train state (``runtime.sharding``, ``runtime.elastic``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init
from repro_torch.runtime.meshctx import Shard, _axes
from repro_torch.runtime.sharding import Planner, _map

META = torch.device("meta")


def _shard(spec: tuple, shape: Tuple[int, ...], dtype, mesh) -> Shard:
    local = tuple(n // mesh.n(_axes(e)) for n, e in zip(shape, spec))
    return Shard(torch.empty(local, dtype=dtype, device=META), spec,
                 tuple(shape))


def abstract_tree(planner: Planner, shapes_tree: Any, axes_tree: Any) -> Any:
    """``shapes_tree`` (tensors, ``meta`` or not) as Shards by the
    planner's specs of ``axes_tree``."""
    specs = planner.tree_specs(axes_tree, shapes_tree)
    return _map(lambda spec, t, plane: _shard(spec, tuple(t.shape), t.dtype,
                                              planner.mesh),
                specs, shapes_tree)


def abstract_params(cfg: ArchConfig, planner: Planner):
    axes = lm.param_axes(cfg)
    return abstract_tree(planner, lm.abstract_params(cfg), axes), axes


def abstract_opt_state(cfg: ArchConfig, planner: Planner,
                       acfg: AdamWConfig):
    axes = lm.param_axes(cfg)
    opt_axes = OptState(axes, axes, ())
    opt = adamw_init(lm.abstract_params(cfg), acfg)
    return abstract_tree(planner, opt, opt_axes), opt_axes


def _batch_entry(planner: Planner, b: int):
    """The batch dim's spec entry: the batch axes (a name, or a tuple of
    them), None where there are none or the batch does not divide."""
    dp = planner.batch_axes()
    n_dp = planner.mesh.n(dp)
    if not dp or b % n_dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, planner: Planner
                ) -> Dict[str, Shard]:
    """Training batch: inputs / labels (+ M-RoPE positions for vlm)."""
    b, s = shape.global_batch, shape.seq_len
    bs = _batch_entry(planner, b)
    mesh = planner.mesh
    out = {}
    if cfg.input_mode == "embeds":
        out["inputs"] = _shard((bs, None, None), (b, s, cfg.d_model),
                               cfg.dtype, mesh)
    else:
        out["inputs"] = _shard((bs, None), (b, s), torch.int32, mesh)
    out["labels"] = _shard((bs, None), (b, s), torch.int32, mesh)
    if cfg.rope == "mrope":
        out["positions"] = _shard((bs, None, None), (b, s, 3), torch.int32,
                                  mesh)
    return out


def _full(cache, s: int):
    """The cache with every KVCache's length at ``s`` (the reference's
    ``init_cache(..., length=s)``)."""
    if isinstance(cache, list):
        return [c._replace(length=s) for c in cache]
    if cache.shared_kv is None:
        return cache
    return cache._replace(shared_kv=_full(cache.shared_kv, s))


def decode_specs(cfg: ArchConfig, shape: ShapeSpec, planner: Planner
                 ) -> Tuple[Any, Shard, Shard]:
    """(cache, token, positions) specs for a decode step at cache length
    ``shape.seq_len`` with batch ``shape.global_batch``: the cache is
    ``lm.init_cache``'s (a list of KVCache, or an SSMCache) on ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    cache = _full(lm.init_cache(cfg, b, s, device=META), s)
    cache = abstract_tree(planner, cache, lm.cache_axes(cfg))
    bs = _batch_entry(planner, b)
    mesh = planner.mesh
    token = _shard((bs, None), (b, 1), torch.int32, mesh)
    if cfg.rope == "mrope":
        positions = _shard((bs, None, None), (b, 1, 3), torch.int32, mesh)
    else:
        positions = _shard((bs, None), (b, 1), torch.int32, mesh)
    return cache, token, positions
