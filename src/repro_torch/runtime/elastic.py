"""Elastic restore of the train state (port of ``repro.runtime.elastic``):
a commit restored onto one device or onto a mesh of any shape. The
checkpoint format knows no device and no mesh: the commit's leaves are
read whole on the host and placed, on one device as they are, on a mesh
cut to this rank's shards by the new mesh's placement
(``train_state_specs``). Growing, shrinking or changing the (data,
model) split are the same code path."""
from __future__ import annotations

from typing import Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init
from repro_torch.runtime.meshctx import Shard
from repro_torch.runtime.sharding import Planner, tree_shard
from repro_torch.tree import tree_map


def train_state_template(cfg: ArchConfig, acfg: AdamWConfig) -> dict:
    """The {"params", "opt"} structure of a commit, on the ``meta``
    device: shapes and dtypes, no weights allocated."""
    shapes = lm.abstract_params(cfg)
    return {"params": shapes, "opt": adamw_init(shapes, acfg)}


def train_state_specs(cfg: ArchConfig, acfg: AdamWConfig,
                      planner: Planner) -> dict:
    """The {"params", "opt"} placement on ``planner``'s mesh (the
    counterpart of the reference's ``train_state_shardings``): the
    moments as their parameters, the count replicated."""
    template = train_state_template(cfg, acfg)
    axes = lm.param_axes(cfg)
    return {"params": planner.tree_specs(axes, template["params"]),
            "opt": planner.tree_specs(OptState(axes, axes, ()),
                                      template["opt"])}


def place_train_state(state: dict, cfg: ArchConfig, acfg: AdamWConfig,
                      mesh, device=None) -> dict:
    """A whole {"params", "opt"} state cut to this rank's shards on
    ``mesh`` and moved to ``device`` (default: the mesh's)."""
    dev = mesh.device if device is None else resolve_device(device)
    placed = tree_shard(state, train_state_specs(cfg, acfg,
                                                 Planner(mesh, cfg)), mesh)
    return tree_map(lambda t: Shard(t.local.to(dev), t.spec, t.shape)
                    if isinstance(t, Shard) else t.to(dev), placed)


def elastic_restore(mgr: CheckpointManager, cfg: ArchConfig,
                    acfg: AdamWConfig, step: Optional[int] = None,
                    device=None, mesh=None) -> dict:
    """The {"params", "opt"} commit at ``step`` (default: the latest) on
    ``resolve_device(device)``, or with ``mesh`` (a commit made on any
    mesh shape, or on one device) as this rank's shards, on ``device``
    or the mesh's. Every rank reads the commit whole on the host."""
    template = train_state_template(cfg, acfg)
    if mesh is None:
        return mgr.restore(template, step=step, device=device)
    state = mgr.restore(template, step=step, device="cpu")
    return place_train_state(state, cfg, acfg, mesh, device)
