"""Train / serve step builders (port of ``repro.runtime.step``).

train_step(params, opt_state, batch) -> (params', opt_state', metrics)
  - microbatched gradient accumulation in ``grad_dtype`` (live
    activation memory = one microbatch), averaged over the microbatches;
  - a remat policy over the layers (``REMAT_POLICIES`` or "blocks:K");
  - the AdamW update, written into the parameters and moments in place
    (the reference donates their buffers).

The params' leaves are leaf tensors: the step turns their
``requires_grad`` on for its forward and backward passes and off again,
so the params it returns serve and compress as any others.

On a (data, model) mesh (``make_train_fn(planner=...)``) the params and
moments are this rank's shards (``Planner.placement`` of
``lm.param_axes``; a sharded leaf is a ``meshctx.Shard``). Each step
gathers every leaf whole outside autograd, splits the global batch into
microbatches and runs this rank's rows of each (``meshctx.batch_rows``,
as the reference's ``constrain_batch`` shards each microbatch over the
batch axes), all-reduces the gradients over the batch axes, clips them
by their global norm taken on the whole reduced gradients, cuts each to
this rank's shard and applies AdamW to the shards in place. The forward
and backward run on whole tensors outside any ``use_mesh``: compute is
split over the batch axes only, and the "model" ranks run the same rows
(tensor-parallel training compute is ROADMAP A7b).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_apply,
                                     adamw_update, global_norm_clip)
from repro_torch.runtime.meshctx import Shard, batch_rows
from repro_torch.runtime.sharding import (gather_shards, local_tensors,
                                          shard)
from repro_torch.tree import tree_leaves, tree_map, unflatten_like

# the reference's jax.checkpoint policies: "nothing" recomputes each
# layer in the backward pass, "dots" keeps its matmul outputs (aten mm /
# bmm / addmm) and recomputes the rest, "everything" keeps all
REMAT_POLICIES = {
    "none": None,
    "nothing": lm.nothing_saveable,
    "dots": lm.dots_saveable,
    "everything": lm.everything_saveable,
}


def _split_microbatches(batch: Dict[str, Any], n: int) -> list:
    def split(v):
        return np.split(np.asarray(v), n) if not torch.is_tensor(v) \
            else list(torch.chunk(v, n))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def loss_and_grads(cfg: ArchConfig, params, leaves: list, batch,
                   policy=None, remat_block: int = 1):
    """(loss, gradients of ``leaves``) of ``lm.loss_fn`` on ``batch``.
    ``leaves`` are ``tree_leaves(params)``: their ``requires_grad`` is on
    for the pass and off again after it."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, _ = lm.loss_fn(cfg, params, batch, policy, remat_block)
            return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


MOE_DATA_PARALLEL = (
    "the moe family trains only on meshes whose batch axes have size 1: "
    "its Switch aux loss and expert capacity read the whole batch, and "
    "each rank runs its own rows (ROADMAP A7b: global aux statistics and "
    "capacity under data parallelism)")


def make_train_fn(cfg: ArchConfig, acfg: AdamWConfig, microbatches: int = 1,
                  remat: str = "nothing", grad_dtype=torch.float32,
                  planner=None):
    """The function (params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}). ``remat`` is one of REMAT_POLICIES
    or "blocks:<K>" (a checkpoint per K-layer block, nothing saved
    inside it). The parameters and moments are updated in place. With
    ``planner`` (a ``sharding.Planner`` on a mesh with process groups)
    they are this rank's placed shards and ``batch`` is the global batch
    (the module docstring)."""
    if planner is not None and cfg.family == "moe" and \
            planner.mesh.n(planner.batch_axes()) > 1:
        raise ValueError(f"{cfg.name}: {MOE_DATA_PARALLEL}")
    remat_block = 1
    if remat.startswith("blocks:"):
        remat_block = int(remat.split(":")[1])
        policy = REMAT_POLICIES["nothing"]
    else:
        policy = REMAT_POLICIES[remat]

    def grads_of(params, leaves, mb):
        return loss_and_grads(cfg, params, leaves, mb, policy, remat_block)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if microbatches > 1:
            gsum = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                    for p in leaves]
            lsum = 0.0
            for mb in _split_microbatches(batch, microbatches):
                loss, g = grads_of(params, leaves, mb)
                for a, b in zip(gsum, g):
                    a.add_(b.to(grad_dtype))
                lsum = lsum + loss
                del g
            grads = [g / microbatches for g in gsum]
            loss = lsum / microbatches
        else:
            loss, grads = grads_of(params, leaves, batch)
        new_params, new_opt, om = adamw_update(
            unflatten_like(params, list(grads)), opt_state, params, acfg)
        return new_params, new_opt, {"loss": loss, **om}

    if planner is None:
        return train_step
    return _mesh_train_step(cfg, acfg, planner, microbatches, grad_dtype,
                            grads_of)


def _rank_rows(cfg, mb: Dict[str, Any], mesh, dp_size: int):
    """This rank's rows of microbatch ``mb`` and their weight: this
    rank's tokens (its mask's sum) over the microbatch's, so that the
    ranks' weighted mean losses sum to the microbatch's mean (the
    numerator and the token count reduced apart, the count known to every
    rank from the whole batch). Where the rows replicate, every rank runs
    them all at weight 1 / ``dp_size``."""
    b = len(next(iter(mb.values())))
    rows = batch_rows(cfg, b, mesh)
    if rows is None:
        return mb, 1.0 / dp_size
    lo, hi, _ = rows
    local = {k: v[lo:hi] for k, v in mb.items()}
    if "mask" not in mb:
        return local, (hi - lo) / b
    count = float(torch.as_tensor(mb["mask"]).float().sum())
    return local, float(torch.as_tensor(local["mask"]).float().sum()) / max(
        count, 1.0)


def _mesh_train_step(cfg, acfg, planner, microbatches, grad_dtype,
                     grads_of):
    mesh = planner.mesh
    dp = planner.batch_axes()

    def train_step(params, opt_state, batch):
        whole = gather_shards(params, mesh)
        leaves = tree_leaves(whole)
        gsum = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        mbs = (_split_microbatches(batch, microbatches) if microbatches > 1
               else [batch])
        for mb in mbs:
            local, w = _rank_rows(cfg, mb, mesh, mesh.n(dp))
            loss, g = grads_of(whole, leaves, local)
            for a, b in zip(gsum, g):
                a.add_(b.to(grad_dtype), alpha=w)
            lsum = lsum + w * loss.float()
            del g
        del whole, leaves
        grads = [mesh.all_reduce(a, dp).div_(microbatches) for a in gsum]
        del gsum
        loss = mesh.all_reduce(lsum, dp) / microbatches
        grads, gnorm = global_norm_clip(
            unflatten_like(params, [g.float() for g in grads]),
            acfg.clip_norm)
        grads = tree_map(lambda g, p: shard(g, p.spec, mesh)
                         if isinstance(p, Shard) else g, grads, params)
        _, new_opt, om = adamw_apply(
            grads, OptState(local_tensors(opt_state.mu),
                            local_tensors(opt_state.nu), opt_state.count),
            local_tensors(params), gnorm, acfg)
        return params, OptState(opt_state.mu, opt_state.nu,
                                new_opt.count), {"loss": loss, **om}

    return train_step


def make_serve_fn(cfg: ArchConfig):
    def serve_step(params, cache, token, positions):
        return lm.decode_step(cfg, params, cache, token, positions)
    return serve_step


def make_prefill_fn(cfg: ArchConfig):
    def prefill(params, inputs, positions=None):
        return lm.prefill(cfg, params, inputs, positions)
    return prefill
