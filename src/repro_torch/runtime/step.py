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
moments are this rank's shards (``Planner.tree_specs`` of
``lm.param_axes``: over "data" and over "model"; a sharded leaf is a
``meshctx.Shard``). Each step gathers every leaf whole outside autograd,
splits the global batch into microbatches and runs this rank's rows of
each (``meshctx.row_split``, as the reference's ``constrain_batch``
shards each microbatch over the batch axes), all-reduces the gradients
over the batch axes, clips them by their global norm taken on the whole
reduced gradients, cuts each to this rank's shard and applies AdamW to
the shards in place. The forward and backward run on whole tensors
outside any ``use_mesh``, given the row split (``lm.loss_fn(rows=)``):
the attention mask reads the global microbatch's first row, and the MoE
layers route, fill their capacity and take their aux statistics as the
single device does on the whole microbatch. Compute is split over the
batch axes only: the "model" ranks run the same rows.

A rank's loss is its share of the microbatch's: its cross-entropy
weighed by its share of the masked tokens, plus its share of the aux
loss (the global token fractions against its rows' router
probabilities over the global token count), so that the ranks' losses
and gradients sum to the microbatch's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_apply,
                                     adamw_update, global_norm_clip)
from repro_torch.runtime.meshctx import Shard, row_split, use_mesh
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
                   policy=None, remat_block: int = 1, rows=None,
                   weights=(1.0, 1.0)):
    """(loss, aux, gradients of ``leaves``) of ``w_ce · ce + w_aux ·
    AUX_LOSS_WEIGHT · aux`` from ``lm.loss_fn`` on ``batch`` (``rows``:
    its row split), ``weights`` = (w_ce, w_aux); the loss and aux come
    back weighed. ``leaves`` are ``tree_leaves(params)``: their
    ``requires_grad`` is on for the pass and off again after it."""
    w_ce, w_aux = weights
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            _, m = lm.loss_fn(cfg, params, batch, policy, remat_block, rows)
            aux = w_aux * m["aux"]
            loss = w_ce * m["ce"] + lm.AUX_LOSS_WEIGHT * aux
            return (loss.detach(), aux.detach(),
                    torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)


def make_train_fn(cfg: ArchConfig, acfg: AdamWConfig, microbatches: int = 1,
                  remat: str = "nothing", grad_dtype=torch.float32,
                  planner=None):
    """The function (params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}). ``remat`` is one of REMAT_POLICIES
    or "blocks:<K>" (a checkpoint per K-layer block, nothing saved
    inside it). The parameters and moments are updated in place. With
    ``planner`` (a ``sharding.Planner`` on a mesh with process groups)
    they are this rank's placed shards and ``batch`` is the global batch
    (the module docstring). The metrics also hold ``aux``, the mean of
    the microbatches' aux losses."""
    remat_block = 1
    if remat.startswith("blocks:"):
        remat_block = int(remat.split(":")[1])
        policy = REMAT_POLICIES["nothing"]
    else:
        policy = REMAT_POLICIES[remat]

    def grads_of(params, leaves, mb, rows=None, weights=(1.0, 1.0)):
        return loss_and_grads(cfg, params, leaves, mb, policy, remat_block,
                              rows, weights)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if microbatches > 1:
            gsum = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                    for p in leaves]
            lsum = asum = 0.0
            for mb in _split_microbatches(batch, microbatches):
                loss, aux, g = grads_of(params, leaves, mb)
                for a, b in zip(gsum, g):
                    a.add_(b.to(grad_dtype))
                lsum, asum = lsum + loss, asum + aux
                del g
            grads = [g / microbatches for g in gsum]
            loss, aux = lsum / microbatches, asum / microbatches
        else:
            loss, aux, grads = grads_of(params, leaves, batch)
        new_params, new_opt, om = adamw_update(
            unflatten_like(params, list(grads)), opt_state, params, acfg)
        return new_params, new_opt, {"loss": loss, "aux": aux, **om}

    if planner is None:
        return train_step
    return _mesh_train_step(cfg, acfg, planner, microbatches, grad_dtype,
                            grads_of)


def _rank_rows(cfg, mb: Dict[str, Any], mesh, dp_size: int):
    """This rank's rows of microbatch ``mb``, their ``meshctx.RowSplit``
    and their weights (w_ce, w_aux). w_ce is this rank's tokens (its
    mask's sum) over the microbatch's, so that the ranks' weighted mean
    losses sum to the microbatch's mean (the numerator and the token
    count reduced apart, the count known to every rank from the whole
    batch); the aux the rows return is already this rank's share of the
    microbatch's (w_aux 1). Where the rows replicate, every rank runs
    them all at weights 1 / ``dp_size``, and with no split."""
    b = len(next(iter(mb.values())))
    pos = mb.get("positions")
    rows = row_split(cfg, b, None if pos is None else pos[0], mesh)
    if rows is None:
        return mb, None, (1.0 / dp_size, 1.0 / dp_size)
    lo, hi = rows.lo, rows.hi
    local = {k: v[lo:hi] for k, v in mb.items()}
    if "mask" not in mb:
        return local, rows, ((hi - lo) / b, 1.0)
    count = float(torch.as_tensor(mb["mask"]).float().sum())
    return local, rows, (float(torch.as_tensor(local["mask"]).float().sum())
                         / max(count, 1.0), 1.0)


def _mesh_train_step(cfg, acfg, planner, microbatches, grad_dtype,
                     grads_of):
    mesh = planner.mesh
    dp = planner.batch_axes()

    def train_step(params, opt_state, batch):
        whole = gather_shards(params, mesh)
        leaves = tree_leaves(whole)
        gsum = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                for p in leaves]
        sums = torch.zeros(2, dtype=torch.float32, device=mesh.device)
        mbs = (_split_microbatches(batch, microbatches) if microbatches > 1
               else [batch])
        for mb in mbs:
            local, rows, w = _rank_rows(cfg, mb, mesh, mesh.n(dp))
            loss, aux, g = grads_of(whole, leaves, local, rows, w)
            for a, b in zip(gsum, g):
                a.add_(b.to(grad_dtype))
            sums = sums + torch.stack([loss.float(), aux.float()])
            del g
        del whole, leaves
        grads = [mesh.all_reduce(a, dp).div_(microbatches) for a in gsum]
        del gsum
        loss, aux = (mesh.all_reduce(sums, dp) / microbatches).unbind(0)
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
                                new_opt.count), {"loss": loss, "aux": aux,
                                                 **om}

    return train_step


def make_serve_fn(cfg: ArchConfig):
    def serve_step(params, cache, token, positions):
        return lm.decode_step(cfg, params, cache, token, positions)
    return serve_step


def make_prefill_fn(cfg: ArchConfig, planner=None):
    """(params, inputs, positions=None) -> logits of ``lm.prefill``; with
    ``planner`` (a ``sharding.Planner`` on a mesh with process groups)
    on params placed by its specs, under its mesh: every family, the
    audio encoder on frame embeddings included."""
    mesh = None if planner is None else planner.mesh

    def prefill(params, inputs, positions=None):
        with use_mesh(mesh):
            return lm.prefill(cfg, params, inputs, positions)
    return prefill
