"""Train / serve step builders on one device (port of
``repro.runtime.step`` without the mesh).

train_step(params, opt_state, batch) -> (params', opt_state', metrics)
  - microbatched gradient accumulation in ``grad_dtype`` (live
    activation memory = one microbatch), averaged over the microbatches;
  - a remat policy over the layers (``REMAT_POLICIES`` or "blocks:K");
  - the AdamW update, written into the parameters and moments in place
    (the reference donates their buffers).

The params' leaves are leaf tensors: the step turns their
``requires_grad`` on for its forward and backward passes and off again,
so the params it returns serve and compress as any others.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, unflatten_like

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


def make_train_fn(cfg: ArchConfig, acfg: AdamWConfig, microbatches: int = 1,
                  remat: str = "nothing", grad_dtype=torch.float32):
    """The function (params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}). ``remat`` is one of REMAT_POLICIES
    or "blocks:<K>" (a checkpoint per K-layer block, nothing saved
    inside it). The parameters and moments are updated in place."""
    remat_block = 1
    if remat.startswith("blocks:"):
        remat_block = int(remat.split(":")[1])
        policy = REMAT_POLICIES["nothing"]
    else:
        policy = REMAT_POLICIES[remat]

    def grads_of(params, leaves, mb):
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, _ = lm.loss_fn(cfg, params, mb, policy, remat_block)
                return loss.detach(), torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)

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

    return train_step


def make_serve_fn(cfg: ArchConfig):
    def serve_step(params, cache, token, positions):
        return lm.decode_step(cfg, params, cache, token, positions)
    return serve_step


def make_prefill_fn(cfg: ArchConfig):
    def prefill(params, inputs, positions=None):
        return lm.prefill(cfg, params, inputs, positions)
    return prefill
