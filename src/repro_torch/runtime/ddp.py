"""Data-parallel train step with int8 error-feedback gradient compression
on the all-reduce (port of ``repro.runtime.ddp``).

Two-phase compressed all-reduce over the "data" ranks, tensor by tensor:
  1. each rank quantizes (grad + error feedback) to int8 with one f32
     scale (``optim.compress.int8_compress``: round half to even);
  2. ``Mesh.all_to_all`` exchanges int8 *shards*: rank i collects every
     rank's slice i of the flattened payload;
  3. each rank sums its slice dequantized over the ranks in f32 and
     requantizes the sum;
  4. ``Mesh.all_gather_native`` gathers the reduced int8 slices and their
     scales; dequantized, they are the sum, divided by the rank count.

The quantized tensors are the reference's: a leaf of the layers is one
tensor stacked over them there, so its layers' gradients (and error
buffers) are quantized as one, concatenated in layer order (the stacked
tensor's flat order), under one scale.

A rank sends ~2·n int8 bytes a step against a ring f32 all-reduce's
~8·n (``Mesh.comm_bytes`` counts them). The quantization residual is
carried into the next step's gradient, so the compression is unbiased
over time.

Params and optimizer state are replicated: every rank holds them whole
and applies the same update. The step takes the global batch and runs
this rank's rows of it, split over "data" as the reference's
``P("data")`` splits it (rank r: rows [r·B/R, (r+1)·B/R)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compress import init_error_buffers, int8_compress
from repro_torch.runtime.step import loss_and_grads
from repro_torch.tree import leaves_with_path, tree_leaves, unflatten_like

AXIS = ("data",)

__all__ = ["build_compressed_ddp_step", "init_error_buffers"]


def _compressed_allreduce_mean(g: torch.Tensor, err: torch.Tensor, mesh):
    """One tensor: returns (mean gradient over the "data" ranks, f32; the
    new error buffer)."""
    n = mesh.n(AXIS)
    g32 = g.float() + err
    q, scale = int8_compress(g32)
    new_err = g32 - q.float() * scale

    flat = q.reshape(-1)
    pad = (-flat.numel()) % n
    flat = F.pad(flat, (0, pad))
    # phase 1: exchange shards and scales
    recv = mesh.all_to_all(flat, AXIS).view(n, -1)
    scales = mesh.all_gather_native(scale.reshape(1), AXIS)
    local_sum = torch.sum(recv.float() * scales[:, None], dim=0)
    # phase 2: requantize the reduced shard, gather
    q2, s2 = int8_compress(local_sum)
    all_q = mesh.all_gather_native(q2, AXIS).view(n, -1)
    all_s = mesh.all_gather_native(s2.reshape(1), AXIS)
    full = (all_q.float() * all_s[:, None]).reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(g.shape) / n, new_err


def _reference_tensors(tree) -> list:
    """The leaves of ``tree`` (flatten order) grouped into the reference's
    tensors: a leaf under "layers" with its counterparts in the other
    layers, in layer order; any other leaf alone."""
    groups: dict = {}
    for j, (path, _) in enumerate(leaves_with_path(tree)):
        if "layers" in path:
            i = path.index("layers")
            path = path[:i + 1] + path[i + 2:]
        groups.setdefault(path, []).append(j)
    return list(groups.values())


def _compressed_mean_of(group, grads, err, mesh):
    """``_compressed_allreduce_mean`` of the leaves ``group`` taken as one
    flat tensor: (their means, their new error buffers)."""
    if len(group) == 1:
        mean, new_err = _compressed_allreduce_mean(grads[group[0]],
                                                   err[group[0]], mesh)
        return [mean], [new_err]
    sizes = [grads[j].numel() for j in group]
    mean, new_err = _compressed_allreduce_mean(
        torch.cat([grads[j].reshape(-1) for j in group]),
        torch.cat([err[j].reshape(-1) for j in group]), mesh)
    shapes = [grads[j].shape for j in group]
    return ([m.reshape(s) for m, s in zip(mean.split(sizes), shapes)],
            [e.reshape(s) for e, s in zip(new_err.split(sizes), shapes)])


def build_compressed_ddp_step(cfg: ArchConfig, acfg: AdamWConfig, mesh,
                              compress: bool = True):
    """(params, opt_state, err_bufs, batch) -> (params', opt', err',
    metrics {loss, grad_norm, lr}). Params replicated and updated in
    place; ``batch`` the global batch, of which this rank runs its rows
    over "data"; the loss the mean over "data". Without ``compress`` the
    gradients' plain f32 mean is taken and ``err`` comes back as it
    was."""
    n = mesh.n(AXIS)
    i = mesh.index(AXIS)
    groups = None

    def step(params, opt_state, err, batch):
        nonlocal groups
        b = len(next(iter(batch.values())))
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} ranks")
        k = b // n
        local = {key: v[i * k:(i + 1) * k] for key, v in batch.items()}
        leaves = tree_leaves(params)
        loss, _, grads = loss_and_grads(cfg, params, leaves, local)
        loss = mesh.all_reduce(loss.float(), AXIS) / n
        if compress:
            groups = groups or _reference_tensors(params)
            errs = tree_leaves(err)
            means, new_err = [None] * len(grads), [None] * len(grads)
            for group in groups:
                m, e = _compressed_mean_of(group, grads, errs, mesh)
                for j, a, b in zip(group, m, e):
                    means[j], new_err[j] = a, b
            grads = means
            err = unflatten_like(err, new_err)
        else:
            grads = [mesh.all_reduce(g.float(), AXIS) / n for g in grads]
        params, opt_state, om = adamw_update(
            unflatten_like(params, grads), opt_state, params, acfg)
        return params, opt_state, err, {"loss": loss, **om}

    return step
