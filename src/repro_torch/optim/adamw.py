"""AdamW, cosine schedule and global-norm clipping over the params tree
(port of ``repro.optim.adamw``), with the reference's arithmetic: the
gradients go to f32 and are clipped by their global norm before the
step, the bias corrections use the incremented count, the decay uses
the f32 parameter, the new parameter returns to its dtype and the
moments to ``moment_dtype``. ``torch.optim.AdamW`` differs in where the
decay and the bias correction enter, so it is not used.

``adamw_update`` writes the new parameters and moments into the tensors
it was given (under ``no_grad``), each cast to the tensor's dtype as the
reference's ``astype``: the counterpart of the reference's donated
buffers, which keeps a full-width model's optimizer step within one
copy of its state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: Any = torch.float32   # bf16 is the memory option


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor     # int32 scalar


def adamw_init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """Zero moments shaped like ``params`` (on their devices)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    return OptState(tree_map(zeros, params), tree_map(zeros, params),
                    torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine decay to
    ``min_lr_frac · lr`` at ``total_steps`` (f32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm_clip(grads: Any, clip: float) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, clip / ‖grads‖₂). Returns (grads,
    global norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads: Any, state: OptState, params: Any,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, written into ``params`` and the state's moments.
    Returns (params, new state, metrics {grad_norm, lr}): the same
    parameter and moment tensors, and the incremented count."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = global_norm_clip(grads, cfg.clip_norm)
    return adamw_apply(grads, state, params, gnorm, cfg)


@torch.no_grad()
def adamw_apply(grads: Any, state: OptState, params: Any,
                gnorm: torch.Tensor, cfg: AdamWConfig = AdamWConfig()):
    """``adamw_update`` after the clip: ``grads`` are f32 and clipped
    already, by the global norm ``gnorm`` reported in the metrics. A
    mesh's step clips the whole gradients and applies the step to this
    rank's shards of them, of the parameters and of the moments."""
    count = state.count + 1
    lr = cosine_schedule(cfg, count)
    c = count.float()
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c

    def upd(p, g, m, n):
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        n_new = cfg.b2 * n.float() + (1 - cfg.b2) * g * g
        step = (m_new / bc1) / (torch.sqrt(n_new / bc2) + cfg.eps)
        decay = cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * (step + decay))
        m.copy_(m_new)
        n.copy_(n_new)

    tree_map(upd, params, grads, state.mu, state.nu)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.mu, state.nu, count), metrics
