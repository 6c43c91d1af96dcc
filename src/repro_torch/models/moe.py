"""Mixture-of-Experts layer (port of ``repro.models.moe``): sort-free
capacity-based top-k dispatch.

Tokens are reshaped into dispatch groups of ``cfg.moe_group`` tokens;
the gates and a within-group running count build a one-hot dispatch
tensor (G, T, E, C) that einsums the tokens into per-expert buffers
(G, E, C, D). The earlier tokens of a group win an expert's C slots; a
token past them is dropped for that expert (its gate there is 0), so a
token's output depends on the other tokens of its group. The port keeps
that coupling exactly, flatten order and capacity included.

The expert linears run on the (G, E, C, D) buffer: a dense (E, D_in,
D_out) leaf is a batched matmul, an ``ExpertPackedStack`` goes through
``core.packed_model.expert_matmul`` (one grouped-kernel launch per
expert bucket). Returns the Switch load-balancing aux loss beside the
output. With ``cfg.shared_ff`` (DeepSeek-MoE) an always-on SwiGLU MLP
of that width, the shared experts, is added to the routed output; its
linears tap as ``moe.shared.*`` and pack as plain 2-D linears.

Under a mesh the expert linears run expert-parallel
(``core.packed_model.expert_matmul``); routing and the combine run on
every rank, whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packed_model import ExpertPackedStack, expert_matmul
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (ArchConfig, dense_init, tap_record,
                                       tap_record_stacked, tap_scope)


def _expert_apply(x4: torch.Tensor, w) -> torch.Tensor:
    """Per-expert linear on the dispatch buffer: x4 (G, E, C, D_in) ->
    (G, E, C, D_out). ``w`` is the dense (E, D_in, D_out) leaf or an
    ``ExpertPackedStack``."""
    if isinstance(w, ExpertPackedStack):
        g, e, c, d = x4.shape
        xe = x4.permute(1, 0, 2, 3).reshape(e, g * c, d)
        y = expert_matmul(xe, w)
        return y.reshape(e, g, c, -1).permute(1, 0, 2, 3)
    return torch.einsum("gecd,edf->gecf", x4, w)


def moe_axes(cfg: ArchConfig) -> dict:
    """Logical axes of the MoE layer's params (runtime.sharding)."""
    axes = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }
    if cfg.shared_ff:
        axes["shared"] = mlp_lib.mlp_axes(cfg.with_(act="swiglu"))
    return axes


def init_moe(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, e), d, torch.float32, device),
         "w_gate": dense_init(gen, (e, d, f), d, cfg.dtype, device),
         "w_up": dense_init(gen, (e, d, f), d, cfg.dtype, device),
         "w_down": dense_init(gen, (e, f, d), f, cfg.dtype, device)}
    if cfg.shared_ff:
        p["shared"] = mlp_lib.init_mlp(cfg.with_(act="swiglu"), gen, device,
                                       d_ff=cfg.shared_ff)
    return p


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(c, cfg.top_k)


def moe_ffn(cfg: ArchConfig, p: dict,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    tpg = min(cfg.moe_group, n_tok)
    if n_tok % tpg:
        tpg = n_tok            # degenerate shapes: one group
    g = n_tok // tpg
    c = capacity(cfg, tpg)

    xt = x.reshape(g, tpg, d)
    tap_record("router", xt)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)

    # top-k: peel off the argmax k times (both frameworks return the
    # first maximal index)
    gates = torch.zeros_like(probs)
    sel = torch.zeros_like(probs)
    remaining = probs
    for _ in range(k):
        oh = F.one_hot(remaining.argmax(-1), e).to(probs.dtype)
        gates = gates + remaining * oh
        sel = sel + oh
        remaining = remaining * (1.0 - oh)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # each token's slot in its experts' buffers (running count); tokens
    # past the capacity are dropped
    pos = torch.cumsum(sel, dim=1) - sel                       # (G,T,E)
    keep = sel * (pos < c)
    gates = gates * (keep.sum(-1, keepdim=True) > 0)
    # a one-hot by comparison: a position >= c matches no slot
    slot = (pos[..., None] == torch.arange(c, dtype=pos.dtype,
                                           device=pos.device)).to(xt.dtype)
    dispatch = slot * keep[..., None].to(xt.dtype)            # (G,T,E,C)
    combine = dispatch * gates[..., None].to(xt.dtype)

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xt)   # (G,E,C,D)
    tap_record_stacked("w_gate", expert_in, stack_axis=1)
    tap_record_stacked("w_up", expert_in, stack_axis=1)
    h = F.silu(_expert_apply(expert_in, p["w_gate"])) \
        * _expert_apply(expert_in, p["w_up"])
    tap_record_stacked("w_down", h, stack_axis=1)
    expert_out = _expert_apply(h, p["w_down"])                 # (G,E,C,D)
    y = torch.einsum("gtec,gecd->gtd", combine, expert_out).reshape(b, s, d)

    # Switch load-balancing aux: E * sum_e f_e * P_e
    frac_tokens = sel.mean(dim=(0, 1)) / k
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)

    if cfg.shared_ff:
        with tap_scope("shared"):
            y = y + mlp_lib.mlp(cfg.with_(act="swiglu"), p["shared"], x)
    return y, aux
