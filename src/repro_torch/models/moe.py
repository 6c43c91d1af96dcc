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
(``core.packed_model.expert_matmul``, ``dense_experts``); routing and the
combine run on every rank, whole. Where the batch axes split the rows
(``moe_ffn(rows=...)``, the data-parallel train step) each rank routes
its rows as the single device routes the whole batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packed_model import (ExpertPackedStack, dense_experts,
                                           expert_matmul)
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (ArchConfig, dense_init, tap_record,
                                       tap_record_stacked, tap_scope)
from repro_torch.runtime.meshctx import RowSplit, Shard


def _expert_apply(x4: torch.Tensor, w) -> torch.Tensor:
    """Per-expert linear on the dispatch buffer: x4 (G, E, C, D_in) ->
    (G, E, C, D_out). ``w`` is the dense (E, D_in, D_out) leaf or an
    ``ExpertPackedStack``."""
    if isinstance(w, (ExpertPackedStack, Shard)):
        g, e, c, d = x4.shape
        xe = x4.permute(1, 0, 2, 3).reshape(e, g * c, d)
        y = (expert_matmul(xe, w) if isinstance(w, ExpertPackedStack)
             else dense_experts(xe, w))
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


def _split_layout(rows: RowSplit, s: int, tpg: int, n_local: int, dev):
    """Where this rank's ``n_local`` tokens (global offset ``rows.lo ·
    s``, the batch flattened row-major) sit in its share of the global
    dispatch groups of ``tpg`` tokens: (first group, groups touched, each
    token's local group, its column once each group's tokens are left-
    aligned, the widest group's token count)."""
    o = rows.lo * s
    j0 = o // tpg
    g_l = (o + n_local - 1) // tpg - j0 + 1
    t = torch.arange(n_local, device=dev)
    gid = (o + t) // tpg - j0
    start = torch.clamp((j0 + torch.arange(g_l, device=dev)) * tpg - o,
                        min=0)
    col = t - start[gid]
    first = min((j0 + 1) * tpg - o, n_local)
    last = n_local - max((j0 + g_l - 1) * tpg - o, 0)
    width = tpg if g_l > 2 else max(first, last)
    return j0, g_l, gid, col, width


def _group_offsets(rows: RowSplit, counts: torch.Tensor, j0: int, g: int):
    """Each expert's tokens in this rank's groups from the ranks before
    it along the batch axes (g_l, E), and every rank's count summed per
    expert (E,): one gather of the (g, E) per-group counts (one-hot
    sums: no gradient, exact)."""
    mesh = rows.mesh
    table = counts.new_zeros((g, counts.shape[-1]))
    table[j0:j0 + counts.shape[0]] = counts
    every = mesh.all_gather(table[None], rows.axes, 0)       # (R, g, E)
    r = mesh.index(rows.axes)
    before = every[:r].sum(0)[j0:j0 + counts.shape[0]]
    return before, every.sum(dim=(0, 1))


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor,
            rows: Optional[RowSplit] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss scalar).

    With ``rows`` x holds this rank's rows [lo, hi) of a global batch of
    ``rows.b`` rows, and routing is the global batch's: the groups of
    ``moe_group`` tokens cut the flattened global batch (one group of
    all its tokens where they do not divide), capacity follows the
    global group size, and a token's slot counts the tokens of its group
    on the ranks before this one (``_group_offsets``). The aux returned
    is this rank's share: the global token fractions times this rank's
    sum of router probabilities over the global token count, so that the
    ranks' shares sum to the global aux and their gradients to its
    gradient."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    if rows is not None:
        if rows.hi - rows.lo != b:
            raise ValueError(f"moe_ffn: {b} rows for a split of rows "
                             f"[{rows.lo}, {rows.hi})")
        n_glob = rows.b * s
    else:
        n_glob = n_tok
    tpg = min(cfg.moe_group, n_glob)
    if n_glob % tpg:
        tpg = n_glob           # degenerate shapes: one group
    c = capacity(cfg, tpg)

    valid = None
    if rows is None:
        g = n_tok // tpg
        xt = x.reshape(g, tpg, d)
    else:
        j0, g, gid, col, width = _split_layout(rows, s, tpg, n_tok,
                                               x.device)
        xt = x.new_zeros((g, width, d))
        xt[gid, col] = x.reshape(n_tok, d)
        valid = torch.zeros((g, width), dtype=torch.bool, device=x.device)
        valid[gid, col] = True
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
    if valid is not None:          # the layout's padding selects nothing
        vm = valid[..., None].to(probs.dtype)
        gates, sel = gates * vm, sel * vm
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # each token's slot in its experts' buffers (running count); tokens
    # past the capacity are dropped
    pos = torch.cumsum(sel, dim=1) - sel                       # (G,T,E)
    if rows is not None:
        before, total = _group_offsets(rows, sel.sum(dim=1), j0,
                                       n_glob // tpg)
        pos = pos + before[:, None, :]
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
    y = torch.einsum("gtec,gecd->gtd", combine, expert_out)

    # Switch load-balancing aux: E * sum_e f_e * P_e
    if rows is None:
        y = y.reshape(b, s, d)
        frac_tokens = sel.mean(dim=(0, 1)) / k
        frac_probs = probs.mean(dim=(0, 1))
    else:
        y = y[gid, col].reshape(b, s, d)
        frac_tokens = total / n_glob / k
        frac_probs = (probs * valid[..., None]).sum(dim=(0, 1)) / n_glob
    aux = e * torch.sum(frac_tokens * frac_probs)

    if cfg.shared_ff:
        with tap_scope("shared"):
            y = y + mlp_lib.mlp(cfg.with_(act="swiglu"), p["shared"], x)
    return y, aux
