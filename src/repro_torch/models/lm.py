"""Language model assembly of the six families, dense, moe, ssm, hybrid,
vlm and audio (port of ``repro.models.lm``).

Params are a plain dict: ``embed`` (V, D), ``layers`` — a list with one
dict per layer ({attn_norm, mlp_norm, attn: {wq, wk, wv, wo}, mlp:
{w_gate, w_up, w_down}}; the moe family holds ``moe``: {router, w_gate,
w_up, w_down} with a leading expert dim, and ``shared`` (a SwiGLU MLP
dict) when the config has shared experts, in place of ``mlp``; the ssm
and hybrid families hold {norm, mamba}, ``models.mamba2``'s block),
``final_norm`` and ``lm_head`` (D, V). Where
the reference scans stacked layers with ``lax.scan``, this port loops
over the list in Python. Linear weights are (D_in, D_out); a linear may
also be a ``core.packed_model.PackedLinear``. ``decode_step`` runs on a
contiguous cache with one host-int offset for the batch;
``paged_decode_step`` (the serving engine's) on a paged cache with a
device tensor of per-row lengths, for the KV-attention families only.

Hybrid (zamba2) layout: every layer is a Mamba-2 block; layers with
``idx % attn_every == attn_every - 1`` first run one *shared*
transformer block (attention + MLP) whose parameters,
``params["shared_attn"]``, are common to all invocations. The layer
index is a host int, so the firing test is a plain ``if``.

Family quirks (the reference's): audio is an encoder (non-causal, no
rotary embedding) whose input is precomputed frame embeddings: it has
no ``embed`` table and no decode path. vlm takes M-RoPE positions (B, S,
3); its prefill may take precomputed patch embeddings, its decode takes
text token ids, and its ``embed`` table is also the unembedding (tied:
no ``lm_head``). ``final_norm`` is the one leaf every family's tree
holds (``params_device``).

``forward`` and ``loss_fn`` record gradients when the caller is in grad
mode (training); the serving entry points run under ``no_grad``. Their
``remat_policy`` checkpoints each layer, or each block of
``remat_block`` layers, with ``torch.utils.checkpoint``: one of the
selective-checkpoint policies below (``nothing_saveable`` recomputes
the whole layer in the backward pass, ``dots_saveable`` keeps the
matmul outputs, ``everything_saveable`` keeps all), or None for no
checkpoint.

Under a mesh (``runtime.meshctx.use_mesh``) the params are this rank's
shards (``runtime.sharding``): each layer's dense shards are gathered
over "data" before the layer runs; what is split over "model" runs
tensor-parallel: packed leaves on their rows, dense linears on their
columns or rows (``core.packed_model.linear``), a Mamba layer on its
heads, and the vocab-sharded embedding table serves its rows' lookups
and logits. The decode caches are placed as the planner places them:
KV positions over "model", a Mamba layer's state by its heads. Where
the batch axes split a batch's rows, ``forward`` takes the split
(``rows``): the attention mask reads the global batch's first row and
the MoE layer routes as the single device does. ``param_axes`` /
``cache_axes`` give the logical axes the planner places them by, one
dict per layer (no "layers" lead).
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (ArchConfig, dense_init, embed_init,
                                       positions_for, rms_norm,
                                       softmax_xent, tap_scope)
from repro_torch.runtime.meshctx import (RowSplit, Shard, current_mesh,
                                         gather_data, gather_dense,
                                         gather_model, merge_model,
                                         model_shards, row_split, whole)

AUX_LOSS_WEIGHT = 0.01


SSM_FAMILIES = ("ssm", "hybrid")
FAMILIES = ("dense", "moe", "vlm", "audio") + SSM_FAMILIES
# the families without a KV-cache decode: the paged engine refuses them
NO_PAGED_DECODE = SSM_FAMILIES + ("audio",)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def params_device(params: dict) -> torch.device:
    """The device ``params`` live on, read from ``final_norm``: a leaf of
    every family's tree (the audio model has no ``embed``)."""
    return params["final_norm"].device


def check_params_on(params: dict, dev: torch.device, what: str) -> None:
    """Raise unless ``params`` live on ``dev``'s device type, where
    ``what`` was asked to run."""
    got = params_device(params)
    if got.type != dev.type:
        raise ValueError(f"params live on {got}, {what} was asked to run "
                         f"on {dev}")


def _layer_axes(cfg: ArchConfig) -> dict:
    """Logical axes of one layer's params."""
    if cfg.family in SSM_FAMILIES:
        return {"norm": ("embed",), "mamba": mamba_lib.mamba_axes()}
    a: dict = {"attn_norm": ("embed",), "mlp_norm": ("embed",),
               "attn": attn_lib.attention_axes()}
    if cfg.family == "moe":
        a["moe"] = moe_lib.moe_axes(cfg)
    else:
        a["mlp"] = mlp_lib.mlp_axes(cfg)
    return a


def param_axes(cfg: ArchConfig) -> dict:
    """The params' logical-axes tree (``runtime.sharding.Planner``)."""
    _check_family(cfg)
    axes: dict = {"layers": [_layer_axes(cfg) for _ in range(cfg.n_layers)],
                  "final_norm": ("embed",)}
    if cfg.input_mode == "tokens" or cfg.family == "vlm":
        axes["embed"] = ("vocab", "embed")
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.family == "hybrid":
        axes["shared_attn"] = {
            "attn_norm": ("embed",), "mlp_norm": ("embed",),
            "attn": attn_lib.attention_axes(), "mlp": mlp_lib.mlp_axes(cfg)}
    return axes


def _init_ffn(cfg: ArchConfig, gen: torch.Generator, dev) -> dict:
    if cfg.family == "moe":
        return {"moe": moe_lib.init_moe(cfg, gen, dev)}
    return {"mlp": mlp_lib.init_mlp(cfg, gen, dev)}


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor,
         rows: Optional[RowSplit] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward half on the residual stream h: the MLP,
    or the MoE layer with its aux loss, on rms_norm(h). Returns (h + y,
    aux), aux None for the MLP."""
    hin = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        with tap_scope("moe"):
            y, aux = moe_lib.moe_ffn(cfg, lp["moe"], hin, rows)
        return h + y, aux
    with tap_scope("mlp"):
        y = mlp_lib.mlp(cfg, lp["mlp"], hin)
    return h + y, None


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random params from ``seed`` through the port's own generator (the
    reference's JAX PRNG stream cannot be reproduced; tests bridge the
    reference's weights instead). Runs on CUDA unless ``device="cpu"``."""
    _check_family(cfg)
    return _init_on(cfg, seed, resolve_device(device))


def abstract_params(cfg: ArchConfig) -> dict:
    """The params' structure, shapes and dtypes on the ``meta`` device:
    nothing is allocated (the checkpoint template)."""
    _check_family(cfg)
    return _init_on(cfg, 0, torch.device("meta"))


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``'s model (counted on the ``meta`` device)."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(abstract_params(cfg)))


def _init_on(cfg: ArchConfig, seed: int, dev: torch.device) -> dict:
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    ones = lambda: torch.ones(cfg.d_model, dtype=torch.float32, device=dev)
    if cfg.family in SSM_FAMILIES:
        layers = [{"norm": ones(),
                   "mamba": mamba_lib.init_mamba(cfg, gen, dev)}
                  for _ in range(cfg.n_layers)]
    else:
        layers = [{"attn_norm": ones(), "mlp_norm": ones(),
                   "attn": attn_lib.init_attention(cfg, gen, dev),
                   **_init_ffn(cfg, gen, dev)}
                  for _ in range(cfg.n_layers)]
    params = {"layers": layers, "final_norm": ones()}
    if cfg.input_mode == "tokens" or cfg.family == "vlm":
        params["embed"] = embed_init(gen, (cfg.vocab, cfg.d_model),
                                     cfg.dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.d_model, cfg.dtype, dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "attn_norm": ones(), "mlp_norm": ones(),
            "attn": attn_lib.init_attention(cfg, gen, dev),
            "mlp": mlp_lib.init_mlp(cfg, gen, dev)}
    return params


def shared_fires(cfg: ArchConfig, idx: int) -> bool:
    """Whether the hybrid's shared block runs before layer ``idx``."""
    return (cfg.family == "hybrid" and bool(cfg.attn_every)
            and idx % cfg.attn_every == cfg.attn_every - 1)


def _attn_layer(cfg: ArchConfig, lp: dict, h: torch.Tensor,
                positions: torch.Tensor, rows: Optional[RowSplit] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A transformer layer (attention, then ``_ffn``) of the full-sequence
    forward: a dense or moe layer, or the hybrid's shared block."""
    with tap_scope("attn"):
        a = attn_lib.multihead_attention(
            cfg, lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps),
            positions, None if rows is None else rows.first)
    return _ffn(cfg, lp, h + a, rows)


def _layer_fwd(cfg: ArchConfig, params: dict, lp: dict, idx: int,
               h: torch.Tensor, positions: torch.Tensor,
               rows: Optional[RowSplit] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the full-sequence forward. Returns (h, aux)."""
    lp = gather_dense(lp)
    if cfg.family in SSM_FAMILIES:
        if shared_fires(cfg, idx):
            with tap_scope("shared"):
                h, _ = _attn_layer(cfg, gather_dense(params["shared_attn"]),
                                   h, positions, rows)
        with tap_scope("mamba"):
            h = h + mamba_lib.mamba_block(
                cfg, lp["mamba"], rms_norm(h, lp["norm"], cfg.norm_eps))
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    h, aux = _attn_layer(cfg, lp, h, positions, rows)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def _vocab_split(t, dim: int) -> bool:
    """Whether ``t`` is a Shard whose vocab dim ``dim`` is split over
    "model"."""
    return (isinstance(t, Shard) and t.spec[dim] == "model"
            and model_shards()[1] > 1)


def embed_inputs(cfg: ArchConfig, params: dict,
                 inputs: torch.Tensor) -> torch.Tensor:
    """Token ids -> table lookup; float inputs (the stub frontends'
    patch or frame embeddings) pass through at the model dtype. On a
    vocab-sharded table each rank looks up the ids in its rows (zeros
    elsewhere) and the ranks merge, bit for bit."""
    if inputs.is_floating_point():
        return inputs.to(cfg.dtype)
    table = params["embed"]
    if not _vocab_split(table, 0):
        return F.embedding(inputs.long(), whole(table))
    rows = whole(table, keep=(0,))
    n = rows.shape[0]
    ids = inputs.long() - model_shards()[0] * n
    mine = (ids >= 0) & (ids < n)
    e = F.embedding(ids.clamp(0, n - 1), rows)
    return merge_model(torch.where(mine[..., None], e, torch.zeros_like(e)))


def unembed(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits; on a vocab-sharded table or head, this rank's vocab slice,
    gathered over "model"."""
    if cfg.tie_embeddings:
        table = params["embed"]
        if _vocab_split(table, 0):
            return gather_model(h @ whole(table, keep=(0,)).T)
        return h @ whole(table).T
    head = params["lm_head"]
    if _vocab_split(head, 1):
        return gather_model(h @ whole(head, keep=(1,)))
    return h @ whole(head)


# ------------------------------------------------------------------
# Activation checkpointing (the reference's jax.checkpoint policies)
# ------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def nothing_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Recompute every op of the checkpointed region."""
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the matmul outputs (mm / bmm / addmm), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def everything_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep every op's output: nothing is recomputed."""
    return CheckpointPolicy.MUST_SAVE


def _remat(fn: Callable, policy: Optional[Callable]) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` with ``policy`` (None: as
    it is)."""
    if policy is None:
        return fn
    if policy is nothing_saveable:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


def forward(cfg: ArchConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            remat_policy: Optional[Callable] = None,
            remat_block: int = 1, rows: Optional[RowSplit] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), aux).

    With ``remat_policy``, each layer runs under that checkpoint policy;
    with ``remat_block`` = K > 1 dividing the depth, each block of K
    layers does instead (only the block boundaries' activations stay for
    the backward pass). With ``rows`` (``meshctx.RowSplit``) the inputs
    are this rank's rows of a larger batch: the mask reads that batch's
    first row, the MoE layers route by its groups, and aux is this
    rank's share (``models.moe.moe_ffn``)."""
    _check_family(cfg)
    b, s = inputs.shape[0], inputs.shape[1]
    h = embed_inputs(cfg, params, inputs)
    if positions is None:
        positions = positions_for(cfg, b, s, device=h.device)
    layers = params["layers"]

    def run(lo: int, hi: int, h: torch.Tensor, aux: torch.Tensor):
        for l in range(lo, hi):
            h, a = _layer_fwd(cfg, params, layers[l], l, h, positions,
                              rows)
            aux = aux + a
        return h, aux

    k = remat_block
    n = len(layers)
    step = k if k > 1 and n % k == 0 else 1
    block = _remat(run, remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, n, step):
        h, aux = block(lo, lo + step, h, aux)
    h = rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)
    return unembed(cfg, params, h), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            remat_policy: Optional[Callable] = None,
            remat_block: int = 1, rows: Optional[RowSplit] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token loss of one batch ({inputs, labels[, positions, mask]}):
    ce + AUX_LOSS_WEIGHT · aux. exp(ce) is the perplexity the paper
    reports. Differentiable in grad mode (``forward``'s remat options).
    The batch's arrays move to the params' device. With ``rows`` the
    batch is this rank's rows of a larger one (``forward``)."""
    dev = params_device(params)
    inputs = torch.as_tensor(batch["inputs"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    mask, positions = batch.get("mask"), batch.get("positions")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    if positions is not None:
        positions = torch.as_tensor(positions, device=dev)
    logits, aux = forward(cfg, params, inputs, positions, remat_policy,
                          remat_block, rows)
    ce = softmax_xent(logits, labels, mask)
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


class SSMCache(NamedTuple):
    """The decode cache of the ssm and hybrid families: one MambaCache per
    layer and, for the hybrid, one KVCache per shared-block invocation
    (None for ssm)."""
    mamba: List[mamba_lib.MambaCache]
    shared_kv: Optional[List[attn_lib.KVCache]]


def n_shared_invocations(cfg: ArchConfig) -> int:
    if cfg.family != "hybrid" or not cfg.attn_every:
        return 0
    return cfg.n_layers // cfg.attn_every


def init_cache(cfg: ArchConfig, batch: int, s_max: int, device=None):
    """The empty decode cache: one KVCache per layer (dense, moe), or an
    ``SSMCache`` (ssm, hybrid), whose Mamba part does not depend on
    ``s_max``."""
    _check_family(cfg)
    if cfg.family in SSM_FAMILIES:
        skv = None
        if cfg.family == "hybrid":
            skv = [attn_lib.init_kv_cache(cfg, batch, s_max, device)
                   for _ in range(n_shared_invocations(cfg))]
        return SSMCache([mamba_lib.init_mamba_cache(cfg, batch, device)
                         for _ in range(cfg.n_layers)], skv)
    return [attn_lib.init_kv_cache(cfg, batch, s_max, device)
            for _ in range(cfg.n_layers)]


def cache_axes(cfg: ArchConfig):
    """Logical axes of ``init_cache``'s cache: one ``attn.kv_cache_axes``
    per layer, or an ``SSMCache`` of them."""
    _check_family(cfg)
    if cfg.family in SSM_FAMILIES:
        skv = None
        if cfg.family == "hybrid":
            skv = [attn_lib.kv_cache_axes(cfg)
                   for _ in range(n_shared_invocations(cfg))]
        return SSMCache([mamba_lib.mamba_cache_axes()
                         for _ in range(cfg.n_layers)], skv)
    return [attn_lib.kv_cache_axes(cfg) for _ in range(cfg.n_layers)]


def _layer_decode(cfg: ArchConfig, lp: dict, h: torch.Tensor,
                  kv_l: attn_lib.KVCache, positions: torch.Tensor):
    lp = gather_dense(lp)
    with tap_scope("attn"):
        a, kc = attn_lib.decode_attention(
            cfg, lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps),
            kv_l, positions)
    h, _ = _ffn(cfg, lp, h + a)
    return h, kc


def _ssm_decode(cfg: ArchConfig, params: dict, cache: SSMCache,
                h: torch.Tensor, positions: torch.Tensor):
    """The ssm / hybrid layer loop of ``decode_step``: the hybrid's shared
    block runs (invocation ``idx // attn_every``) before the Mamba block
    of each firing layer."""
    skv = None if cache.shared_kv is None else list(cache.shared_kv)
    mc = []
    for idx, (lp, mc_l) in enumerate(zip(params["layers"], cache.mamba)):
        lp = gather_dense(lp)
        if shared_fires(cfg, idx):
            inv = idx // cfg.attn_every
            with tap_scope("shared"):
                h, skv[inv] = _layer_decode(cfg, params["shared_attn"], h,
                                            skv[inv], positions)
        with tap_scope("mamba"):
            y, mc_new = mamba_lib.mamba_decode_step(
                cfg, lp["mamba"], rms_norm(h, lp["norm"], cfg.norm_eps),
                mc_l)
        h = h + y
        mc.append(mc_new)
    return h, SSMCache(mc, skv)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache, token: torch.Tensor,
                positions: torch.Tensor):
    """One decode step. token (B, 1) ints; positions (B, 1), or (B, 1, 3)
    under M-RoPE. Returns (logits (B, 1, V), new cache). KV tensors
    update in place; the Mamba states of the ssm and hybrid families
    come back as new tensors."""
    h = embed_inputs(cfg, params, token)
    if cfg.family in SSM_FAMILIES:
        h, new_cache = _ssm_decode(cfg, params, cache, h, positions)
    else:
        new_cache = []
        for lp, kv_l in zip(params["layers"], cache):
            h, kc = _layer_decode(cfg, lp, h, kv_l, positions)
            new_cache.append(kc)
    h = rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)
    return unembed(cfg, params, h), new_cache


def _layer_decode_paged(cfg: ArchConfig, lp: dict, h: torch.Tensor,
                        pool_l, block_tables: torch.Tensor,
                        lengths: torch.Tensor, positions: torch.Tensor,
                        active):
    lp = gather_dense(lp)
    with tap_scope("attn"):
        a, pool_l = attn_lib.paged_decode_attention(
            cfg, lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps),
            pool_l, block_tables, lengths, positions, active)
    h, _ = _ffn(cfg, lp, h + a)
    return h, pool_l


@torch.no_grad()
def paged_decode_step(cfg: ArchConfig, params: dict, paged: list,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      token: torch.Tensor, active):
    """One decode step against the paged KV cache (serving engine path).

    token (R, 1) ints over the engine's fixed request slots; paged a list
    of per-layer ``serving.paged_cache.PagedKVCache``; block_tables
    (R, n_bt) int32 and lengths (R,) int32 (tokens already cached per
    row) on the params' device; active (R,) bool, best on the host.
    Returns (logits (R, 1, V), paged); the pools update in place.
    Inactive rows write nothing into the pool and their logits are
    garbage-but-finite. Where the reference scans the layers, this port
    loops over them in Python. KV-attention families with a decode path
    only (not ssm, hybrid or audio)."""
    _check_family(cfg)
    if cfg.family in NO_PAGED_DECODE:
        raise ValueError(f"paged decode: unsupported family {cfg.family!r}")
    r = token.shape[0]
    positions = positions_for(cfg, r, 1, offset=lengths[:, None],
                              device=lengths.device)
    h = embed_inputs(cfg, params, token)
    for lp, pool_l in zip(params["layers"], paged):
        h, _ = _layer_decode_paged(cfg, lp, h, pool_l, block_tables,
                                   lengths, positions, active)
    h = rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)
    return unembed(cfg, params, h), paged


@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill = the full forward's logits (the cache fill is modelled as
    the forward pass); the audio encoder's only serving entry point.

    Under a mesh whose batch axes split the rows (``meshctx.batch_rows``;
    the moe family excepted, as in ``greedy_decode``: its capacity
    couples the rows of a group), each rank runs its rows and the logits
    are gathered: every rank returns the whole batch's."""
    rows = None
    if current_mesh() is not None and cfg.family != "moe":
        rows = row_split(cfg, inputs.shape[0],
                         None if positions is None else positions[0])
    if rows is None:
        logits, _ = forward(cfg, params, inputs, positions)
        return logits
    sl = slice(rows.lo, rows.hi)
    logits, _ = forward(cfg, params, inputs[sl],
                        None if positions is None else positions[sl],
                        rows=rows)
    return gather_data(logits, 0, rows.axes)
