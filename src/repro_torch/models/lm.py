"""Language model assembly, dense and moe families (port of
``repro.models.lm``).

Params are a plain dict: ``embed`` (V, D), ``layers`` — a list with one
dict per layer ({attn_norm, mlp_norm, attn: {wq, wk, wv, wo}, mlp:
{w_gate, w_up, w_down}}; the moe family holds ``moe``: {router, w_gate,
w_up, w_down} with a leading expert dim, and ``shared`` (a SwiGLU MLP
dict) when the config has shared experts, in place of ``mlp``),
``final_norm`` and ``lm_head`` (D, V). Where
the reference scans stacked layers with ``lax.scan``, this port loops
over the list in Python. Linear weights are (D_in, D_out); a linear may
also be a ``core.packed_model.PackedLinear``. ``decode_step`` runs on a
contiguous cache with one host-int offset for the batch;
``paged_decode_step`` (the serving engine's) on a paged cache with a
device tensor of per-row lengths.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (ArchConfig, dense_init, embed_init,
                                       positions_for, rms_norm,
                                       softmax_xent, tap_scope)

AUX_LOSS_WEIGHT = 0.01


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")


def _init_ffn(cfg: ArchConfig, gen: torch.Generator, dev) -> dict:
    if cfg.family == "moe":
        return {"moe": moe_lib.init_moe(cfg, gen, dev)}
    return {"mlp": mlp_lib.init_mlp(cfg, gen, dev)}


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward half on the residual stream h: the MLP,
    or the MoE layer with its aux loss, on rms_norm(h). Returns (h + y,
    aux), aux None for the MLP."""
    hin = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        with tap_scope("moe"):
            y, aux = moe_lib.moe_ffn(cfg, lp["moe"], hin)
        return h + y, aux
    with tap_scope("mlp"):
        y = mlp_lib.mlp(cfg, lp["mlp"], hin)
    return h + y, None


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random params from ``seed`` through the port's own generator (the
    reference's JAX PRNG stream cannot be reproduced; tests bridge the
    reference's weights instead). Runs on CUDA unless ``device="cpu"``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ones = lambda: torch.ones(cfg.d_model, dtype=torch.float32, device=dev)
    layers = [{"attn_norm": ones(), "mlp_norm": ones(),
               "attn": attn_lib.init_attention(cfg, gen, dev),
               **_init_ffn(cfg, gen, dev)}
              for _ in range(cfg.n_layers)]
    params = {"layers": layers, "final_norm": ones(),
              "embed": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype,
                                  dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.d_model, cfg.dtype, dev)
    return params


def _layer_fwd(cfg: ArchConfig, params: dict, lp: dict, idx: int,
               h: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the full-sequence forward. Returns (h, aux)."""
    with tap_scope("attn"):
        a = attn_lib.multihead_attention(
            cfg, lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps),
            positions)
    h, aux = _ffn(cfg, lp, h + a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def embed_inputs(cfg: ArchConfig, params: dict,
                 inputs: torch.Tensor) -> torch.Tensor:
    """Token ids -> table lookup; float inputs pass through."""
    if not inputs.is_floating_point():
        return params["embed"][inputs.long()]
    return inputs.to(cfg.dtype)


def unembed(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


@torch.no_grad()
def forward(cfg: ArchConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), aux)."""
    _check_family(cfg)
    b, s = inputs.shape[0], inputs.shape[1]
    h = embed_inputs(cfg, params, inputs)
    if positions is None:
        positions = positions_for(cfg, b, s, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for l, lp in enumerate(params["layers"]):
        h, a = _layer_fwd(cfg, params, lp, l, h, positions)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, h), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token loss of one batch ({inputs, labels[, positions, mask]}):
    ce + AUX_LOSS_WEIGHT · aux. exp(ce) is the perplexity the paper
    reports."""
    inputs = torch.as_tensor(batch["inputs"], device=params["embed"].device)
    labels = torch.as_tensor(batch["labels"], device=inputs.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=inputs.device)
    logits, aux = forward(cfg, params, inputs, batch.get("positions"))
    ce = softmax_xent(logits, labels, mask)
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> List[attn_lib.KVCache]:
    """One empty KVCache per layer."""
    _check_family(cfg)
    return [attn_lib.init_kv_cache(cfg, batch, s_max, device)
            for _ in range(cfg.n_layers)]


def _layer_decode(cfg: ArchConfig, lp: dict, h: torch.Tensor,
                  kv_l: attn_lib.KVCache, positions: torch.Tensor):
    with tap_scope("attn"):
        a, kc = attn_lib.decode_attention(
            cfg, lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps),
            kv_l, positions)
    h, _ = _ffn(cfg, lp, h + a)
    return h, kc


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict,
                cache: List[attn_lib.KVCache], token: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, List[attn_lib.KVCache]]:
    """One decode step. token (B, 1) ints; positions (B, 1). Returns
    (logits (B, 1, V), new cache). The cache tensors update in place."""
    h = embed_inputs(cfg, params, token)
    new_cache = []
    for lp, kv_l in zip(params["layers"], cache):
        h, kc = _layer_decode(cfg, lp, h, kv_l, positions)
        new_cache.append(kc)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, h), new_cache


def _layer_decode_paged(cfg: ArchConfig, lp: dict, h: torch.Tensor,
                        pool_l, block_tables: torch.Tensor,
                        lengths: torch.Tensor, positions: torch.Tensor,
                        active):
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
    loops over them in Python."""
    _check_family(cfg)
    r = token.shape[0]
    positions = positions_for(cfg, r, 1, offset=lengths[:, None],
                              device=lengths.device)
    h = embed_inputs(cfg, params, token)
    for lp, pool_l in zip(params["layers"], paged):
        h, _ = _layer_decode_paged(cfg, lp, h, pool_l, block_tables,
                                   lengths, positions, active)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, h), paged


def prefill(cfg: ArchConfig, params: dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill = the full forward's logits (the cache fill is modelled as
    the forward pass)."""
    logits, _ = forward(cfg, params, inputs, positions)
    return logits
