"""Carry the reference's arrays into the port through numpy.

JAX PRNG init and Pallas tiling cannot be reproduced in torch, so parity
runs on bridged inputs: weights from the reference's ``lm.init``,
decompositions from its ``compress_model`` and packed planes from its
``pack_linear`` / ``pack_expert_stack``. Everything arrives as numpy
arrays (``np.asarray`` of a JAX array) or duck-typed objects holding
them; nothing of JAX or of the reference package is imported here.

Two conversions need care:
- bf16 arrives as ``ml_dtypes.bfloat16``; it moves as 16-bit words and is
  viewed as ``torch.bfloat16`` on arrival.
- unsigned planes (uint16 ELL ids, uint32 sign words) move as the
  bit-identical int16 / int32 views the port's kernels read as unsigned.

Like every entry point of the port, each converter puts its tensors on
the card unless the caller passes ``device="cpu"``, and raises without
a card (``repro_torch.resolve_device``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.packed_model import ExpertPackedStack, PackedLinear
from repro_torch.core.pipeline import ModelTapStats
from repro_torch.core.slab import SLaBDecomposition
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.serving.paged_cache import PagedKVCache

_SIGNED_VIEW = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def tensor(a, device=None) -> torch.Tensor:
    """One numpy (or array-like) value -> torch, bit-exact, on
    ``resolve_device(device)``: the card unless ``device="cpu"``."""
    device = resolve_device(device)
    a = np.array(a, copy=True)        # owned and writable for from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype in _SIGNED_VIEW:
        return torch.from_numpy(a.view(_SIGNED_VIEW[a.dtype])).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed_stack(x) -> bool:
    return hasattr(x, "owner_group") and hasattr(x, "dense_members")


def _is_packed_linear(x) -> bool:
    return hasattr(x, "variant") and hasattr(x, "sparse_vals")


def _tree(x, device):
    """A dict of arrays (the hybrid's ``shared_attn`` may hold per-linear
    reference ``PackedLinear``s) -> the same dict of tensors."""
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if _is_packed_linear(x):
        return packed_linear(x, device)
    return tensor(x, device)


def _is_expert_stack(x) -> bool:
    return hasattr(x, "n_experts") and hasattr(x, "groups")


def _layer_leaf(leaf, l: int, device):
    """Layer ``l`` of one reference ``layers`` leaf, in the port's form:
    a ``PackedStack`` gives the leaf of the group that owns the layer
    (``owner_group``) or of its dense remainder."""
    if _is_packed_stack(leaf):
        gi = leaf.owner_group(l)
        if gi < 0:
            return tensor(leaf.dense[leaf.dense_members.index(l)],
                          device).contiguous()
        return _layer_leaf(leaf.groups[gi], leaf.members[gi].index(l),
                           device)
    if _is_expert_stack(leaf):
        return expert_packed_stack(leaf, device, index=l)
    if _is_packed_linear(leaf):
        return packed_linear(leaf, device, index=l)
    return tensor(np.asarray(leaf)[l], device).contiguous()


def params(ref_params: dict, n_layers: int, device=None) -> dict:
    """Reference params (stacked ``layers`` leaves with a leading L dim)
    -> the port's layout: one dict per layer. A ``layers`` leaf may be
    packed, as ``pack_plan_decs`` leaves it: a layer-stacked
    ``PackedLinear`` or ``ExpertPackedStack``, or a ``PackedStack`` (a
    mixed or partial plan), which each layer unstacks into its own
    ``PackedLinear``, ``ExpertPackedStack`` or dense weight. The hybrid's
    ``shared_attn`` (outside the layers) comes over as it is, packed or
    dense."""
    out = {k: _tree(v, device) for k, v in ref_params.items()
           if k != "layers"}

    def at(t, l):
        if isinstance(t, dict):
            return {k: at(v, l) for k, v in t.items()}
        return _layer_leaf(t, l, device)

    out["layers"] = [at(ref_params["layers"], l) for l in range(n_layers)]
    return out


def decomposition(dec, device=None) -> SLaBDecomposition:
    """A reference ``SLaBDecomposition`` (any object with w_s, u, v, w_b),
    of any variant: sparse-only and low-rank decompositions carry
    zero-width u / v and a (0, 0) w_b, which arrive with those shapes; a
    dec with no sparse plane keeps w_s None."""
    w_s = None if dec.w_s is None else tensor(dec.w_s, device)
    return SLaBDecomposition(w_s, tensor(dec.u, device),
                             tensor(dec.v, device), tensor(dec.w_b, device))


def expert_decompositions(decs, device=None) -> tuple:
    """A 3-D expert leaf's tuple of per-expert decs."""
    return tuple(decomposition(d, device) for d in decs)


def hessian(h, device=None) -> torch.Tensor:
    """A tapped (D_in, D_in) X^T X Gram matrix (fp32)."""
    t = tensor(h, device)
    if t.dim() != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"a Hessian is square, not {tuple(t.shape)}")
    return t


def tap_stats(ref_stats, device=None) -> ModelTapStats:
    """A reference ``ModelTapStats`` (norms and Hessians keyed (layer,
    path), ``n_forwards``) -> the port's, so that both allocators and
    both ``compress_model(stats=...)`` read the same statistics."""
    return ModelTapStats(
        {k: tensor(v, device) for k, v in ref_stats.norms.items()},
        {k: tensor(v, device) for k, v in ref_stats.hessians.items()},
        int(ref_stats.n_forwards))


def packed_linear(pl, device=None, index=None) -> PackedLinear:
    """A reference per-layer ``PackedLinear`` -> the port's; with
    ``index``, position ``index`` of a layer-stacked one."""
    def opt(a):
        if a is None:
            return None
        a = np.asarray(a)
        return tensor(a if index is None else a[index], device).contiguous()

    return PackedLinear(opt(pl.sparse_vals), opt(pl.sparse_idx),
                        opt(pl.b_packed), opt(pl.u), opt(pl.v),
                        variant=pl.variant, m_pat=int(pl.m_pat),
                        d_in=int(pl.d_in), d_out=int(pl.d_out),
                        rank=int(pl.rank))


def expert_packed_stack(ref_eps, device=None,
                        index=None) -> ExpertPackedStack:
    """A reference per-layer ``ExpertPackedStack`` -> the port's: its
    groups (planes with a leading expert dim, of any variant: a plane
    the variant lacks stays None, ids and sign words arrive as their
    int16 / int32 views), the dense remainder and the member ids; with
    ``index``, position ``index`` of a layer-stacked one."""
    dense = None
    if ref_eps.dense is not None:
        d = np.asarray(ref_eps.dense)
        dense = tensor(d if index is None else d[index], device).contiguous()
    return ExpertPackedStack(
        tuple(packed_linear(g, device, index) for g in ref_eps.groups), dense,
        tuple(tuple(int(e) for e in m) for m in ref_eps.members),
        tuple(int(e) for e in ref_eps.dense_members),
        int(ref_eps.n_experts))


def kv_cache(ref_kv, device=None) -> List[KVCache]:
    """A reference layer-stacked ``KVCache`` (k/v (L, B, S, Kv, dh),
    length (L,), int8 k/v with k_scale/v_scale (L, B, S, Kv) when
    quantized) -> one port KVCache per layer."""
    k, v = tensor(ref_kv.k, device), tensor(ref_kv.v, device)
    length = np.asarray(ref_kv.length).reshape(-1)
    ks = vs = None
    if ref_kv.k_scale is not None:
        ks, vs = tensor(ref_kv.k_scale, device), tensor(ref_kv.v_scale,
                                                          device)
    return [KVCache(k[l].contiguous(), v[l].contiguous(), int(length[l]),
                    None if ks is None else ks[l].contiguous(),
                    None if vs is None else vs[l].contiguous())
            for l in range(k.shape[0])]


def paged_kv_cache(ref_paged, device=None) -> List[PagedKVCache]:
    """A reference ``PagedKVCache`` (pools stacked (L, n_blocks, bs, KV,
    dh), int8 with (L, n_blocks, bs, KV) f32 scales when quantized) ->
    the port's list of per-layer pools."""
    k, v = tensor(ref_paged.k, device), tensor(ref_paged.v, device)
    ks = vs = None
    if ref_paged.k_scale is not None:
        ks = tensor(ref_paged.k_scale, device)
        vs = tensor(ref_paged.v_scale, device)
    return [PagedKVCache(k[l].contiguous(), v[l].contiguous(),
                         None if ks is None else ks[l].contiguous(),
                         None if vs is None else vs[l].contiguous())
            for l in range(k.shape[0])]


def mamba_cache(ref_mc, device=None) -> List[MambaCache]:
    """A reference layer-stacked ``MambaCache`` (conv windows (L, B, K-1,
    C) in the model dtype, state h (L, B, H, P, N) f32) -> one port
    MambaCache per layer: the ``mamba`` part of ``lm.SSMCache``."""
    parts = [tensor(a, device) for a in (ref_mc.conv_x, ref_mc.conv_b,
                                         ref_mc.conv_c, ref_mc.h)]
    return [MambaCache(*(p[l].contiguous() for p in parts))
            for l in range(parts[0].shape[0])]
