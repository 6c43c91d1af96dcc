"""Public wrappers of the SLaB kernels (port of ``repro.kernels.ops``).

The contract of the reference wrappers: leading dims of x are
flattened; ``u`` arrives as (N,) or (N, R) and ``v`` as (K,) or (K, R)
and both are canonicalised to the kernels' row-major rank stacks
(R, N) / (R, K); accumulation is fp32 and the result has x's dtype.

The grouped-expert wrappers (``*_g``) take x (E, M, K) and planes
stacked on a leading expert dim, with u (E, N, R) / v (E, K, R)
canonicalised to (E, R, N) / (E, R, K); one kernel launch serves all E.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises on anything it
does not take. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import binlr as binlr_k
from repro_torch.kernels import ell as ell_k
from repro_torch.kernels import flash_decode as fd_k
from repro_torch.kernels import grouped as g_k
from repro_torch.kernels import nm_sparse as nm_k
from repro_torch.kernels import slab_matmul as slab_k

KERNELS = (ell_k.SLAB_ELL, ell_k.SLAB_ELL_FIRST, slab_k.SLAB_NM,
           slab_k.SLAB_NM_FIRST, slab_k.SLAB_DENSE, slab_k.SLAB_DENSE_FIRST,
           ell_k.ELL, ell_k.ELL_FIRST, ell_k.ELL_LR, ell_k.ELL_LR_FIRST,
           slab_k.SLAB_LR, slab_k.SLAB_LR_FIRST, slab_k.SLAB_NM_LR,
           slab_k.SLAB_NM_LR_FIRST, nm_k.NM, nm_k.NM_FIRST, binlr_k.BINLR,
           binlr_k.BINLR_FIRST, fd_k.FLASH_DECODE, fd_k.FLASH_DECODE_PAGED,
           g_k.SLAB_ELL_G, g_k.SLAB_ELL_G_FIRST, g_k.NM_G, g_k.NM_G_FIRST,
           g_k.SLAB_G, g_k.SLAB_G_FIRST, g_k.SLAB_NM_G, g_k.SLAB_NM_G_FIRST,
           g_k.ELL_G, g_k.ELL_G_FIRST, g_k.ELL_LR_G, g_k.ELL_LR_G_FIRST,
           g_k.SLAB_LR_G, g_k.SLAB_LR_G_FIRST, g_k.SLAB_NM_LR_G,
           g_k.SLAB_NM_LR_G_FIRST, g_k.BINLR_G, g_k.BINLR_G_FIRST)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """Launches per counter key: one counter per library, so a wrapper
    that picks between two (``grouped.ell_matmul_g``,
    ``ell_lr_matmul_g``, ``slab_ell_matmul_g``, ``slab_nm_lr_matmul_g``,
    ``slab_lr_matmul_g``, ``slab_matmul_g``, ``slab_nm_matmul_g``,
    ``binlr_matmul_g``, ``nm_matmul_g``, ``binlr.binlr_matmul``,
    ``slab_matmul.slab_matmul``,
    ``slab_matmul.slab_lr_matmul``, ``slab_matmul.slab_nm_matmul``,
    ``slab_matmul.slab_nm_lr_matmul``, ``nm_sparse.nm_matmul``,
    ``ell.ell_matmul``, ``ell.slab_ell_matmul``, ``ell.ell_lr_matmul``)
    shows which one ran."""
    return {k.key: k.launches for k in KERNELS}


def _rank_stack(u: torch.Tensor, v: torch.Tensor, dtype):
    """(N,)/(N,R) u and (K,)/(K,R) v -> contiguous (R,N), (R,K)."""
    u2 = u[None, :] if u.dim() == 1 else u.T
    v2 = v[None, :] if v.dim() == 1 else v.T
    return u2.to(dtype).contiguous(), v2.to(dtype).contiguous()


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def slab_ell_matmul(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Full SLaB linear with ELL sparse part + binary ⊙ rank-r term."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = ell_k.slab_ell_matmul_plain if _on_cpu(x) else ell_k.slab_ell_matmul
    y = fn(x2, vals, idx, b_packed, u2, v2)
    return y.reshape(*x.shape[:-1], -1)


def slab_nm_matmul(x, vals, idx, m_pat: int, b_packed, u, v) -> torch.Tensor:
    """Fused SLaB linear with N:M packed sparse part."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = (slab_k.slab_nm_matmul_plain if _on_cpu(x)
          else slab_k.slab_nm_matmul)
    y = fn(x2, vals, idx, m_pat, b_packed, u2, v2)
    return y.reshape(*x.shape[:-1], -1)


def slab_matmul(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Fused SLaB linear with dense-masked sparse part."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    w_s = w_s.to(x.dtype)
    fn = slab_k.slab_matmul_plain if _on_cpu(x) else slab_k.slab_matmul
    y = fn(x2, w_s, b_packed, u2, v2)
    return y.reshape(*x.shape[:-1], -1)


def ell_matmul(x, vals, idx) -> torch.Tensor:
    """Row-padded ELL unstructured-sparse linear (no other term)."""
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = ell_k.ell_matmul_plain if _on_cpu(x) else ell_k.ell_matmul
    return fn(x2, vals, idx).reshape(*x.shape[:-1], -1)


def ell_lr_matmul(x, vals, idx, u, v) -> torch.Tensor:
    """ELL sparse + rank-r low-rank, no binary term."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = ell_k.ell_lr_matmul_plain if _on_cpu(x) else ell_k.ell_lr_matmul
    return fn(x2, vals, idx, u2, v2).reshape(*x.shape[:-1], -1)


def slab_lr_matmul(x, w_s, u, v) -> torch.Tensor:
    """Dense-masked sparse + rank-r low-rank, no binary term."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    w_s = w_s.to(x.dtype)
    fn = (slab_k.slab_lr_matmul_plain if _on_cpu(x)
          else slab_k.slab_lr_matmul)
    return fn(x2, w_s, u2, v2).reshape(*x.shape[:-1], -1)


def nm_matmul(x, vals, idx, m_pat: int) -> torch.Tensor:
    """N:M semi-structured sparse linear (no other term)."""
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = nm_k.nm_matmul_plain if _on_cpu(x) else nm_k.nm_matmul
    return fn(x2, vals, idx, m_pat).reshape(*x.shape[:-1], -1)


def binlr(x, b_packed, u, v) -> torch.Tensor:
    """Binary ⊙ rank-r linear, no sparse part."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    fn = binlr_k.binlr_matmul_plain if _on_cpu(x) else binlr_k.binlr_matmul
    return fn(x2, b_packed, u2, v2).reshape(*x.shape[:-1], -1)


def slab_nm_lr_matmul(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """N:M sparse + rank-r low-rank, no binary term."""
    u2, v2 = _rank_stack(u, v, x.dtype)
    x2 = _flat(x)
    vals = vals.to(x.dtype)
    fn = (slab_k.slab_nm_lr_matmul_plain if _on_cpu(x)
          else slab_k.slab_nm_lr_matmul)
    return fn(x2, vals, idx, m_pat, u2, v2).reshape(*x.shape[:-1], -1)


def _rank_stack_g(u: torch.Tensor, v: torch.Tensor, dtype):
    """Expert-stacked (E, N, R) u / (E, K, R) v -> contiguous (E, R, N),
    (E, R, K)."""
    return (u.transpose(1, 2).to(dtype).contiguous(),
            v.transpose(1, 2).to(dtype).contiguous())


def ell_matmul_g(x, vals, idx) -> torch.Tensor:
    """Grouped-expert ell_matmul: x (E, M, K), vals / idx (E, N, K_max)
    -> (E, M, N)."""
    x = x.contiguous()
    fn = g_k.ell_matmul_g_plain if _on_cpu(x) else g_k.ell_matmul_g
    return fn(x, vals.to(x.dtype), idx)


def ell_lr_matmul_g(x, vals, idx, u, v) -> torch.Tensor:
    """Grouped-expert ell_lr_matmul: u (E, N, R), v (E, K, R)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = g_k.ell_lr_matmul_g_plain if _on_cpu(x) else g_k.ell_lr_matmul_g
    return fn(x, vals.to(x.dtype), idx, u2, v2)


def slab_ell_matmul_g(x, vals, idx, b_packed, u, v) -> torch.Tensor:
    """Grouped-expert slab_ell_matmul: x (E, M, K), vals / idx (E, N,
    K_max), b_packed (E, N, K/32) -> (E, M, N)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = (g_k.slab_ell_matmul_g_plain if _on_cpu(x)
          else g_k.slab_ell_matmul_g)
    return fn(x, vals.to(x.dtype), idx, b_packed, u2, v2)


def nm_matmul_g(x, vals, idx, m_pat: int) -> torch.Tensor:
    """Grouped-expert nm_matmul: vals / idx (E, N, K/m, n)."""
    x = x.contiguous()
    fn = g_k.nm_matmul_g_plain if _on_cpu(x) else g_k.nm_matmul_g
    return fn(x, vals.to(x.dtype), idx, m_pat)


def slab_matmul_g(x, w_s, b_packed, u, v) -> torch.Tensor:
    """Grouped-expert slab_matmul: w_s (E, N, K)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = g_k.slab_matmul_g_plain if _on_cpu(x) else g_k.slab_matmul_g
    return fn(x, w_s.to(x.dtype), b_packed, u2, v2)


def slab_nm_matmul_g(x, vals, idx, m_pat: int, b_packed, u,
                     v) -> torch.Tensor:
    """Grouped-expert slab_nm_matmul: vals / idx (E, N, K/m, n)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = (g_k.slab_nm_matmul_g_plain if _on_cpu(x)
          else g_k.slab_nm_matmul_g)
    return fn(x, vals.to(x.dtype), idx, m_pat, b_packed, u2, v2)


def slab_lr_matmul_g(x, w_s, u, v) -> torch.Tensor:
    """Grouped-expert slab_lr_matmul: w_s (E, N, K)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = g_k.slab_lr_matmul_g_plain if _on_cpu(x) else g_k.slab_lr_matmul_g
    return fn(x, w_s.to(x.dtype), u2, v2)


def slab_nm_lr_matmul_g(x, vals, idx, m_pat: int, u, v) -> torch.Tensor:
    """Grouped-expert slab_nm_lr_matmul: vals / idx (E, N, K/m, n)."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = (g_k.slab_nm_lr_matmul_g_plain if _on_cpu(x)
          else g_k.slab_nm_lr_matmul_g)
    return fn(x, vals.to(x.dtype), idx, m_pat, u2, v2)


def binlr_g(x, b_packed, u, v) -> torch.Tensor:
    """Grouped-expert binlr: b_packed (E, N, K/32) sign words."""
    u2, v2 = _rank_stack_g(u, v, x.dtype)
    x = x.contiguous()
    fn = g_k.binlr_matmul_g_plain if _on_cpu(x) else g_k.binlr_matmul_g
    return fn(x, b_packed, u2, v2)


def flash_decode_attention(q, k, v, lengths, k_scale=None, v_scale=None,
                           bs: int = 512) -> torch.Tensor:
    """Grouped-query decode attention (optionally int8 KV) on a
    contiguous cache. q (B, KV, G, dh) pre-scaled by 1/sqrt(dh); k / v
    (B, S, KV, dh); lengths (B,) int32."""
    fn = fd_k.flash_decode_plain if _on_cpu(q) else fd_k.flash_decode
    return fn(q, k, v, lengths, k_scale, v_scale, bs=bs)


def flash_decode_paged_attention(q, k_pool, v_pool, block_tables, lengths,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Paged (block-table) grouped-query decode attention. q (R, KV, G,
    dh) pre-scaled; k_pool / v_pool (n_blocks, bs, KV, dh); block_tables
    (R, n_bt) int32; lengths (R,) int32 — zero-length rows return 0."""
    fn = (fd_k.flash_decode_paged_plain if _on_cpu(q)
          else fd_k.flash_decode_paged)
    return fn(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)


def slab_linear_kernel(x, packed) -> torch.Tensor:
    """One SLaB-compressed linear from its ``core.packing.SLaBPacked``
    bundle: an N:M sparse part through #2 ``slab_nm_matmul``, a dense or
    ELL one (unpacked first) through #3 ``slab_matmul``."""
    from repro_torch.core.packing import ELLPacked, NMPacked, ell_unpack
    sp = packed.sparse
    if isinstance(sp, NMPacked):
        return slab_nm_matmul(x, sp.values, sp.indices, sp.m,
                              packed.b_packed, packed.u, packed.v)
    w_s = ell_unpack(sp) if isinstance(sp, ELLPacked) else sp
    return slab_matmul(x, w_s.to(x.dtype), packed.b_packed, packed.u,
                       packed.v)
