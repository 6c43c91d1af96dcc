"""Mamba-2 block via SSD (state-space duality, arXiv:2405.21060), port of
``repro.models.mamba2``.

Chunked algorithm: the sequence is split into chunks of ``cfg.ssm_chunk``;
within a chunk the SSD quadratic (attention-like) form runs as einsums,
and a Python loop over the chunks carries the (B, H, P, N) recurrent
state (the reference scans them with ``lax.scan``). Live memory is
O(chunk^2) plus the carried state, never O(S^2). The state and the scan
run in f32; everything here is plain PyTorch and differentiable, so
training takes gradients through the scan with autograd.

Projections are separate (z / x / B / C / dt), as in the reference:
``in_z``, ``in_x``, ``in_b``, ``in_c`` and ``out`` go through
``core.packed_model.linear`` (tapped, compressible, packable), while
``in_dt`` is an f32 plain product that is never tapped or compressed.

Decode is the O(1)-per-token recurrent form with a rolling (K-1)-row
depthwise-conv window; the cache does not depend on the sequence length.

Under a mesh whose "model" ranks split the heads (``head_split``: the
planner's "ssm_heads" rule, H divisible), a rank runs its heads: its
columns of ``in_z`` / ``in_x`` / ``in_dt`` (``packed_model.linear_cols``,
no gather), its channels of the conv and its heads' dt, recurrence or
chunk scan and ``d_skip``, and holds its heads' state ``h`` and
``conv_x`` channels in the cache. ``in_b`` / ``in_c``, their convs and
the B / C vectors stay whole on every rank. y is gathered over "model"
before the gated RMSNorm; ``out`` then runs as any linear does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packed_model import linear, linear_cols
from repro_torch.models.common import ArchConfig, dense_init, rms_norm
from repro_torch.runtime.meshctx import (current_mesh, gather_model,
                                         model_dim, model_shards, whole)


def mamba_axes() -> dict:
    """Logical axes of one Mamba-2 block's params (runtime.sharding)."""
    return {
        "in_z": ("embed", "ssm"), "in_x": ("embed", "ssm"),
        "in_b": ("embed", None), "in_c": ("embed", None),
        "in_dt": ("embed", "ssm_heads"),
        "conv_x": ("ssm", None), "conv_b": (None, None),
        "conv_c": (None, None),
        "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",), "gate_norm": ("ssm",),
        "out": ("ssm", "embed"),
    }


def init_mamba(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense_init(gen, (d, di), d, cfg.dtype, device),
        "in_x": dense_init(gen, (d, di), d, cfg.dtype, device),
        "in_b": dense_init(gen, (d, n), d, cfg.dtype, device),
        "in_c": dense_init(gen, (d, n), d, cfg.dtype, device),
        "in_dt": dense_init(gen, (d, h), d, torch.float32, device),
        "conv_x": dense_init(gen, (di, k), k, cfg.dtype, device),
        "conv_b": dense_init(gen, (n, k), k, cfg.dtype, device),
        "conv_c": dense_init(gen, (n, k), k, cfg.dtype, device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones(h, **f32),
        "dt_bias": torch.full((h,), -4.6, **f32),  # softplus^-1(0.01)
        "gate_norm": torch.ones(di, **f32),
        "out": dense_init(gen, (di, d), di, cfg.dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (C, K); accumulates in
    x.dtype, tap by tap, as the reference does."""
    s = x.shape[1]
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wx = w.to(x.dtype)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * wx[None, None, :, i]
    return out


def _ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (B, S, H, P), dt (B, S, H) > 0, a (H,) < 0,
    bmat / cmat (B, S, N). Returns (y (B, S, H, P) f32, final state
    (B, H, P, N) f32). A length that the chunk does not divide runs as
    one chunk."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = max(s // chunk, 1)
    if s % chunk:
        chunk, nc = s, 1
    xf, bf, cf = x.float(), bmat.float(), cmat.float()
    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        x_c, dt_c, b_c, c_c = xf[:, sl], dt[:, sl], bf[:, sl], cf[:, sl]
        da = dt_c * a[None, None, :]                      # (B, L, H) <= 0
        da_cum = torch.cumsum(da, dim=1)
        dtx = x_c * dt_c[..., None]                       # (B, L, H, P)

        # intra-chunk (quadratic / attention-like form)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)       # (B, L, L)
        diff = da_cum[:, :, None, :] - da_cum[:, None, :, :]
        lmat = torch.where(causal, torch.exp(torch.clamp(diff, max=0.0)),
                           torch.zeros((), dtype=diff.dtype,
                                       device=diff.device))
        y_diag = torch.einsum("bij,bijh,bjhp->bihp", cb, lmat, dtx)

        # inter-chunk contribution from the carried state
        y_off = torch.einsum("bin,bhpn->bihp", c_c, hstate) * \
            torch.exp(da_cum)[..., None]

        # state update
        total = da_cum[:, -1, :]                          # (B, H)
        decay_to_end = torch.exp(total[:, None, :] - da_cum)
        hstate = hstate * torch.exp(total)[:, :, None, None] + \
            torch.einsum("bjhp,bjn,bjh->bhpn", dtx, b_c, decay_to_end)
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), hstate


def head_split(cfg: ArchConfig) -> Tuple[int, int]:
    """(this rank's index, ranks) over which a Mamba layer's heads split:
    the "model" ranks where they divide the heads, else (0, 1)."""
    c, n = model_shards()
    if n == 1 or cfg.ssm_heads % n:
        return 0, 1
    return c, n


def _mine(t, dim: int, n_local: int, split: Tuple[int, int]):
    """This rank's ``n_local`` entries along ``dim`` of a per-head or
    per-channel param under ``split`` (``head_split``): a ``Shard``'s
    own slice where the planner cut that dim over "model", else cut from
    the whole; the whole param where the heads do not split."""
    c, n = split
    if n == 1:
        return whole(t)
    if model_dim(t) == dim and t.local.shape[dim] == n_local:
        return t.local
    return whole(t).narrow(dim, c * n_local, n_local)


def _in_cols(x: torch.Tensor, w, n_local: int, n: int,
             tap: str) -> torch.Tensor:
    """The rank's ``n_local`` features of an input projection (all of
    them where the heads do not split)."""
    if n == 1:
        return linear(x, w, tap=tap)
    return linear_cols(x, w, n_local, tap=tap)


def _gated_out(cfg: ArchConfig, p: dict, y: torch.Tensor, z: torch.Tensor,
               n: int) -> torch.Tensor:
    """The gated RMSNorm over all d_inner channels (this rank's gathered
    over "model" first), then ``out``."""
    g = y * F.silu(z)
    if n > 1:
        g = gather_model(g)
    g = rms_norm(g, whole(p["gate_norm"]), cfg.norm_eps)
    return linear(g, p["out"], tap="out")


def mamba_block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block. x (B, S, D) -> (B, S, D). Under a mesh
    that splits the heads, on this rank's heads (module docstring)."""
    b, s, _ = x.shape
    split = head_split(cfg)
    n = split[1]
    h, pd = cfg.ssm_heads // n, cfg.ssm_headdim
    di = h * pd
    z = _in_cols(x, p["in_z"], di, n, "in_z")
    xs = F.silu(_causal_conv(_in_cols(x, p["in_x"], di, n, "in_x"),
                             _mine(p["conv_x"], 0, di, split)))
    bmat = F.silu(_causal_conv(linear(x, p["in_b"], tap="in_b"),
                               whole(p["conv_b"])))
    cmat = F.silu(_causal_conv(linear(x, p["in_c"], tap="in_c"),
                               whole(p["conv_c"])))
    dt = F.softplus(x.float() @ _mine(p["in_dt"], 1, h, split)
                    + _mine(p["dt_bias"], 0, h, split))
    a = -torch.exp(_mine(p["a_log"], 0, h, split))

    xh = xs.reshape(b, s, h, pd)
    y, _ = _ssd_chunk_scan(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
    y = y + xh.float() * _mine(p["d_skip"], 0, h, split)[None, None, :,
                                                           None]
    y = y.reshape(b, s, di).to(cfg.dtype)
    return _gated_out(cfg, p, y, z, n)


# ------------------------------------------------------------------
# Decode path (O(1) per token)
# ------------------------------------------------------------------

class MambaCache(NamedTuple):
    conv_x: torch.Tensor   # (B, K-1, d_inner) rolling window
    conv_b: torch.Tensor   # (B, K-1, N)
    conv_c: torch.Tensor   # (B, K-1, N)
    h: torch.Tensor        # (B, H, P, N) recurrent state, f32


def mamba_cache_axes() -> MambaCache:
    return MambaCache(("batch", None, "ssm"), ("batch", None, None),
                      ("batch", None, None),
                      ("batch", "ssm_heads", None, None))


def init_mamba_cache(cfg: ArchConfig, batch: int,
                     device=None) -> MambaCache:
    """The empty cache of ``batch`` rows. Under a mesh, this rank's part
    as the planner places ``mamba_cache_axes()``: the dims it cuts over
    "model" (the state's heads, ``conv_x``'s channels) at this rank's
    size (the caller has split the rows already)."""
    k = cfg.ssm_conv
    shapes = MambaCache((batch, k - 1, cfg.d_inner),
                        (batch, k - 1, cfg.ssm_state),
                        (batch, k - 1, cfg.ssm_state),
                        (batch, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state))
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.runtime.sharding import Planner
        planner = Planner(mesh, cfg)
        shapes = MambaCache(*(
            tuple(d // mesh.shape["model"] if e == "model" else d
                  for d, e in zip(shp, planner.spec(ax, shp)))
            for ax, shp in zip(mamba_cache_axes(), shapes)))
    dts = (cfg.dtype, cfg.dtype, cfg.dtype, torch.float32)
    return MambaCache(*(torch.zeros(shp, dtype=dt, device=device)
                        for shp, dt in zip(shapes, dts)))


def _conv_step(window: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """window (B, K-1, C), x_new (B, C) -> (new window, conv output
    (B, C))."""
    full = torch.cat([window, x_new[:, None, :]], dim=1)      # (B, K, C)
    out = torch.einsum("bkc,ck->bc", full, w.to(x_new.dtype))
    return full[:, 1:, :], out


def mamba_decode_step(cfg: ArchConfig, p: dict, x: torch.Tensor,
                      cache: MambaCache
                      ) -> Tuple[torch.Tensor, MambaCache]:
    """x (B, 1, D) -> (y (B, 1, D), the next cache). The cache's tensors
    are not modified. Under a mesh that splits the heads, on this rank's
    heads and its part of the cache (``init_mamba_cache``)."""
    b = x.shape[0]
    xt = x[:, 0, :]
    split = head_split(cfg)
    n = split[1]
    h, pd = cfg.ssm_heads // n, cfg.ssm_headdim
    di = h * pd
    if cache.h.shape[1] != h:
        raise ValueError(f"a Mamba cache of {cache.h.shape[1]} heads for "
                         f"{h} heads a rank")
    z = _in_cols(xt, p["in_z"], di, n, "in_z")
    wx, xconv = _conv_step(cache.conv_x, _in_cols(xt, p["in_x"], di, n,
                                                  "in_x"),
                           _mine(p["conv_x"], 0, di, split))
    wb, bconv = _conv_step(cache.conv_b, linear(xt, p["in_b"], tap="in_b"),
                           whole(p["conv_b"]))
    wc, cconv = _conv_step(cache.conv_c, linear(xt, p["in_c"], tap="in_c"),
                           whole(p["conv_c"]))
    xs = F.silu(xconv).reshape(b, h, pd).float()
    bvec = F.silu(bconv).float()                              # (B, N)
    cvec = F.silu(cconv).float()                              # (B, N)
    dt = F.softplus(xt.float() @ _mine(p["in_dt"], 1, h, split)
                    + _mine(p["dt_bias"], 0, h, split))
    a = -torch.exp(_mine(p["a_log"], 0, h, split))            # (H,)

    da = torch.exp(dt * a[None, :])                           # (B, H)
    dtx = xs * dt[..., None]                                  # (B, H, P)
    h_new = cache.h * da[:, :, None, None] + \
        dtx[..., None] * bvec[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, cvec) + \
        xs * _mine(p["d_skip"], 0, h, split)[None, :, None]
    y = y.reshape(b, di).to(cfg.dtype)
    return (_gated_out(cfg, p, y, z, n)[:, None, :],
            MambaCache(wx, wb, wc, h_new))
