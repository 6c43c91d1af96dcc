"""Shared model building blocks (port of ``repro.models.common``):
ArchConfig, norms, activations, rotary embeddings, position ids and the
activation-tap registry that feeds calibration statistics to the
compression pipeline.

Taps: ``core.packed_model.linear(x, w, tap="wq")`` reports its input
here when a capture is active; modules push ``tap_scope`` prefixes
("attn", "mlp") so full tap names equal ``core.pipeline.linear_paths``.
PyTorch runs eagerly, so every tap sees concrete values (the reference
must refuse traced ones).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

# ------------------------------------------------------------------
# Activation taps
# ------------------------------------------------------------------

_tap_state = threading.local()


def _tap_captures() -> List["TapCapture"]:
    if not hasattr(_tap_state, "captures"):
        _tap_state.captures = []
    return _tap_state.captures


def _tap_prefix() -> List[str]:
    if not hasattr(_tap_state, "prefix"):
        _tap_state.prefix = []
    return _tap_state.prefix


class TapCapture:
    """Streaming per-linear fp32 column sum-of-squares for one capture:
    ``norms(name)`` is ``diag(sqrt(X^T X))`` over every recorded input."""

    def __init__(self):
        self._sumsq: Dict[str, torch.Tensor] = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        """x (..., D_in): all leading dims are token dims."""
        f = x.reshape(-1, x.shape[-1]).float()
        ss = (f * f).sum(0)
        prev = self._sumsq.get(name)
        self._sumsq[name] = ss if prev is None else prev + ss

    def has(self, name: str) -> bool:
        return name in self._sumsq

    def norms(self, name: str) -> torch.Tensor:
        return torch.sqrt(self._sumsq[name])


@contextlib.contextmanager
def tap_capture():
    """Activate activation recording for the enclosed forward."""
    cap = TapCapture()
    _tap_captures().append(cap)
    try:
        yield cap
    finally:
        _tap_captures().remove(cap)


@contextlib.contextmanager
def tap_scope(prefix: str):
    """Push a name component: taps inside record as '<prefix>.<leaf>'."""
    stack = _tap_prefix()
    stack.append(prefix)
    try:
        yield
    finally:
        stack.pop()


def tap_record(leaf: str, x: torch.Tensor) -> None:
    """Report a linear's input under the current scope. No-op unless a
    capture is active."""
    caps = _tap_captures()
    if not caps:
        return
    pre = _tap_prefix()
    name = ".".join(pre + [leaf]) if pre else leaf
    for cap in caps:
        cap.record(name, x)


# ------------------------------------------------------------------
# Config
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (mirror of the reference's ArchConfig; only the
    dense family is served by this port so far)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    rope: str = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    n_experts: int = 0
    top_k: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0
    causal: bool = True
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    q_chunk: int = 512
    kv_quant: bool = False
    dtype: Any = torch.bfloat16

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv * self.d_head

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------------
# Initializers (own generator; JAX PRNG streams are not reproducible)
# ------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...], in_dim: int,
               dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM-standard)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * in_dim ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ------------------------------------------------------------------
# Norms / activations
# ------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in fp32, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":                 # jax.nn.gelu defaults to tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind}")


# ------------------------------------------------------------------
# Rotary embeddings
# ------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, dh); positions (B, S) int. Split-half convention."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions.float()[..., None] * freqs             # (B, S, dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg: ArchConfig, batch: int, seq: int, offset=0,
                  device=None) -> torch.Tensor:
    """Default position ids (B, S), starting at ``offset``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos + offset
    return pos.expand(batch, seq)


def rotate(cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")
    return apply_rope(x, positions, cfg.rope_theta)
