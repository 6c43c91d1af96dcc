"""Shared model building blocks (port of ``repro.models.common``):
ArchConfig, norms, activations, rotary embeddings, position ids, the
next-token cross-entropy and the activation-tap registry that feeds
calibration statistics to the compression pipeline.

Taps: ``core.packed_model.linear(x, w, tap="wq")`` reports its input
here when a capture is active; modules push ``tap_scope`` prefixes
("attn", "mlp", "moe") so full tap names equal ``core.pipeline.linear_paths``.
PyTorch runs eagerly, so every tap sees concrete values (the reference
must refuse traced ones).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

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
    """Streaming per-linear fp32 activation statistics for one capture:
    ``norms(name)`` is ``diag(sqrt(X^T X))`` over every recorded input
    and, with ``hessian=True``, ``hessian(name)`` is the Gram matrix
    X^T X (restricted to ``hessian_names`` when given)."""

    def __init__(self, hessian: bool = False,
                 hessian_names: Optional[set] = None):
        self.want_hessian = hessian
        self._hess_names = (None if hessian_names is None
                            else set(hessian_names))
        self._sumsq: Dict[str, torch.Tensor] = {}
        self._count: Dict[str, Any] = {}
        self._hess: Dict[str, torch.Tensor] = {}
        # taps fed by the same tensor in one forward (wq/wk/wv share their
        # input, so do w_gate/w_up) pay one Gram; a few FIFO slots suffice
        # because such taps fire back to back
        self._gram_cache: Dict[Tuple[int, str],
                               Tuple[torch.Tensor, torch.Tensor]] = {}
        self._gram_cache_slots = 4

    def _want_hess(self, name: str) -> bool:
        return self.want_hessian and (self._hess_names is None
                                      or name in self._hess_names)

    def _gram(self, x: torch.Tensor, kind: str, compute) -> torch.Tensor:
        key = (id(x), kind)
        hit = self._gram_cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        g = compute()
        while len(self._gram_cache) >= self._gram_cache_slots:
            self._gram_cache.pop(next(iter(self._gram_cache)))
        self._gram_cache[key] = (x, g)
        return g

    def _add(self, store: dict, name: str, val) -> None:
        prev = store.get(name)
        store[name] = val if prev is None else prev + val

    def record(self, name: str, x: torch.Tensor) -> None:
        """x (..., D_in): all leading dims are token dims."""
        f = x.reshape(-1, x.shape[-1]).float()
        self._add(self._sumsq, name, (f * f).sum(0))
        self._add(self._count, name, f.shape[0])
        if self._want_hess(name):
            self._add(self._hess, name,
                      self._gram(x, "flat", lambda: f.T @ f))

    def record_stacked(self, name: str, x: torch.Tensor,
                       stack_axis: int) -> None:
        """x with one stacked dim (experts) at ``stack_axis``; the other
        leading dims are token dims, the last is D_in. Norms are (E, D),
        counts (E,) nonzero rows (an unused capacity slot is a zero row
        and does not count), Hessians (E, D, D)."""
        xe = torch.movedim(x, stack_axis, 0)
        e = xe.shape[0]
        f = xe.reshape(e, -1, xe.shape[-1]).float()
        self._add(self._sumsq, name, (f * f).sum(1))
        self._add(self._count, name, (f != 0).any(-1).sum(1))
        if self._want_hess(name):
            self._add(self._hess, name, self._gram(
                x, f"stk{stack_axis}",
                lambda: torch.einsum("eti,etj->eij", f, f)))

    def has(self, name: str) -> bool:
        return name in self._sumsq

    def norms(self, name: str) -> torch.Tensor:
        return torch.sqrt(self._sumsq[name])

    def hessian(self, name: str) -> Optional[torch.Tensor]:
        return self._hess.get(name)

    def token_count(self, name: str):
        """Recorded token rows: an int for flat taps, an (E,) tensor of
        per-expert dispatched counts for stacked taps."""
        return self._count.get(name, 0)


@contextlib.contextmanager
def tap_capture(hessian: bool = False,
                hessian_names: Optional[set] = None):
    """Activate activation recording for the enclosed forward."""
    cap = TapCapture(hessian=hessian, hessian_names=hessian_names)
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


def _full_tap_name(leaf: str) -> str:
    pre = _tap_prefix()
    return ".".join(pre + [leaf]) if pre else leaf


def tap_record(leaf: str, x: torch.Tensor) -> None:
    """Report a linear's input under the current scope. No-op unless a
    capture is active."""
    caps = _tap_captures()
    if not caps:
        return
    name = _full_tap_name(leaf)
    for cap in caps:
        cap.record(name, x)


def tap_record_stacked(leaf: str, x: torch.Tensor, stack_axis: int) -> None:
    """Per-expert variant of ``tap_record``: ``stack_axis`` indexes the
    expert dim."""
    caps = _tap_captures()
    if not caps:
        return
    name = _full_tap_name(leaf)
    for cap in caps:
        cap.record_stacked(name, x, stack_axis)


# ------------------------------------------------------------------
# Config
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (mirror of the reference's ArchConfig; the port
    serves all six of its families: dense, moe, ssm, hybrid, vlm and
    audio)."""

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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # x-branch + B + C streams go through the depthwise conv
        return self.d_inner + 2 * self.ssm_state

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


def _rotate_half(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh) rotated by the angles ang (B, S, dh/2), split-half
    convention, in fp32; returns x.dtype."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, dh); positions (B, S) int. Split-half convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate_half(x, positions.float()[..., None] * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions (B, S, 3) = (t, h, w) ids; the
    dh/2 rotary frequencies are split across the three streams, the first
    ``sections[0]`` driven by t, the next ``sections[1]`` by h, the rest
    by w (sections sum to dh/2). For text, where t = h = w, it equals 1-D
    RoPE."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    stream = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))            # (dh/2,)
    ang = positions.float()[..., stream] * freqs             # (B, S, dh/2)
    return _rotate_half(x, ang)


def positions_for(cfg: ArchConfig, batch: int, seq: int, offset=0,
                  device=None) -> torch.Tensor:
    """Default position ids (B, S), starting at ``offset`` (an int, or a
    tensor that broadcasts to (B, S), such as per-row lengths[:, None]);
    (B, S, 3) with t = h = w under M-RoPE."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = (pos + offset).expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos


def rotate(cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """RoPE, M-RoPE, or x itself for ``rope="none"``."""
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


# ------------------------------------------------------------------
# Loss
# ------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32. logits (B, S, V) in any
    float dtype, labels (B, S); ``mask`` weights the tokens."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
