"""Feed-forward blocks (port of ``repro.models.mlp``): gated SwiGLU and
plain GELU / squared-ReLU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packed_model import linear
from repro_torch.models.common import ArchConfig, activation, dense_init


def is_gated(act: str) -> bool:
    return act == "swiglu"


def mlp_axes(cfg: ArchConfig) -> dict:
    """Logical axes of the MLP's params (runtime.sharding)."""
    if is_gated(cfg.act):
        return {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
                "w_down": ("ffn", "embed")}
    return {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}


def init_mlp(cfg: ArchConfig, gen: torch.Generator, device,
             d_ff: int | None = None) -> dict:
    """``d_ff`` overrides the hidden width (the MoE shared experts)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if is_gated(cfg.act):
        return {"w_gate": dense_init(gen, (d, f), d, cfg.dtype, device),
                "w_up": dense_init(gen, (d, f), d, cfg.dtype, device),
                "w_down": dense_init(gen, (f, d), f, cfg.dtype, device)}
    return {"w_up": dense_init(gen, (d, f), d, cfg.dtype, device),
            "w_down": dense_init(gen, (f, d), f, cfg.dtype, device)}


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if is_gated(cfg.act):
        h = F.silu(linear(x, p["w_gate"], tap="w_gate")) * \
            linear(x, p["w_up"], tap="w_up")
    else:
        kind = "gelu" if cfg.act == "gelu" else "relu2"
        h = activation(linear(x, p["w_up"], tap="w_up"), kind)
    return linear(h, p["w_down"], tap="w_down")
