"""Int8 error-feedback gradient compression (port of
``repro.optim.compress``): each replica quantizes its gradient to int8
with one f32 scale per tensor, the payloads are all-reduced, and the
quantization error is carried into the next step's gradient. Rounding
is half to even, as ``jnp.round``'s."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, unflatten_like


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 payload, f32 scale), symmetric per tensor."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_pytree(grads: Any, error: Any) -> Tuple[Any, Any, Any]:
    """(grads + error) -> (int8 payloads, scales, new error buffers)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = int8_compress(corrected)
        return q, s, corrected - int8_decompress(q, s)

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    return tuple(unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def ef_decompress_pytree(q: Any, s: Any) -> Any:
    return tree_map(int8_decompress, q, s)


def init_error_buffers(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
