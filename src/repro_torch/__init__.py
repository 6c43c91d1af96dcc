"""PyTorch + CUDA port of the SLaB reproduction: compression (per-linear
plans, streamed tap statistics, the budget allocator), packed serving
through hand-written CUDA kernels and the serving engine, for the dense
(llama2-7b, stablelm-12b, mistral-nemo-12b, llama3.2-3b,
nemotron-4-340b), MoE (phi3.5-moe, deepseek-moe-16b), SSM (mamba2-1.3b),
hybrid (zamba2-7b), vlm (qwen2-vl-2b) and audio (hubert-xlarge)
families.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.models.lm`` <-> ``repro.models.lm`` ...) and
imports nothing of it. Entry points run on the CUDA card unless the
caller asks for the CPU explicitly (``device="cpu"``); with no card and
no explicit CPU request they raise instead of carrying on quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    passes ``"cpu"``. Raises when CUDA is requested (or defaulted) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
