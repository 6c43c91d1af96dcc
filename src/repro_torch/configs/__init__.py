"""Config registry of the port (mirror of ``repro.configs``): every
architecture of the reference, each with FULL and SMOKE variants."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """A cell's batch and sequence shape (``runtime.specs``)."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


ARCH_IDS: List[str] = ["llama2_7b", "stablelm_12b", "mistral_nemo_12b",
                       "llama3_2_3b", "nemotron_4_340b", "hubert_xlarge",
                       "phi3_5_moe", "deepseek_moe_16b", "qwen2_vl_2b",
                       "mamba2_1_3b", "zamba2_7b"]


def normalize(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    name = normalize(arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.FULL
