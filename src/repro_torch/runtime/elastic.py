"""Restore of the train state (port of ``repro.runtime.elastic``, one
device). The checkpoint format knows no device: the commit's leaves are
read on the host and placed on the device asked for. Restoring onto a
mesh of another shape waits for the port's tensor-parallel runtime."""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def train_state_template(cfg: ArchConfig, acfg: AdamWConfig) -> dict:
    """The {"params", "opt"} structure of a commit, on the ``meta``
    device: shapes and dtypes, no weights allocated."""
    shapes = lm.abstract_params(cfg)
    return {"params": shapes, "opt": adamw_init(shapes, acfg)}


def elastic_restore(mgr: CheckpointManager, cfg: ArchConfig,
                    acfg: AdamWConfig, step: Optional[int] = None,
                    device=None) -> dict:
    """The {"params", "opt"} commit at ``step`` (default: the latest) on
    ``resolve_device(device)``."""
    return mgr.restore(train_state_template(cfg, acfg), step=step,
                       device=device)
