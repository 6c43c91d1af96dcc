"""Nemotron-4-340B. [arXiv:2402.16819; unverified]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000,
squared-ReLU MLP (non-gated)."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv=8, d_head=192,
    d_ff=73728, vocab=256000, act="relu2", rope="rope",
)

SMOKE = FULL.with_(
    name="nemotron-4-340b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv=2, d_head=16,
    d_ff=512, vocab=512, q_chunk=64,
)
