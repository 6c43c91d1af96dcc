"""Llama-3.2-3B. [hf:meta-llama/Llama-3.2-1B family; unverified]
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_head=128,
    d_ff=8192, vocab=128256, act="swiglu", rope="rope",
    rope_theta=500_000.0,
)

SMOKE = FULL.with_(
    name="llama3.2-3b-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv=2, d_head=16,
    d_ff=192, vocab=512, q_chunk=64,
)
