"""Phi-3.5-MoE (42B total / 6.6B active): 32L d_model=4096 32H (GQA
kv=8) d_ff=6400 per expert, 16 experts top-2, vocab=32064, no shared
experts. The port's mixture-of-experts configuration."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=6400, vocab=32064, act="swiglu", rope="rope",
    n_experts=16, top_k=2,
)

SMOKE = FULL.with_(
    name="phi3.5-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
    d_ff=128, vocab=256, n_experts=4, top_k=2, moe_group=64, q_chunk=64,
)
