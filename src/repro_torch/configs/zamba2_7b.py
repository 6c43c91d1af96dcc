"""Zamba2-7B [arXiv:2411.15242]: an 81L Mamba2 backbone (d_model=3584,
ssm_state=64, headdim 64 -> 112 SSD heads) plus ONE shared transformer
block (32H MHA kv=32, d_ff=14336) invoked every 6 layers (weight
sharing), vocab=32000. The port's hybrid-family configuration."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_head=112,
    d_ff=14336, vocab=32000, act="swiglu", rope="rope",
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_chunk=256, attn_every=6,
)

SMOKE = FULL.with_(
    name="zamba2-smoke",
    n_layers=7, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16,
    ssm_chunk=32, attn_every=3, q_chunk=64,
)
