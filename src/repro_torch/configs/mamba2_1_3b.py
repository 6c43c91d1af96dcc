"""Mamba2-1.3B [arXiv:2405.21060]: 48L d_model=2048, attention-free SSD,
ssm_state=128, vocab=50280; d_inner = 2*2048 = 4096, headdim 64 -> 64
SSD heads. The port's SSM-family configuration."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv=1, d_head=1,
    d_ff=0, vocab=50280, act="swiglu", rope="none",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_chunk=256,
)

SMOKE = FULL.with_(
    name="mamba2-smoke",
    n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_chunk=32,
)
