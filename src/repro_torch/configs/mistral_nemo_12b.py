"""Mistral-Nemo-12B. [hf:mistralai/Mistral-Nemo-Base-2407; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx
(head_dim 128 per the HF config; rope theta 1e6 for long context)."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_head=128,
    d_ff=14336, vocab=131072, act="swiglu", rope="rope",
    rope_theta=1_000_000.0,
)

SMOKE = FULL.with_(
    name="mistral-nemo-12b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32,
    d_ff=256, vocab=512, q_chunk=64,
)
