"""Llama-2-7B — the paper's own evaluation model geometry (Table I)."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_head=128,
    d_ff=11008, vocab=32000, act="swiglu", rope="rope",
)

SMOKE = FULL.with_(
    name="llama2-7b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_head=32,
    d_ff=344, vocab=512, q_chunk=64,
)
