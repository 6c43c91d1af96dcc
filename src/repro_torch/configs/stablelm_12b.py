"""StableLM-2-12B: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. Its SMOKE geometry exercises GQA on the packed path."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_head=160,
    d_ff=13824, vocab=100352, act="swiglu", rope="rope",
)

SMOKE = FULL.with_(
    name="stablelm-12b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32,
    d_ff=256, vocab=512, q_chunk=64,
)
