"""Qwen2-VL-2B [arXiv:2409.12191]: 28L d_model=1536 12H (GQA kv=2, d_head
128) d_ff=8960 vocab=151936, M-RoPE with sections (16, 24, 24) over the
(t, h, w) position streams, tied embeddings. The vision frontend (the
dynamic-resolution ViT) is not part of the model: prefill takes
precomputed patch and text embeddings with their (t, h, w) ids, decode
takes text token ids. The port's vlm-family configuration."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_head=128,
    d_ff=8960, vocab=151936, act="swiglu", rope="mrope",
    mrope_sections=(16, 24, 24), input_mode="embeds",
    tie_embeddings=True,
)

SMOKE = FULL.with_(
    name="qwen2-vl-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
    d_ff=128, vocab=256, mrope_sections=(2, 3, 3), q_chunk=64,
)
