"""DeepSeek-MoE-16B [arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]:
28L d_model=2048 16H (MHA, kv 16) d_ff=1408 per routed expert, 64 routed
experts top-6 plus 2 shared experts, vocab=102400. The shared experts are
modelled, as in the reference, as one always-on SwiGLU MLP of width
2·1408 (``shared_ff``) beside the routed ones; every layer is MoE."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=102400, act="swiglu", rope="rope",
    n_experts=64, top_k=6, shared_ff=2816,
)

SMOKE = FULL.with_(
    name="deepseek-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=96, vocab=256, n_experts=8, top_k=3, shared_ff=192,
    moe_group=64, q_chunk=64,
)
