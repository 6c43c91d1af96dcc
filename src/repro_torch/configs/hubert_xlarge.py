"""HuBERT-XLarge [arXiv:2106.07447]: 48L d_model=1280 16H (MHA, d_head 80)
d_ff=5120 (GELU) vocab=504, the k-means unit inventory of masked-unit
prediction. An encoder: non-causal, no rotary embedding, no token table.
The conv waveform frontend is not part of the model: its input is
precomputed frame embeddings (B, S, 1280). The port's audio-family
configuration."""
from repro_torch.models.common import ArchConfig

FULL = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_head=80,
    d_ff=5120, vocab=504, act="gelu", rope="none",
    causal=False, input_mode="embeds",
)

SMOKE = FULL.with_(
    name="hubert-xlarge-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=64, q_chunk=64,
)
