"""hubert-xlarge [audio] — 48L d=1280 16H ff=5120 vocab=504, encoder-only
(bidirectional, no decode).  The conv waveform frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings (B, T, D).
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", n_layers=48, d_model=1280, vocab=504,
    n_heads=16, n_kv_heads=16, head_dim=80, causal=False,
    d_ff=5120, gated_mlp=False, activation="gelu", pattern=("g",),
    frontend="audio_stub", tie_embeddings=False,
    supports_decode=False, supports_long_context=False,
)
