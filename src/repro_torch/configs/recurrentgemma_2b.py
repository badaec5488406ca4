"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) ff=7680
vocab=256000, RG-LRU + local attention 1:2 (pattern RRL), window 2048.
[arXiv:2402.19427; hf]

26 = 8 full (r,r,l) units + 2 remainder recurrent layers (explicit)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", n_layers=26, d_model=2560, vocab=256000,
    n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, activation="gelu", pattern=("r", "r", "l"), window=2048,
    lru_width=2560, conv_width=4, rope_theta=10_000.0, embed_scale=True,
    tie_embeddings=True, supports_long_context=True,
)
