"""qwen1.5-0.5b [dense] — 24L d=1024 16H (GQA kv=16) ff=2816 vocab=151936,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", n_layers=24, d_model=1024, vocab=151936,
    n_heads=16, n_kv_heads=16, head_dim=64, qkv_bias=True,
    d_ff=2816, pattern=("g",), rope_theta=1_000_000.0,
    tie_embeddings=True, supports_long_context=False,
)
