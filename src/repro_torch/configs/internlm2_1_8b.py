"""internlm2-1.8b [dense] — 24L d=2048 16H (GQA kv=8) ff=8192 vocab=92544.
[arXiv:2403.17297; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, vocab=92544,
    n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, pattern=("g",), rope_theta=1_000_000.0,
    tie_embeddings=False, supports_long_context=False,
)
