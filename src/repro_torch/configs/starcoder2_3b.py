"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) ff=12288 vocab=49152,
GQA + RoPE, biases on all linears, non-gated GeLU MLP.  [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072, vocab=49152,
    n_heads=24, n_kv_heads=2, head_dim=128, qkv_bias=True, o_bias=True,
    d_ff=12288, gated_mlp=False, mlp_bias=True, activation="gelu",
    pattern=("g",), rope_theta=999_999.44,
    tie_embeddings=True, supports_long_context=False,
)
