"""olmoe-1b-7b [moe] — 16L d=2048 16H (kv=16) vocab=50304, MoE 64 experts
top-8, d_ff_expert=1024, qk-norm.  [arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, vocab=50304,
    n_heads=16, n_kv_heads=16, head_dim=128, qk_norm=True,
    pattern=("g:moe",), n_experts=64, top_k=8, d_ff_expert=1024,
    router="softmax", rope_theta=10_000.0,
    tie_embeddings=False, supports_long_context=False,
)
