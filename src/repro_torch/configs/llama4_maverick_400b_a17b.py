"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) vocab=202048,
MoE 128 experts top-1 + shared expert, alternating dense/MoE layers
(interleave step 2, as released).  [hf:meta-llama/Llama-4; unverified]

d_ff_expert=8192 per the assignment; interleaved dense layers use 16384
(2x), matching the released Maverick geometry and the 400B-total /
17B-active parameter budget.  Sigmoid router (llama4-style).
param/opt dtype bf16 so that params+Adam state fit 16 GiB/chip HBM on a
v5e-256 pod (documented in EXPERIMENTS.md §Dry-run)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
    vocab=202048, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, pattern=("g", "g:moe"),
    n_experts=128, top_k=1, d_ff_expert=8192, shared_expert=True,
    router="sigmoid", rope_theta=500_000.0,
    tie_embeddings=False, supports_long_context=False,
    param_dtype="bfloat16",
)
