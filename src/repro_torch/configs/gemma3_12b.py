"""gemma3-12b [dense] — 48L d=3840 16H (GQA kv=8) ff=15360 vocab=262144,
5:1 local:global attention, 128k context.  [hf:google/gemma-3; unverified]

Faithful points: head_dim=256 (explicit, != d/H), qk-norm, gemma GeGLU MLP,
sqrt(d) embedding scaling, 1024-token local window, pattern LLLLLG.
Simplification: single rope_theta (1e6) for both local and global layers.
long_500k applicable: 40/48 layers are window-bounded; the 8 global-layer
caches shard over the mesh (see DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, vocab=262144,
    n_heads=16, n_kv_heads=8, head_dim=256, qk_norm=True,
    d_ff=15360, activation="gelu", pattern=("l", "l", "l", "l", "l", "g"),
    window=1024, rope_theta=1_000_000.0, embed_scale=True,
    tie_embeddings=True, supports_long_context=True,
)
