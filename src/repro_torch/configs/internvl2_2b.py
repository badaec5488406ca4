"""internvl2-2b [vlm] — InternViT frontend + InternLM2-1.8b backbone,
24L d=2048 16H (GQA kv=8) ff=8192 vocab=92553.  [arXiv:2404.16821; hf]

The ViT is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (B, 256, D) spliced over the first 256 token positions.
vocab 92553 is padded to 92672 for TP-16 divisibility (loss masks the pad)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", n_layers=24, d_model=2048, vocab=92553,
    n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, pattern=("g",), rope_theta=1_000_000.0,
    frontend="vision_stub", n_image_embeds=256,
    tie_embeddings=False, supports_long_context=False,
)
