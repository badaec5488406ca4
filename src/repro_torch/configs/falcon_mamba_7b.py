"""falcon-mamba-7b [ssm] — 64L d=4096 attention-free Mamba-1,
d_inner=8192, ssm_state=16, dt_rank=256, vocab=65024.
[arXiv:2410.05355; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", n_layers=64, d_model=4096, vocab=65024,
    pattern=("m",), d_inner=8192, ssm_state=16, dt_rank=256, conv_width=4,
    tie_embeddings=False, supports_long_context=True,
)
