"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280 (padded to 50432), ssm_state=128
[arXiv:2405.21060].
The same reading of the model as ``repro.configs.mamba2_130m``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,  # unused (attention-free); kept for config uniformity
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, vocab_size=128, ssm_state=16, ssm_head_dim=32,
    dtype="float32", remat=False,
)
