"""gemma3-12b [dense/local_global]: 5:1 local:global, window 1024, 128k ctx.

48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144
[hf:google/gemma-3 family].
The same reading of the model as ``repro.configs.gemma3_12b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="local_global",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    window=1024,
    local_ratio=5,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256, window=8, local_ratio=2,
    dtype="float32", remat=False,
)
