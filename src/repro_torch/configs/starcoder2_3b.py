"""starcoder2-3b [dense]: GQA kv=2, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173].
The same reading of the model as ``repro.configs.starcoder2_3b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=100_000.0,
    gated_mlp=False,
    act="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab_size=128,
    dtype="float32", remat=False,
)
