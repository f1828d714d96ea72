"""qwen2.5-32b [dense]: GQA kv=8, QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5 family].
The same reading of the model as ``repro.configs.qwen25_32b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=80, n_heads=5, n_kv_heads=1, d_ff=160, vocab_size=128,
    dtype="float32", remat=False,
)
