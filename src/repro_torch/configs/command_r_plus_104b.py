"""command-r-plus-104b [dense]: GQA kv=8, no biases.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-plus family].
The same reading of the model as ``repro.configs.command_r_plus_104b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab_size=128,
    dtype="float32", remat=False,
)
