"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048; the EnCodec
frontend is a stub per the assignment — the backbone consumes audio-token
ids directly [arXiv:2306.05284].
The same reading of the model as ``repro.configs.musicgen_large``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    gated_mlp=False,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
    dtype="float32", remat=False,
)
