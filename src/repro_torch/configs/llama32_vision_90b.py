"""llama-3.2-vision-90b [vlm]: cross-attention image layers every 5th.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; the vision
frontend is a stub per the assignment — input_specs() provides
precomputed patch embeddings [B, n_img_tokens, d_model]
[hf:meta-llama/Llama-3.2-90B-Vision family].
The same reading of the model as ``repro.configs.llama32_vision_90b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_every=5,
    n_img_tokens=1024,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
    cross_every=5, n_img_tokens=16,
    dtype="float32", remat=False,
)
