"""zamba2-7b [hybrid]: 81 Mamba2 layers + shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Mamba2 blocks with a *shared* (single-parameter-set) attention+MLP block
invoked every 6th layer (13 invocations), following the Zamba2 shared-
block design [arXiv:2411.15242].
The same reading of the model as ``repro.configs.zamba2_7b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=128, ssm_state=16, ssm_head_dim=32, attn_every=3,
    dtype="float32", remat=False,
)
