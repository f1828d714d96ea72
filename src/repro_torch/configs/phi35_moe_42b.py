"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=6400(expert) vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct].
The same reading of the model as ``repro.configs.phi35_moe_42b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    expert_d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, expert_d_ff=128,
    vocab_size=128, n_experts=4, top_k=2, capacity_factor=8.0,
    dtype="float32", remat=False,
)
