"""deepseek-moe-16b [moe]: fine-grained MoE, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=102400,
first layer dense [arXiv:2401.06066].
The same reading of the model as ``repro.configs.deepseek_moe_16b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    expert_d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_layer_dense=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, expert_d_ff=96,
    vocab_size=128, n_experts=8, top_k=2, n_shared_experts=1, capacity_factor=8.0,
    dtype="float32", remat=False,
)
