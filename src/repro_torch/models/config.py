"""Model configuration covering all assigned architecture families.

A copy of ``repro.models.config`` (framework-free): the port imports
nothing of the JAX package.  The port builds every family.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | local_global | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window: int = 0  # sliding-window size for local layers
    local_ratio: int = 0  # local:global pattern, e.g. 5 => 5 local + 1 global

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    first_layer_dense: bool = False  # deepseek-moe layer 0 is a dense FFN
    # routing in token chunks bounds the [T,k,E] dispatch intermediates
    # (EXPERIMENTS §Perf fleet notes); 0 = single-pass
    moe_route_chunk: int = 16384

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # zamba2: shared attention block every k SSM layers

    # VLM
    cross_every: int = 0  # cross-attention every k-th layer
    n_img_tokens: int = 0

    # misc
    norm_eps: float = 1e-5
    act: str = "silu"
    gated_mlp: bool = True  # False => GPT-style 2-matrix MLP (starcoder2)
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # serving
    kv_block_size: int = 128  # COW page size for the serving engine

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid", "local_global")

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # parameter-count helpers (used for roofline MODEL_FLOPS) ------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        mlp_dense = (3 if self.gated_mlp else 2) * d * self.d_ff
        per_layer = 2 * d  # norms
        total = 0
        if self.family in ("dense", "audio", "local_global"):
            total += self.n_layers * (attn + mlp_dense + per_layer)
        elif self.family == "vlm":
            total += self.n_layers * (attn + mlp_dense + per_layer)
            n_cross = self.n_layers // max(self.cross_every, 1)
            total += n_cross * (attn + d)  # cross-attention blocks
        elif self.family == "moe":
            e_ff = self.expert_d_ff or self.d_ff
            moe = 3 * d * e_ff * (self.n_experts + self.n_shared_experts)
            moe += d * self.n_experts  # router
            n_moe = self.n_layers - (1 if self.first_layer_dense else 0)
            total += n_moe * (attn + moe + per_layer)
            if self.first_layer_dense:
                total += attn + mlp_dense + per_layer
        elif self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * ns + self.n_ssm_heads) + di * d
            ssm += self.ssm_conv * (di + 2 * ns) + 2 * self.n_ssm_heads
            total += self.n_layers * (ssm + per_layer)
            if self.family == "hybrid":
                total += attn + mlp_dense + 2 * d  # one shared attn block
        total += self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        e_ff = self.expert_d_ff or self.d_ff
        total_experts = 3 * d * e_ff * (self.n_experts + self.n_shared_experts)
        active_experts = 3 * d * e_ff * (self.top_k + self.n_shared_experts)
        n_moe = self.n_layers - (1 if self.first_layer_dense else 0)
        return self.param_count() - n_moe * (total_experts - active_experts)
