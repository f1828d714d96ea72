"""The decoder LM's parameters, in PyTorch (the port of
``repro.models.model``'s ``LanguageModel.init``).

Only the ``dense`` family is ported: a uniform block (attention + MLP)
whose parameters are stacked over layers, as the reference stacks them
for ``lax.scan``; the port's layer loop indexes the stack.  The tree is
the reference's::

    embed [padded_vocab, d]            final_norm/scale [d]
    (unembed [padded_vocab, d] unless tie_embeddings)
    blocks/ln1/scale [L, d]            blocks/attn/{wq,wk,wv,wo}
    blocks/ln2/scale [L, d]            blocks/mlp/{w_gate?,w_up,w_down}

The other families raise until their queue item (ROADMAP.md queue 1,
item 8).  The training forward and the dense-cache decode path are not
ported; serving runs through :mod:`repro_torch.serving.engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamBuilder,
    init_embedding,
    init_mlp,
    init_rms_norm,
    stack_layer_params,
)

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass
class LanguageModel:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {self.cfg.family!r} is not ported yet (ROADMAP.md "
                f"queue 1, item 8); the port builds {PORTED_FAMILIES}"
            )

    def init(
        self, generator: torch.Generator, *, device: torch.device | str = "cuda"
    ) -> Params:
        """Draw the parameters from ``generator`` on ``device`` by the
        reference's law."""
        return self._build(generator, resolve_device(device))[0]

    def param_specs(self) -> Dict[str, Tuple[int, ...]]:
        """Each leaf's path (``"blocks/attn/wq"``) and shape, with nothing
        allocated."""
        return self._build(None, torch.device("cpu"))[1]

    def _build(
        self, generator: Optional[torch.Generator], dev: torch.device
    ) -> Tuple[Params, Dict[str, Tuple[int, ...]]]:
        cfg = self.cfg
        b = ParamBuilder(generator, cfg.param_dtype, device=dev)
        init_embedding(b, "embed", cfg.padded_vocab, cfg.d_model)
        init_rms_norm(b, "final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            b.param("unembed", (cfg.padded_vocab, cfg.d_model))
        blocks = stack_layer_params(
            self._init_dense_block, generator, cfg.n_layers, cfg.param_dtype, device=dev
        )
        params = dict(b.params, blocks=blocks.params)
        specs = dict(b.specs)
        specs.update({f"blocks/{k}": v for k, v in blocks.specs.items()})
        return params, specs

    def _init_dense_block(self, b, d_ff: Optional[int] = None) -> None:
        cfg = self.cfg
        init_rms_norm(b, "ln1", cfg.d_model)
        attn_lib.init_attention(b.scope("attn"), cfg)
        init_rms_norm(b, "ln2", cfg.d_model)
        init_mlp(b, "mlp", cfg.d_model, d_ff or cfg.d_ff, cfg.gated_mlp)


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's slice of the stacked ``blocks`` tree (views)."""
    return {
        k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
        for k, v in blocks.items()
    }
