"""The decoder LM, in PyTorch (the port of ``repro.models.model``'s
``LanguageModel``: its parameters and its training forward).

Three families are ported, those the reference serves from the paged KV
cache:

  dense / audio     uniform block (attention + MLP)
  moe               uniform block (attention + MoE), and for deepseek an
                    unstacked dense layer 0 (``block0``) whose MLP is as
                    wide as the active experts together

Per-layer parameters are stacked over layers, as the reference stacks
them for ``lax.scan``; the port's layer loop indexes the stack
(:func:`iter_layers`).  The tree is the reference's::

    embed [padded_vocab, d]            final_norm/scale [d]
    (unembed [padded_vocab, d] unless tie_embeddings)
    blocks/ln1/scale [L, d]            blocks/attn/{wq,wk,wv,wo}
    blocks/ln2/scale [L, d]            blocks/mlp/{w_gate?,w_up,w_down}
                                       or blocks/moe/{router,experts/*,shared/*}
    (block0/{ln1,attn,ln2,mlp} for a moe model with first_layer_dense)

The other families (local_global, vlm, ssm, hybrid) raise: they run the
reference's dense-cache decode path, which is not ported
(ROADMAP.md queue 1, item 6), as are ``loss``, ``prefill``,
``decode_step`` and ``init_cache``.  Serving runs through
:mod:`repro_torch.serving.engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamBuilder,
    embed,
    init_embedding,
    init_mlp,
    init_rms_norm,
    mlp,
    rms_norm,
    stack_layer_params,
    torch_dtype,
    unembed,
)

Params = Dict[str, Any]
Finish = Callable[[str, torch.Tensor], torch.Tensor]

PORTED_FAMILIES = ("dense", "audio", "moe")


@dataclasses.dataclass
class LanguageModel:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {self.cfg.family!r} is not ported yet: it decodes through the "
                f"reference's dense-cache path (ROADMAP.md queue 1, item 6); the port builds "
                f"{PORTED_FAMILIES}"
            )

    def init(
        self,
        generator: torch.Generator,
        *,
        device: torch.device | str = "cuda",
        finish: Optional[Finish] = None,
    ) -> Params:
        """Draw the parameters from ``generator`` on ``device`` by the
        reference's law, leaf by leaf in the reference's order; ``finish``
        maps each leaf (``finish("blocks/attn/wq", value)``) as soon as it
        is drawn."""
        return self._build(generator, resolve_device(device), finish)[0]

    def param_specs(self) -> Dict[str, Tuple[int, ...]]:
        """Each leaf's path (``"blocks/attn/wq"``) and shape, with nothing
        allocated."""
        return self._build(None, torch.device("cpu"), None)[1]

    def _build(
        self, generator: Optional[torch.Generator], dev: torch.device, finish: Optional[Finish]
    ) -> Tuple[Params, Dict[str, Tuple[int, ...]]]:
        cfg = self.cfg

        def scoped(prefix):
            if finish is None:
                return None
            return lambda path, value: finish(f"{prefix}/{path}", value)

        b = ParamBuilder(generator, cfg.param_dtype, device=dev, finish=finish)
        init_embedding(b, "embed", cfg.padded_vocab, cfg.d_model)
        init_rms_norm(b, "final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            b.param("unembed", (cfg.padded_vocab, cfg.d_model))
        params, specs = dict(b.params), dict(b.specs)
        parts = [("blocks", stack_layer_params(
            self._init_block, generator, self._n_scan, cfg.param_dtype, device=dev,
            finish=scoped("blocks"),
        ))]
        if self.has_block0:
            bb = ParamBuilder(generator, cfg.param_dtype, device=dev, finish=scoped("block0"))
            self._init_dense_block(bb, d_ff=self._dense_ff)
            parts.append(("block0", bb))
        for name, part in parts:
            params[name] = part.params
            specs.update({f"{name}/{k}": v for k, v in part.specs.items()})
        return params, specs

    @property
    def has_block0(self) -> bool:
        """deepseek's layer 0: a dense block outside the stack."""
        return self.cfg.family == "moe" and self.cfg.first_layer_dense

    @property
    def _n_scan(self) -> int:
        return self.cfg.n_layers - (1 if self.has_block0 else 0)

    @property
    def _dense_ff(self) -> int:
        # deepseek's dense layer-0 FFN width: match total MoE active width
        cfg = self.cfg
        e_ff = cfg.expert_d_ff or cfg.d_ff
        return e_ff * (cfg.top_k + cfg.n_shared_experts)

    def _init_dense_block(self, b, d_ff: Optional[int] = None) -> None:
        cfg = self.cfg
        init_rms_norm(b, "ln1", cfg.d_model)
        attn_lib.init_attention(b.scope("attn"), cfg)
        init_rms_norm(b, "ln2", cfg.d_model)
        init_mlp(b, "mlp", cfg.d_model, d_ff or cfg.d_ff, cfg.gated_mlp)

    def _init_block(self, b) -> None:
        cfg = self.cfg
        if cfg.family == "moe":
            init_rms_norm(b, "ln1", cfg.d_model)
            attn_lib.init_attention(b.scope("attn"), cfg)
            init_rms_norm(b, "ln2", cfg.d_model)
            moe_lib.init_moe(b.scope("moe"), cfg)
        else:
            self._init_dense_block(b)

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, padded_vocab] (float32), causal
        attention over the whole sequence, no caches."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        for p in iter_layers(params, cfg):
            x = x + attn_lib.attention_train(
                p["attn"], rms_norm(x, p["ln1"]["scale"], cfg.norm_eps), cfg, positions
            )
            x = x + feed_forward(p, rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return unembed(params.get("unembed", params["embed"]), x)


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's slice of the stacked ``blocks`` tree (views)."""
    return {
        k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
        for k, v in blocks.items()
    }


def iter_layers(params: Params, cfg: ModelConfig) -> Iterator[Params]:
    """Each layer's parameters in depth order: ``block0`` first where the
    model has one, then the stack."""
    if "block0" in params:
        yield params["block0"]
    n = cfg.n_layers - (1 if "block0" in params else 0)
    for layer in range(n):
        yield layer_params(params["blocks"], layer)


def feed_forward(p: Params, hn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN on its normed input: the MoE where the layer has one,
    else the MLP."""
    if "moe" in p:
        return moe_lib.moe_layer(p["moe"], hn, cfg)
    return mlp(p["mlp"], hn, cfg.act)
