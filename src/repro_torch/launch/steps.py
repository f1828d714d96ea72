"""Step functions of the port (the port of ``repro.launch.steps``'s step
builders), on one device.

``make_train_step`` is the reference's training step: gradient
accumulation over microbatches, a compute-dtype copy of the f32 master
weights that the gradients are taken against, gradients accumulated in
``grad_comm_dtype`` and then cast to f32 and averaged, global-norm
clipping and the AdamW update.  On the card the forward and the backward
of every attention and SSM layer run the ``flash_attention`` and
``ssd_scan`` kernels and their backward kernels.  ``make_prefill_step``
and ``make_serve_step`` wrap ``LanguageModel.prefill`` and
``decode_step``.

The reference's ``Cell``, ``build_cell``, ``cache_shardings`` and
``abstract_cache`` lay a step out over a device mesh; they wait for the
port's layout slice, and ``param_shardings`` has no counterpart yet (one
device holds everything).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import LanguageModel
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map

__all__ = [
    "TOKENS_PER_MICROBATCH",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
    "pick_microbatches",
]

TOKENS_PER_MICROBATCH = 8192  # per-device target


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for each leaf (zeros where the loss does not read one)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads, strict=True)]


def make_train_step(
    lm: LanguageModel,
    opt_cfg: AdamWConfig,
    n_micro: int,
    grad_comm_dtype: str = "bfloat16",
) -> Callable:
    """The gradient-accumulated train step ``step(params, opt_state,
    batch) -> (params, opt_state, metrics)``; ``batch`` holds ``tokens``
    and ``labels`` [B, S] (and, vlm, ``img`` [B, n_img, D]), B a multiple
    of ``n_micro``.  The params and moments are updated in place.

    The master weights are cast to the compute dtype once a step and the
    gradients taken against that copy, so the backward yields
    compute-dtype gradients; with several microbatches each one's
    gradients are added up in ``grad_comm_dtype`` (the reference's bf16
    gradient communication: any f32 convert before the cross-data
    reduction would double its bytes), then cast to f32 and divided by
    ``n_micro``.  One microbatch casts its gradients to f32 directly."""
    comm_dt = torch_dtype(grad_comm_dtype)
    compute_dt = torch_dtype(lm.cfg.dtype)

    def cast(p: torch.Tensor) -> torch.Tensor:
        if not p.is_floating_point():
            return p
        return p.detach().to(compute_dt).requires_grad_()

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        tokens, labels, img = batch["tokens"], batch["labels"], batch.get("img")
        params_c = tree_map(cast, params)
        leaves = tree_leaves(params_c)
        if n_micro > 1:
            mb = tokens.shape[0] // n_micro
            acc: Optional[List[torch.Tensor]] = None
            losses = []
            for i in range(n_micro):
                rows = slice(i * mb, (i + 1) * mb)
                loss, _ = lm.loss(params_c, tokens[rows], labels[rows], None if img is None else img[rows])
                grads = _grads(loss, leaves)
                if acc is None:
                    acc = [torch.zeros(x.shape, dtype=comm_dt, device=x.device) for x in leaves]
                for a, g in zip(acc, grads, strict=True):
                    a.add_(g.to(comm_dt))
                del grads
                losses.append(loss.detach())
            flat = [a.float() / n_micro for a in acc]
            loss = torch.stack(losses).mean()
        else:
            loss, _ = lm.loss(params_c, tokens, labels, img)
            flat = [g.float() for g in _grads(loss, leaves)]
            loss = loss.detach()
        del params_c, leaves
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(lm: LanguageModel, max_len: int) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits [B, V], the
    filled DecodeCache)``: the serving handoff."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = lm.prefill(params, batch["tokens"], max_len, batch.get("img"))
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(lm: LanguageModel) -> Callable:
    """``serve_step(params, cache, tokens [B, 1]) -> (logits [B, V], the
    cache one position on)``; the cache passed in is consumed."""

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, tokens, cache)

    return serve_step


def pick_microbatches(cfg: ModelConfig, shape: ShapeSpec, dp: int = 1) -> int:
    """Microbatches a train step of ``shape`` takes: the batch a
    data-parallel rank holds cut to about ``TOKENS_PER_MICROBATCH`` tokens
    a microbatch, in a count that divides it.  ``dp`` is 1 until the
    port lays a step over a mesh."""
    per_dp = max(shape.global_batch // dp, 1)
    tokens_per = per_dp * shape.seq_len
    n = max(1, tokens_per // TOKENS_PER_MICROBATCH)
    while per_dp % n != 0 and n > 1:
        n -= 1
    return n
