"""Step functions, and their layout over a device mesh (the port of
``repro.launch.steps``).

``make_train_step`` is the reference's training step: gradient
accumulation over microbatches, a compute-dtype copy of the f32 master
weights that the gradients are taken against, gradients accumulated in
``grad_comm_dtype`` and then cast to f32 and averaged, global-norm
clipping and the AdamW update.  On the card the forward and the backward
of every attention and SSM layer run the ``flash_attention`` and
``ssd_scan`` kernels and their backward kernels.  ``make_prefill_step``
and ``make_serve_step`` wrap ``LanguageModel.prefill`` and
``decode_step``.

``build_cell(arch, shape, mesh)`` returns everything the dry run
(:mod:`repro_torch.launch.dryrun`) and a real launcher need for one
(architecture x input shape) cell: the step function, ``meta`` stand-ins
for every argument (no allocation), the argument and output shardings
(params via their logical axes, batch via the data axes, decode caches
via :func:`cache_shardings`), the donated arguments and the sharding
fallbacks.  ``make_train_step(..., param_shardings=)`` pins each
microbatch's gradients to their parameter's layout (the reference's
``pin``), so their reduction over the data axes is a reduce-scatter into
the local shard.  On one device every layout is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import DecodeCache, LanguageModel
from repro_torch.roofline.analysis import H100_SXM, Hardware, weight_budget_gb
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = [
    "TOKENS_PER_MICROBATCH",
    "Cell",
    "abstract_cache",
    "build_cell",
    "cache_shardings",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
    "pick_microbatches",
]

TOKENS_PER_MICROBATCH = 8192  # per-device target


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    step_fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    fallbacks: List[str]
    n_microbatches: int = 1


def _size(mesh, axes) -> int:
    sizes = shd.axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _bspec(mesh, batch: int, ndim: int) -> P:
    dp = shd.data_axes(mesh)
    if batch % _size(mesh, dp) == 0 and batch > 0:
        lead = dp if len(dp) > 1 else dp[0]
        return P(lead, *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def cache_shardings(mesh, cfg: ModelConfig, cache: DecodeCache) -> DecodeCache:
    """Shardings for every DecodeCache field (the reference's KV policy,
    DESIGN.md §7): batch over the data axes where it divides; KV heads
    over the model axis where they divide, else the sequence (and, at
    batch 1, the idle data axes too: context-parallel KV)."""
    dp = shd.data_axes(mesh)
    dp_size = _size(mesh, dp)
    tp = shd.axis_sizes(mesh).get("model", 1)

    def named(spec):
        return NamedSharding(mesh, spec)

    def batch_part(b):
        if b % dp_size == 0 and b > 0:
            return dp if len(dp) > 1 else dp[0]
        return None

    def kv(field):  # [L, B, S, KVH, hd]
        if field.dim() < 5 or field.numel() == 0:
            return named(P())
        _, b, s, kvh, _ = field.shape
        bp = batch_part(b)
        if kvh % tp == 0 and kvh >= tp:
            return named(P(None, bp, None, "model", None))
        seq_axes: Tuple[str, ...] = ("model",)
        if bp is None:
            seq_axes = ("model", *dp)
        if s % _size(mesh, seq_axes) == 0 and s > 0:
            return named(P(None, bp, seq_axes, None, None))
        return named(P(None, bp, None, None, None))

    def ring(field):  # [U, nl, B, W, KVH, hd]
        if field.dim() < 6 or field.numel() == 0:
            return named(P())
        b, w = field.shape[2], field.shape[3]
        return named(P(None, None, batch_part(b), "model" if w % tp == 0 else None, None, None))

    def ssm_state(field):  # [L, B, H, P, N]
        if field.dim() < 5 or field.numel() == 0:
            return named(P())
        b, h = field.shape[1], field.shape[2]
        return named(P(None, batch_part(b), "model" if h % tp == 0 else None, None, None))

    def ssm_conv(field):  # [L, B, 3, C]
        if field.dim() < 4 or field.numel() == 0:
            return named(P())
        b, c = field.shape[1], field.shape[3]
        return named(P(None, batch_part(b), None, "model" if c % tp == 0 else None))

    def img(field):  # [B, n, D]
        if field.dim() < 3 or field.numel() == 0:
            return named(P())
        return named(P(batch_part(field.shape[0]), None, None))

    return DecodeCache(
        k=kv(cache.k), v=kv(cache.v), k_loc=ring(cache.k_loc), v_loc=ring(cache.v_loc),
        ssm_conv=ssm_conv(cache.ssm_conv), ssm_state=ssm_state(cache.ssm_state),
        shared_k=kv(cache.shared_k), shared_v=kv(cache.shared_v), img_feats=img(cache.img_feats),
        position=named(_bspec(mesh, cache.position.shape[0], 1)),
    )


def abstract_cache(lm: LanguageModel, batch: int, max_len: int) -> DecodeCache:
    """``init_cache``'s shapes and dtypes as ``meta`` tensors (no
    allocation); the vlm's image features [B, n_img, D] included."""
    cfg = lm.cfg
    img = None
    if cfg.family == "vlm":
        img = torch.empty((batch, cfg.n_img_tokens, cfg.d_model), dtype=torch_dtype(cfg.dtype), device="meta")
    return lm.init_cache(batch, max_len, img, device="meta")


def _micro(t: Optional[torch.Tensor], i: int, n_micro: int) -> Optional[torch.Tensor]:
    """Microbatch ``i`` of ``n_micro`` of a batch-leading tensor: its rows
    ``[i mb, (i + 1) mb)``.  A DTensor sharded on the batch is cut on each
    rank instead (every data-parallel rank splits the rows it holds), so
    the microbatch keeps the batch's layout."""
    if t is None:
        return None
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor) and any(p == Shard(0) for p in t.placements):
        local = t.to_local()
        mb = local.shape[0] // n_micro
        shape = (t.shape[0] // n_micro, *t.shape[1:])
        return DTensor.from_local(local[i * mb:(i + 1) * mb], t.device_mesh, t.placements, run_check=False,
                                  shape=shape, stride=tuple(torch.empty(shape, device="meta").stride()))
    mb = t.shape[0] // n_micro
    return t[i * mb:(i + 1) * mb]


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for each leaf (zeros where the loss does not read one)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads, strict=True)]


def make_train_step(
    lm: LanguageModel,
    opt_cfg: AdamWConfig,
    n_micro: int,
    param_shardings: Any = None,
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
    ``n_micro``.  One microbatch casts its gradients to f32 directly.

    ``param_shardings`` (a :class:`NamedSharding` tree like the params)
    pins each microbatch's gradients, and the accumulator, to their
    parameter's layout when they are DTensors: their sum over the data
    axes then lowers to a reduce-scatter into the local shard, not an
    all-reduce of the whole gradient."""
    comm_dt = torch_dtype(grad_comm_dtype)
    compute_dt = torch_dtype(lm.cfg.dtype)
    pins = None if param_shardings is None else tree_leaves(param_shardings)

    def pin(flat: List[torch.Tensor]) -> List[torch.Tensor]:
        if pins is None:
            return flat
        from torch.distributed.tensor import DTensor

        return [g.redistribute(s.mesh, s.placements) if isinstance(g, DTensor) else g
                for g, s in zip(flat, pins, strict=True)]

    def cast(p: torch.Tensor) -> torch.Tensor:
        if not p.is_floating_point():
            return p
        return p.detach().to(compute_dt).requires_grad_()

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        tokens, labels, img = batch["tokens"], batch["labels"], batch.get("img")
        params_c = tree_map(cast, params)
        leaves = tree_leaves(params_c)
        if n_micro > 1:
            acc: Optional[List[torch.Tensor]] = None
            losses = []
            for i in range(n_micro):
                loss, _ = lm.loss(params_c, *(_micro(t, i, n_micro) for t in (tokens, labels, img)))
                grads = pin(_grads(loss, leaves))
                if acc is None:
                    acc = pin([torch.zeros_like(x, dtype=comm_dt) for x in leaves])
                for a, g in zip(acc, grads, strict=True):
                    a.add_(g.to(comm_dt))
                del grads
                losses.append(loss.detach())
            flat = [a.float() / n_micro for a in acc]
            loss = torch.stack(losses).mean()
        else:
            loss, _ = lm.loss(params_c, tokens, labels, img)
            flat = pin([g.float() for g in _grads(loss, leaves)])
            loss = loss.detach()
        del params_c, leaves
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(lm: LanguageModel, max_len: int, cache_shardings: Any = None) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits [B, V], the
    filled DecodeCache)``: the serving handoff.  With ``cache_shardings``
    (a DecodeCache of :class:`NamedSharding`, :func:`cache_shardings`) the
    cache is allocated shard by shard in that layout, as the reference's
    ``out_shardings`` lay it out."""

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens, img = batch["tokens"], batch.get("img")
        cache = None
        if cache_shardings is not None:
            from torch.distributed.tensor import DTensor

            dev = tokens.to_local().device if isinstance(tokens, DTensor) else tokens.device
            like = abstract_cache(lm, tokens.shape[0], max_len)
            cache = DecodeCache(*(
                shd.sharded_zeros(t, sh, dev) for t, sh in zip(like, cache_shardings, strict=True)
            ))
            if img is not None:
                cache = cache._replace(img_feats=img)
        logits, cache = lm.prefill(params, tokens, max_len, img, cache=cache)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(lm: LanguageModel) -> Callable:
    """``serve_step(params, cache, tokens [B, 1]) -> (logits [B, V], the
    cache one position on)``; the cache passed in is consumed."""

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, tokens, cache)

    return serve_step


def pick_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> int:
    """Microbatches a train step of ``shape`` takes: the batch a
    data-parallel rank of ``mesh`` holds (the whole batch without one)
    cut to about ``TOKENS_PER_MICROBATCH`` tokens a microbatch, in a
    count that divides it."""
    dp = 1 if mesh is None else _size(mesh, shd.data_axes(mesh))
    per_dp = max(shape.global_batch // dp, 1)
    tokens_per = per_dp * shape.seq_len
    n = max(1, tokens_per // TOKENS_PER_MICROBATCH)
    while per_dp % n != 0 and n > 1:
        n -= 1
    return n


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------


def decode_rules(mesh, cfg: ModelConfig, shape: ShapeSpec, hw: Hardware = H100_SXM) -> shd.ShardingRules:
    """The reference's rule choice for a cell: weights resident (TP-only,
    :func:`~repro_torch.distributed.sharding.inference_rules`) when a
    decode cell's bf16 weights and its KV cache fit a card's budget
    (:func:`~repro_torch.roofline.analysis.weight_budget_gb`), else the
    FSDP :func:`~repro_torch.distributed.sharding.default_rules`."""
    if shape.kind != "decode":
        return shd.default_rules(mesh)
    tp = shd.axis_sizes(mesh).get("model", 1)
    dp = _size(mesh, shd.data_axes(mesh))
    param_gb = cfg.param_count() * 2 / tp / 1e9
    kv_per_seq = cfg.n_layers * shape.seq_len * cfg.n_kv_heads * cfg.hd * 2 * 2
    seqs_per_card = max(shape.global_batch // dp, 1)
    kv_gb = kv_per_seq * seqs_per_card / min(tp, max(cfg.n_kv_heads, 1)) / 1e9
    if param_gb + kv_gb <= weight_budget_gb(hw):
        return shd.inference_rules(mesh)
    return shd.default_rules(mesh)


def build_cell(arch: str, shape_name: str, mesh, hw: Hardware = H100_SXM) -> Cell:
    """One (arch x shape) cell on ``mesh``: the step, ``meta`` stand-ins for
    its arguments, their shardings and the sharding fallbacks."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        # Inference serves compute-dtype weights (no master copies).
        cfg = cfg.scaled(param_dtype=cfg.dtype)
    lm = LanguageModel(cfg)
    rules = decode_rules(mesh, cfg, shape, hw)
    fallbacks: List[str] = []
    params, axes = lm.abstract_init()
    param_sh = shd.shardings_for(mesh, rules, params, axes, report=fallbacks)

    def named(spec):
        return NamedSharding(mesh, spec)

    b, s = shape.global_batch, shape.seq_len
    tok = torch.empty((b, s if shape.kind != "decode" else 1), dtype=torch.int32, device="meta")
    tok_sh = named(_bspec(mesh, b, 2))
    img = img_sh = None
    if cfg.family == "vlm":
        img = torch.empty((b, cfg.n_img_tokens, cfg.d_model), dtype=torch_dtype(cfg.dtype), device="meta")
        img_sh = named(_bspec(mesh, b, 3))

    if shape.kind == "train":
        n_micro = pick_microbatches(cfg, shape, mesh)
        step = make_train_step(lm, AdamWConfig(), n_micro, param_shardings=param_sh)
        opt_state = adamw_init(params)
        opt_sh = OptState(step=named(P()), mu=param_sh, nu=param_sh)
        batch, batch_sh = {"tokens": tok, "labels": tok}, {"tokens": tok_sh, "labels": tok_sh}
        if img is not None:
            batch["img"], batch_sh["img"] = img, img_sh
        metrics_sh = {k: named(P()) for k in ("loss", "grad_norm", "learning_rate")}
        return Cell(
            arch=arch, shape=shape, cfg=cfg, step_fn=step, args=(params, opt_state, batch),
            in_shardings=(param_sh, opt_sh, batch_sh), out_shardings=(param_sh, opt_sh, metrics_sh),
            donate_argnums=(0, 1), fallbacks=fallbacks, n_microbatches=n_micro,
        )

    cache = abstract_cache(lm, b, s)
    cache_sh = cache_shardings(mesh, cfg, cache)
    logits_sh = named(_bspec(mesh, b, 2))
    if shape.kind == "prefill":
        batch, batch_sh = {"tokens": tok}, {"tokens": tok_sh}
        if img is not None:
            batch["img"], batch_sh["img"] = img, img_sh
        return Cell(
            arch=arch, shape=shape, cfg=cfg, step_fn=make_prefill_step(lm, max_len=s, cache_shardings=cache_sh),
            args=(params, batch), in_shardings=(param_sh, batch_sh), out_shardings=(logits_sh, cache_sh),
            donate_argnums=(), fallbacks=fallbacks,
        )
    # decode against a cache of seq_len context
    return Cell(
        arch=arch, shape=shape, cfg=cfg, step_fn=make_serve_step(lm), args=(params, cache, tok),
        in_shardings=(param_sh, cache_sh, tok_sh), out_shardings=(logits_sh, cache_sh),
        donate_argnums=(1,), fallbacks=fallbacks,
    )
