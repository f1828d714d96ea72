"""Logical-axis sharding rules with per-dimension divisibility fallback,
on ``torch.distributed`` device meshes (the port of
``repro.distributed.sharding``).

Parameters carry logical axis names recorded at init
(:class:`repro_torch.models.layers.ParamBuilder`); this module maps those
names onto mesh axes, as the reference does:

    embed      -> FSDP axes ("pod","data")   (ZeRO-3 style full sharding)
    heads      -> TP axis  ("model",)        if divisible, else replicated
    kv_heads   -> TP axis  if divisible (GQA often is not), else replicated
    mlp        -> TP axis
    experts    -> EP over the TP axis
    vocab      -> TP axis
    layers / head_dim / expert_mlp / None -> replicated

Divisibility fallback happens *per parameter dimension* and every
fallback is recorded for the dry-run report.  A spec is a
:class:`PartitionSpec`, a tuple that compares one to one with the
reference's; :func:`placements` turns it into DTensor ``Shard`` /
``Replicate`` placements on a ``DeviceMesh`` (a dimension sharded over
``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions, in mesh
order, as the reference's major-to-minor order lays it out).

The activation hooks (:func:`constrain`, :func:`gather_weight`) are the
counterpart of ``with_sharding_constraint``: inside
:func:`activation_sharding` they redistribute a DTensor to the spec the
reference's rules give; outside it, or on a plain tensor, they return
their input unchanged, so one-device code is untouched.  A mesh here is
a ``torch.distributed.device_mesh.DeviceMesh``, or any object with the
reference's ``shape`` mapping and ``axis_names`` (a shape-only stand-in
is enough for :func:`spec_for`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "ACT_RULES",
    "NamedSharding",
    "PartitionSpec",
    "ShardingRules",
    "activation_sharding",
    "activation_spec",
    "axis_names",
    "axis_sizes",
    "batch_spec",
    "constrain",
    "data_axes",
    "default_rules",
    "gather_weight",
    "inference_rules",
    "placements",
    "shard_count",
    "sharded_embed",
    "sharding_mode",
    "shardings_for",
    "spec_for",
    "tp_size",
]


class PartitionSpec(tuple):
    """A spec: one entry a tensor dimension, each ``None`` (replicated), a
    mesh axis name, or a tuple of names (major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> preferred mesh axes (in fallback order)."""

    rules: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def lookup(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        for key, axes in self.rules:
            if key == name:
                return axes
        return ()


def default_rules(mesh) -> ShardingRules:
    names = axis_names(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    return ShardingRules(
        rules=(
            ("embed", fsdp),
            ("heads", tp),
            ("kv_heads", tp),
            ("head_dim", ()),
            ("mlp", tp),
            ("expert_mlp", ()),
            ("experts", tp),
            ("vocab", tp),
            ("layers", ()),
        )
    )


def inference_rules(mesh) -> ShardingRules:
    """Decode-time rules: weights resident, TP-only.

    Per-token FSDP weight gathers dwarf a decode step's useful traffic,
    so the ``embed`` dimension is left unsharded across the DP axes.
    ``head_dim`` is a *fallback* TP dimension: when the head count does
    not divide the TP axis (qwen's 40, starcoder2's 24), the projection
    weights shard on head_dim instead of being fully replicated.  The
    `used`-axis bookkeeping in :func:`spec_for` makes this automatic:
    when "heads" takes the model axis, "head_dim" cannot.
    """
    tp = ("model",) if "model" in axis_names(mesh) else ()
    return ShardingRules(
        rules=(
            ("embed", ()),
            ("heads", tp),
            ("kv_heads", tp),
            ("head_dim", tp),
            ("mlp", tp),
            ("expert_mlp", ()),
            ("experts", tp),
            ("vocab", tp),
            ("layers", ()),
        )
    )


def _axis_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def spec_for(
    mesh,
    rules: ShardingRules,
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    fallbacks: Optional[List[str]] = None,
) -> PartitionSpec:
    """PartitionSpec for one parameter, with divisibility fallback."""
    used: set = set()
    parts: List[Any] = []
    for dim, name in zip(shape, logical, strict=True):
        axes = tuple(a for a in rules.lookup(name) if a not in used)
        if axes and dim % _axis_size(mesh, axes) == 0:
            parts.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            if axes and fallbacks is not None:
                fallbacks.append(f"{name}:{dim}%{_axis_size(mesh, axes)}")
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec: Sequence[Any]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension
    in order, ``Shard(d)`` where tensor dimension ``d`` is sharded over it,
    else ``Replicate()``."""

    out = []
    for name in axis_names(mesh):
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_count(mesh, spec: Sequence[Any]) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    n = 1
    for part in spec:
        if part is not None:
            n *= _axis_size(mesh, part if isinstance(part, tuple) else (part,))
    return n


def _tree_map2(fn, a, b):
    """``fn`` over matching leaves of two trees of dicts, keys in sorted
    order (the reference's flattening order, so fallbacks list alike)."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def shardings_for(
    mesh,
    rules: ShardingRules,
    params: Any,
    axes_tree: Any,
    report: Optional[List[str]] = None,
) -> Any:
    """A :class:`NamedSharding` tree matching ``params`` via its logical
    axes (leaves of the same nested dicts)."""
    return _tree_map2(
        lambda p, a: NamedSharding(mesh, spec_for(mesh, rules, p.shape, a, fallbacks=report)),
        params, axes_tree,
    )


def data_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, extra_dims: int = 1) -> PartitionSpec:
    """Batch-leading arrays: batch over all data-parallel axes."""
    fsdp = data_axes(mesh)
    return P(fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None))


# ---------------------------------------------------------------------------
# activation constraints (the "logical activation axes" mechanism)
# ---------------------------------------------------------------------------
#
# Model code calls ``constrain(x, names)`` at a handful of strategic points
# (KV tensors, MoE dispatch).  Assignment is priority-aware: KV *heads* get
# the "model" axis when divisible; otherwise KV *sequence* takes it
# (context-parallel attention).

_TLS = threading.local()

ACT_RULES: Dict[str, Tuple[Tuple[str, ...], int]] = {
    # name: (mesh axes, priority — lower wins contested axes)
    "act_batch": (("pod", "data"), 0),
    "act_kv_heads": (("model",), 1),
    "act_heads": (("model",), 1),
    "act_experts": (("model",), 1),
    "act_mlp": (("model",), 1),
    # decode-only fallback: shard head_dim when head counts don't divide
    # the TP axis (see inference_rules) — inactive in train mode.
    "act_head_dim": (("model",), 2),
    # KV sequence takes the TP axis when heads can't (context parallelism);
    # with batch=1 (long-context decode) it also absorbs the idle DP axes.
    "act_kv_seq": (("model", "pod", "data"), 3),
    "act_seq": (("pod", "data", "model"), 4),
    "act_vocab": (("model",), 1),
}

_DECODE_ONLY = {"act_head_dim"}


@contextlib.contextmanager
def activation_sharding(mesh, mode: str = "train"):
    """Model code under this context lays its activations out on ``mesh``
    (:func:`constrain`) in ``mode`` ("train" or "decode").  On a
    ``DeviceMesh`` a plain tensor meeting a DTensor counts as replicated
    (``implicit_replication``), as a constant does under GSPMD."""
    prev = getattr(_TLS, "mesh", None)
    prev_mode = getattr(_TLS, "mode", "train")
    _TLS.mesh = mesh
    _TLS.mode = mode
    replicate = contextlib.nullcontext()
    if getattr(mesh, "mesh_dim_names", None) is not None:
        replicate = implicit_replication()
    try:
        with replicate:
            yield
    finally:
        _TLS.mesh = prev
        _TLS.mode = prev_mode


def activation_spec(mesh, shape: Sequence[int], names: Sequence[Optional[str]], mode: str = "train") -> PartitionSpec:
    """The spec :func:`constrain` gives an activation of ``shape`` named
    ``names`` under ``mode``."""
    assert len(names) == len(shape), (names, shape)
    names = [None if (n in _DECODE_ONLY and mode != "decode") else n for n in names]
    order = sorted(
        (i for i, n in enumerate(names) if n is not None),
        key=lambda i: ACT_RULES.get(names[i], ((), 99))[1],
    )
    mesh_names = axis_names(mesh)
    used: set = set()
    parts: List[Any] = [None] * len(shape)
    for i in order:
        axes, _ = ACT_RULES.get(names[i], ((), 99))
        axes = tuple(a for a in axes if a in mesh_names and a not in used)
        if axes and shape[i] % _axis_size(mesh, axes) == 0 and shape[i] > 0:
            parts[i] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
    return P(*parts)


def _is_dtensor(x) -> bool:

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Inside :func:`activation_sharding`, redistribute the DTensor ``x``
    to :func:`activation_spec`'s layout; otherwise return ``x``."""
    mesh = getattr(_TLS, "mesh", None)
    if mesh is None:
        return x
    spec = activation_spec(mesh, tuple(x.shape), names, getattr(_TLS, "mode", "train"))
    if not _is_dtensor(x):
        return x
    want = placements(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def tp_size() -> int:
    mesh = getattr(_TLS, "mesh", None)
    if mesh is None or "model" not in axis_names(mesh):
        return 1
    return axis_sizes(mesh)["model"]


def sharding_mode() -> str:
    return getattr(_TLS, "mode", "train")


def gather_weight(w: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Weight-gather FSDP: pin a (cast) weight to its TP-only layout inside
    the layer body, so the FSDP shards are all-gathered once a layer
    (ZeRO-3) instead of leaving activation-sized partial sums on every
    matmul's contracting dimension."""
    return constrain(w, names)


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table [V, D] whose vocabulary may be
    sharded: each rank looks up the tokens in its slice of the vocabulary
    (zero outside it) and the result is a partial sum over the vocabulary's
    mesh dimensions, the vocab-parallel embedding XLA partitions a gather
    into.  The table's ``embed`` shards are gathered first."""

    mesh = table.device_mesh
    vocab_only = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in table.placements)
    if tuple(table.placements) != vocab_only:
        table = table.redistribute(mesh, vocab_only)
    local = table.to_local()
    # This rank's first vocabulary row: its coordinate on the mesh dims that
    # shard the vocabulary, major to minor, times the local rows.
    coord, pieces = mesh.get_coordinate(), 0
    for i, p in enumerate(table.placements):
        if isinstance(p, Shard):
            pieces = pieces * mesh.size(i) + coord[i]
    offset = pieces * local.shape[0]
    if isinstance(tokens, DTensor):
        tok_pl = tuple(tokens.placements)
        tok = tokens.to_local()
    else:
        tok_pl = tuple(Replicate() for _ in table.placements)
        tok = tokens
    idx = tok.long() - offset
    ok = (idx >= 0) & (idx < local.shape[0])
    rows = local[idx.clamp(0, local.shape[0] - 1)] * ok[..., None].to(local.dtype)
    out_pl = []
    for tp, tk in zip(table.placements, tok_pl, strict=True):
        if isinstance(tp, Shard):
            assert not isinstance(tk, Shard), "tokens and vocabulary sharded on one mesh dimension"
            out_pl.append(Partial())
        else:
            out_pl.append(tk)
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def write_token(cache: torch.Tensor, at: torch.Tensor, new: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> None:
    """``cache[b, at[b]] = new[b]`` in place, for a cache [B, S, ...], the
    positions ``at`` [B] and the entries ``new`` [B, ...] (``rows``, if
    given, is ``arange(B)`` on the cache's device).  On a DTensor
    cache (batch over the data axes, the sequence or the heads over the
    model axis: :func:`repro_torch.launch.steps.cache_shardings`) each rank
    writes the rows it holds where the position falls in its slice of the
    sequence, and leaves the slot as it was elsewhere: the per-shard write
    XLA partitions the reference's ``.at[rows, pos].set`` into."""

    if not isinstance(cache, DTensor):
        if rows is None:
            rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, at.long()] = new
        return
    mesh = cache.device_mesh
    pl = tuple(cache.placements)
    new_pl = tuple(Shard(0) if p == Shard(0) else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
                   else Replicate() for p in pl)
    at_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)

    def local(x, want):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, tuple(Replicate() for _ in pl), run_check=False)
        return (x if tuple(x.placements) == want else x.redistribute(mesh, want)).to_local()

    c, a, n = cache.to_local(), local(at, at_pl).long(), local(new, new_pl)
    coord, pieces = mesh.get_coordinate(), 0
    for i, p in enumerate(pl):
        if p == Shard(1):
            pieces = pieces * mesh.size(i) + coord[i]
    idx = a - pieces * c.shape[1]
    ok = (idx >= 0) & (idx < c.shape[1])
    rows = torch.arange(c.shape[0], device=c.device)
    idx = idx.clamp(0, c.shape[1] - 1)
    keep = ok.reshape(-1, *([1] * (n.dim() - 1)))
    c[rows, idx] = torch.where(keep, n.to(c.dtype), c[rows, idx])


def _dtensors(*xs) -> bool:

    return any(isinstance(x, DTensor) for x in xs)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; on DTensors, a per-shard product.

    Plain tensors take ``torch.einsum`` itself.  For DTensors each mesh
    dimension's layout is resolved by the letters the operands shard there,
    as a partitioner does for one contraction: where one operand shards a
    letter the other also has, the other is sharded alike; where they shard
    different letters, the second operand (the weight, in the model's
    calls) is gathered on that mesh dimension; partial inputs are reduced.
    The letter is then sharded in the output where the output keeps it,
    and leaves a partial sum where it is summed over.  The local shards are then multiplied by one
    ``torch.einsum``.  (DTensor's own einsum merges dimensions into one
    ``bmm``, which lays a sharded inner dimension out as a strided shard
    that its matmul strategies do not take.)"""
    if not _dtensors(a, b):
        return torch.einsum(eq, a, b)

    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    assert "." not in eq, eq
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    repl = tuple(Replicate() for _ in range(mesh.ndim))

    def as_dt(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(x, mesh, repl, run_check=False)

    a, b = as_dt(a), as_dt(b)
    # Partial inputs are reduced first.
    pa = tuple(Replicate() if isinstance(p, Partial) else p for p in a.placements)
    pb = tuple(Replicate() if isinstance(p, Partial) else p for p in b.placements)
    want_a, want_b, out_pl = list(pa), list(pb), []
    for i in range(mesh.ndim):
        xa = la[pa[i].dim] if isinstance(pa[i], Shard) else None
        xb = lb[pb[i].dim] if isinstance(pb[i], Shard) else None
        if xa is not None and xb is not None and xa != xb:
            want_b[i], xb = Replicate(), None
        if xa is None and xb is not None:  # b shards a letter: a follows where it has it
            if xb in la:
                want_a[i] = Shard(la.index(xb))
            xa = xb
        elif xa is not None and xb is None and xa in lb:
            want_b[i] = Shard(lb.index(xa))
        # One letter on this mesh dimension: kept, or summed (a partial sum).
        out_pl.append(Replicate() if xa is None else Shard(out.index(xa)) if xa in out else Partial())
    if tuple(a.placements) != tuple(want_a):
        a = a.redistribute(mesh, tuple(want_a))
    if tuple(b.placements) != tuple(want_b):
        b = b.redistribute(mesh, tuple(want_b))
    # Contiguous, so the declared (contiguous) global strides hold; eager
    # would copy it at the first reshape anyway.
    local = torch.einsum(eq, a.to_local(), b.to_local()).contiguous()
    sizes = dict(zip(la, a.shape, strict=True)) | dict(zip(lb, b.shape, strict=True))
    shape = torch.Size(sizes[c] for c in out)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return DTensor.from_local(local, mesh, tuple(out_pl), run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and a matrix w [K, N]; on DTensors,
    :func:`einsum`'s per-shard product."""
    if not _dtensors(x, w):
        return x @ w
    lead = "abcdefgh"[: x.dim() - 1]
    return einsum(f"{lead}k,kn->{lead}n", x, w)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)``; on DTensors, :func:`einsum`'s per-shard product."""
    if not _dtensors(a, b):
        return torch.bmm(a, b)
    return einsum("eik,ekj->eij", a, b)


def _local_shape(shape: Sequence[int], mesh, pls) -> Tuple[int, ...]:
    """Rank 0's shard shape (DTensor's split: ``ceil(n / pieces)`` first)."""

    out = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return tuple(out)


def sharded_zeros(like: torch.Tensor, sharding: NamedSharding, device) -> torch.Tensor:
    """A zero DTensor of ``like``'s shape and dtype laid out by ``sharding``
    (each rank allocates its shard only)."""

    mesh, pls = sharding.mesh, sharding.placements
    local = torch.zeros(_local_shape(like.shape, mesh, pls), dtype=like.dtype, device=device)
    stride = tuple(torch.empty(like.shape, device="meta").stride())
    return DTensor.from_local(local, mesh, pls, run_check=False, shape=like.shape, stride=stride)


def _to_layout(x: torch.Tensor, mesh, pls) -> torch.Tensor:

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, tuple(Replicate() for _ in pls), run_check=False)
    return x if tuple(x.placements) == tuple(pls) else x.redistribute(mesh, tuple(pls))


def assign(field: torch.Tensor, index: Tuple[int, ...], value: torch.Tensor) -> None:
    """``field[index] = value`` in place, ``index`` integers on leading
    dimensions that no mesh dimension shards (a cache's layer axes).  On a
    DTensor ``value`` is laid out as the slot and copied into the local
    shard."""

    if not isinstance(field, DTensor):
        field[index] = value
        return
    k = len(index)
    pls = tuple(Shard(p.dim - k) if isinstance(p, Shard) else Replicate() for p in field.placements)
    assert all(not isinstance(p, Shard) or p.dim >= k for p in field.placements), field.placements
    field.to_local()[index] = _to_layout(value, field.device_mesh, pls).to_local()


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, :s] = new`` for a cache [B, S, ...] and new [B, s, ...].
    A DTensor cache takes only ``s == S`` (the prefill of a cell at its
    full length), copied shard by shard in the cache's layout."""

    if not isinstance(cache, DTensor):
        cache[:, : new.shape[1]] = new
        return
    if new.shape[1] != cache.shape[1]:
        raise NotImplementedError("a sharded cache is filled at its whole length")
    cache.to_local().copy_(_to_layout(new, cache.device_mesh, cache.placements).to_local())


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx[..., None])[..., 0]`` for a DTensor ``x`` [..., V]
    whose last dimension may be sharded (vocab-parallel logits): each rank
    picks the entries in its slice (zero elsewhere), a partial sum over the
    mesh dimensions that shard V, as :func:`sharded_embed` looks rows up."""

    mesh = x.device_mesh
    last = x.dim() - 1
    pls = tuple(Replicate() if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim != last and p.dim != 0)
                else p for p in x.placements)
    if pls != tuple(x.placements):
        x = x.redistribute(mesh, pls)
    idx_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pls)
    local = x.to_local()
    ids = _to_layout(idx, mesh, idx_pl).to_local().long()
    coord, pieces = mesh.get_coordinate(), 0
    for i, p in enumerate(pls):
        if p == Shard(last):
            pieces = pieces * mesh.size(i) + coord[i]
    ids = ids - pieces * local.shape[-1]
    ok = (ids >= 0) & (ids < local.shape[-1])
    got = local.gather(-1, ids.clamp(0, local.shape[-1] - 1)[..., None])[..., 0] * ok.to(local.dtype)
    out_pl = tuple(Partial() if p == Shard(last) else p for p in pls)
    return DTensor.from_local(got, mesh, out_pl, run_check=False, shape=x.shape[:-1],
                              stride=tuple(torch.empty(x.shape[:-1], device="meta").stride()))


def write_slots(pool: torch.Tensor, index: tuple, value: torch.Tensor) -> None:
    """``pool[index] = value`` in place, ``index`` covering the pool's
    leading dimensions with one batch of integer tensors among them (a
    paged pool's ``(block, layer, k/v, slot)``): ``value`` is [b, *the
    pool's trailing dims].  On a DTensor pool (no mesh dimension sharding
    the indexed dims) ``value`` is laid out as the trailing dims and each
    rank writes its shard."""

    if not isinstance(pool, DTensor):
        pool[index] = value
        return
    k = len(index)
    assert all(not isinstance(p, Shard) or p.dim >= k for p in pool.placements), pool.placements
    pls = tuple(Shard(p.dim - k + 1) if isinstance(p, Shard) else Replicate() for p in pool.placements)
    local_index = tuple(i.to_local() if isinstance(i, DTensor) else i for i in index)
    pool.to_local()[local_index] = _to_layout(value, pool.device_mesh, pls).to_local()
