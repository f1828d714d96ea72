"""Per-rank costs of a traced step: FLOPs, HBM bytes and collective
traffic (the counterpart of ``repro.distributed.hlo``, which parses XLA's
partitioned per-device HLO; no HLO exists here).

:func:`trace_per_rank` traces a step with ``make_fx(tracing_mode="fake")``
over rank 0's local shards: each argument is a fake tensor of its local
shape, wrapped into a DTensor of its layout inside the traced function,
and the outputs are unwrapped again.  With ``card=True`` (the default)
the trace runs under :func:`repro_torch.kernels.dispatch.card_trace`, so
the card's program is traced, kernels included, on a host without one.
The graph then holds rank 0's local ``aten`` ops, the model-path kernels
as the custom ops of :mod:`repro_torch.kernels._library`, and the
``_c10d_functional`` collectives DTensor inserts where a layout changes:
the counterpart of XLA's SPMD-partitioned per-device module.  Under a
fake process group (:func:`repro_torch.launch.mesh.fake_group`) the
production mesh of 256 or 512 ranks lives in one process.

:func:`graph_costs` walks that graph and returns the reference's keys:

  * ``flops``: every op with a ``torch.utils.flop_counter`` formula
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` and the
    custom ops' own formulas); ``matmul_flops`` and ``kernel_flops``
    split them;
  * ``bytes``: each non-view op reads its operands and writes its
    result, eager's granularity, as ``hlo.py`` uses XLA's fusions
    (fused internals free); views, ``getitem``, placeholders and
    ``wait_tensor`` are free;
  * ``collective_bytes`` and ``collective_breakdown`` by kind
    (all-gather, reduce-scatter, all-reduce, all-to-all,
    collective-permute), counted by *operand* bytes as ``hlo.py`` does.

The port's layer loops are Python loops, so every layer is unrolled in
the graph: no loop trip counts are needed (``hlo.py``'s multiplicities
are 1 here).
"""

from __future__ import annotations

import contextlib
import operator
from collections import defaultdict
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["COLLECTIVE_KINDS", "graph_costs", "local_fake", "trace_per_rank", "traced_costs"]

COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
    "broadcast": "collective-permute",
}

#: Ops that move no bytes: metadata, allocation, the collectives' waits.
FREE_OPS = {
    "wait_tensor", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "sym_size", "sym_stride", "sym_numel", "_local_scalar_dense", "lift_fresh_copy", "detach", "alias",
    "_to_copy_meta",
}

MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_scaled_mm"}


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for node in tree for x in _leaves(node)]
    return [tree]


def _unflatten(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(x, it) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, it) for x in tree)
    return next(it)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def local_fake(mode, mesh, t: torch.Tensor, sharding) -> torch.Tensor:
    """A fake tensor of rank 0's local shard of ``t`` under ``sharding``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = tuple(t.shape)
    if sharding is not None and mesh is not None:
        shape = tuple(compute_local_shape_and_global_offset(t.shape, mesh, sharding.placements)[0])
    with mode:
        return torch.empty(shape, dtype=t.dtype, device="cpu")


def trace_per_rank(
    fn: Callable,
    args: Tuple[Any, ...],
    shardings: Tuple[Any, ...],
    mesh,
    *,
    mode: str = "train",
    card: bool = True,
) -> Tuple[torch.fx.GraphModule, list]:
    """``fn(*args)``'s per-rank graph on ``mesh``: ``args`` are ``meta``
    (or any) tensors of the global shapes in trees, ``shardings`` the
    matching trees of :class:`~repro_torch.distributed.sharding.NamedSharding`
    (``None``: replicated).  With ``mesh=None`` the one-card program: plain
    fake tensors of the whole shapes, no DTensor.  Returns the graph and
    the fake inputs it was traced on."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.dispatch import card_trace

    flat = _leaves(args)
    flat_sh = _leaves(shardings) if shardings is not None else [None] * len(flat)
    assert len(flat) == len(flat_sh), (len(flat), len(flat_sh))
    fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
    fakes = [local_fake(fake_mode, mesh, t, s) for t, s in zip(flat, flat_sh, strict=True)]
    if mesh is None:
        def one_card(*local):
            with card_trace() if card else contextlib.nullcontext():
                out = fn(*_unflatten(args, iter(local)))
            return [x for x in _leaves(out) if isinstance(x, torch.Tensor)]

        return make_fx(one_card, tracing_mode="fake")(*fakes), fakes
    repl = tuple(Replicate() for _ in shd.axis_names(mesh))

    def per_rank(*local):
        wrapped = [
            DTensor.from_local(x, mesh, s.placements if s is not None else repl, run_check=False,
                               shape=t.shape, stride=_contiguous_stride(t.shape))
            for x, t, s in zip(local, flat, flat_sh, strict=True)
        ]
        rebuilt = _unflatten(args, iter(wrapped))
        with shd.activation_sharding(mesh, mode=mode), implicit_replication(), \
                (card_trace() if card else contextlib.nullcontext()):
            out = fn(*rebuilt)
        return [x.to_local() if isinstance(x, DTensor) else x
                for x in _leaves(out) if isinstance(x, torch.Tensor)]

    gm = make_fx(per_rank, tracing_mode="fake")(*fakes)
    return gm, fakes


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else node


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (tuple, list)):
        return sum(_nbytes(x) for x in v)
    return 0


def _arg_vals(args) -> list:
    return [[_val(x) for x in a] if isinstance(a, (list, tuple)) else _val(a) for a in args]


def graph_costs(gm: torch.fx.GraphModule) -> Dict[str, Any]:
    """Walk a per-rank graph: ``flops`` (``matmul_flops`` + ``kernel_flops``
    + any other op with a formula), ``bytes``, ``collective_bytes`` and
    ``collective_breakdown``, and ``nodes``."""
    from torch.utils.flop_counter import flop_registry

    flops = matmul = kernel = 0
    bytes_accessed = 0
    coll: Dict[str, int] = defaultdict(int)
    n = 0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        n += 1
        target = node.target
        if target is operator.getitem or not isinstance(target, torch._ops.OpOverload):
            continue
        packet = target.overloadpacket
        name = packet.__name__
        ns = target.namespace
        args = _arg_vals(node.args)
        kwargs = {k: _val(v) for k, v in node.kwargs.items()}
        out = node.meta.get("val")
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            flops += f
            if ns == "repro_torch":
                kernel += f
            elif name in MATMUL_OPS:
                matmul += f
        if ns == "_c10d_functional":
            if name in COLLECTIVE_KINDS:
                nb = _nbytes(args[0])
                coll[COLLECTIVE_KINDS[name]] += nb
                bytes_accessed += nb + _nbytes(out)
            continue
        if target.is_view or name in FREE_OPS:
            continue
        bytes_accessed += _nbytes(args) + _nbytes(list(kwargs.values())) + _nbytes(out)
    return {
        "flops": flops,
        "matmul_flops": matmul,
        "kernel_flops": kernel,
        "bytes": bytes_accessed,
        "collective_bytes": sum(coll.values()),
        "collective_breakdown": dict(coll),
        "nodes": n,
    }


def traced_costs(fn: Callable, args, shardings, mesh, *, mode: str = "train",
                 card: bool = True) -> Dict[str, Any]:
    """:func:`graph_costs` of :func:`trace_per_rank`'s graph with its dead
    code dropped (what XLA's DCE drops: ops whose results nothing reads,
    an unreturned metric, say; in-place writes stay)."""
    gm, _ = trace_per_rank(fn, args, shardings, mesh, mode=mode, card=card)
    gm.graph.eliminate_dead_code()
    return graph_costs(gm)
