"""The contract surface: which calls thread state, allocate, read, remap,
and which consume their argument in place.

The port's contract table, taken from its own modules.  One table per
platform layer, keyed by the call's *terminal* name and disambiguated by
its *qualifier* (the dotted segment before the terminal), following the
import idiom the port keeps from the reference:

    from repro_torch.core import pool as pool_lib      # pool_lib.alloc(...)
    from repro_torch.core import store as store_lib    # store_lib.clone(cfg, st, a)
    from repro_torch.serving import kv_cache as kvc    # kvc.fork(cache, anc)

Each entry maps a terminal to ``(index, parameter)``: the positional
index of the *threaded state* argument (the pool / store / cache that
the call consumes and returns a successor of) and that parameter's name
in the port's signature.  Bare-name calls (``from ... import alloc``)
match only when the terminal is unambiguous across layers.

:data:`CONSUMERS` is the table of ``use-after-consume``: calls that write
into an argument in place where the reference's jitted step donates it.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, Optional, Set, Tuple

from repro_torch.analysis.dataflow import split_call

#: qualifier aliases per layer
POOL_QUALS: Set[str] = {"pool", "pool_lib", "blockpool"}
STORE_QUALS: Set[str] = {"store", "store_lib"}
KV_QUALS: Set[str] = {"kv", "kvc", "kv_cache"}

#: the module that defines each layer's APIs
POOL_MODULE = "repro_torch.core.pool"
STORE_MODULE = "repro_torch.core.store"
KV_MODULE = "repro_torch.serving.kv_cache"

#: terminal -> (index, name) of the threaded-state argument
POOL_APIS: Dict[str, Tuple[int, str]] = {
    "alloc": (0, "pool"),
    "alloc_scan": (0, "pool"),
    "alloc_compact": (0, "pool"),
    "add_refs": (0, "pool"),
    "sub_refs": (0, "pool"),
    "release_parents": (0, "pool"),
    "freeze": (0, "pool"),
    "write_blocks": (0, "pool"),
    "grow": (0, "pool"),
    "compact": (0, "pool"),
    "rebuild_free_stack": (0, "pool"),
    # threads the free stack (returns the successor ``(stack, top)``)
    "push_free_mask": (0, "stack"),
}
STORE_APIS: Dict[str, Tuple[int, str]] = {
    "append": (1, "store"),
    "write_at": (1, "store"),
    "clone": (1, "store"),
    "clone_partial": (1, "store"),
    "clone_chain": (1, "store"),
    "import_trajectories": (1, "store"),
    "grow": (1, "store"),
    "compact": (1, "store"),
}
KV_APIS: Dict[str, Tuple[int, str]] = {
    "fork": (0, "cache"),
    "advance": (0, "cache"),
    "free": (0, "cache"),
    "grow": (0, "cache"),
    "compact": (0, "cache"),
    "ensure_writable": (1, "cache"),
    "write_kv": (1, "cache"),
}

#: bare-name fallback: terminals whose state position is the same in
#: every layer that defines them (grow/compact are ambiguous -> absent;
#: clone_chain is also the kernel's entry point -> absent)
BARE_APIS: Dict[str, int] = {
    "alloc": 0,
    "alloc_scan": 0,
    "alloc_compact": 0,
    "add_refs": 0,
    "sub_refs": 0,
    "release_parents": 0,
    "freeze": 0,
    "write_blocks": 0,
    "push_free_mask": 0,
    "rebuild_free_stack": 0,
    "append": 1,
    "write_at": 1,
    "clone": 1,
    "clone_partial": 1,
    "import_trajectories": 1,
    "fork": 0,
    "ensure_writable": 1,
}

#: calls that can exhaust the pool (the oom-flag producers)
ALLOC_APIS: Set[str] = {
    "alloc",
    "alloc_scan",
    "alloc_compact",
    "append",
    "write_at",
    "import_trajectories",
    "ensure_writable",
}
#: calls that read payload out of the pool (corrupt once oom is sticky)
READ_APIS: Set[str] = {
    "trajectory",
    "materialize",
    "materialize_batch",
    "read_at",
    "read_last",
    "read_blocks",
}
#: any reference to these counts as consulting the exhaustion signal:
#: the pool's ``oom`` leaf, ``store.oom_flag`` / ``kvc.oom_flag``, the
#: store's ``strict_oom`` and its ``_check_oom``, the headroom reads
#: (``store.free_blocks``, ``kvc.free_blocks``, ``pool.blocks_free``),
#: ``pool.check_invariants`` and the executor's ``ensure``
OOM_SIGNALS: Set[str] = {
    "oom",
    "oom_flag",
    "strict_oom",
    "_check_oom",
    "free_blocks",
    "blocks_free",
    "check_invariants",
    "ensure",
}

_LAYERS = (
    (POOL_QUALS, POOL_APIS),
    (STORE_QUALS, STORE_APIS),
    (KV_QUALS, KV_APIS),
)


def threading_api(call: ast.Call) -> Optional[Tuple[str, int]]:
    """``(terminal, state_arg_index)`` when ``call`` is a recognized
    state-threading API of any layer, else ``None``."""
    qual, term = split_call(call)
    for quals, table in _LAYERS:
        if qual in quals and term in table:
            return term, table[term][0]
    if not qual and term in BARE_APIS:
        return term, BARE_APIS[term]
    return None


def state_arg_name(call: ast.Call) -> Optional[str]:
    """Plain-``Name`` threaded-state argument of a threading call."""
    hit = threading_api(call)
    if hit is None:
        return None
    _, idx = hit
    if idx < len(call.args) and isinstance(call.args[idx], ast.Name):
        return call.args[idx].id
    return None


def is_pool_compact(call: ast.Call) -> bool:
    """A ``compact`` whose caller receives ``(pool, remap)`` — the
    pool-layer form (store/kv compact apply the remap internally)."""
    qual, term = split_call(call)
    return term == "compact" and qual in POOL_QUALS


def is_any_compact(call: ast.Call) -> bool:
    qual, term = split_call(call)
    return term == "compact" and (
        qual in POOL_QUALS | STORE_QUALS | KV_QUALS or not qual
    )


def is_any_grow(call: ast.Call) -> bool:
    qual, term = split_call(call)
    return term == "grow" and (
        qual in POOL_QUALS | STORE_QUALS | KV_QUALS or not qual
    )


# ---------------------------------------------------------------------------
# use-after-consume: calls that write into an argument in place
# ---------------------------------------------------------------------------

#: qualifier wildcard: any receiver (the call is a method, ``lm.decode_step``)
ANY_QUAL: FrozenSet[str] = frozenset({"*"})


@dataclasses.dataclass(frozen=True)
class Consumer:
    """A call that writes into its argument at ``index`` (``param`` in
    ``module.func``'s signature, ``self`` not counted) and returns the
    successor state."""

    quals: FrozenSet[str]
    term: str
    index: int
    param: str
    module: str
    func: str

    def matches(self, qual: str, term: str) -> bool:
        if term != self.term:
            return False
        return bool(qual) if self.quals == ANY_QUAL else qual in self.quals


CONSUMERS: Tuple[Consumer, ...] = (
    # writes the new token's K/V, ring slots and SSM states into the cache
    Consumer(ANY_QUAL, "decode_step", 2, "cache", "repro_torch.models.model", "LanguageModel.decode_step"),
    # the paged engine's functional core: prefill pages and decode tokens
    # are written into ``cache.pool.data``
    Consumer(frozenset({"", "engine", "engine_lib"}), "_prefill", 3, "cache", "repro_torch.serving.engine", "_prefill"),
    Consumer(frozenset({"", "engine", "engine_lib"}), "_decode_step", 3, "cache", "repro_torch.serving.engine", "_decode_step"),
    # the COW kernels write ``data`` in place (the TPU kernel's aliased output)
    Consumer(frozenset({"", "ops", "cow_write", "cow_ops"}), "cow_write", 0, "data", "repro_torch.kernels.cow_write.ops", "cow_write"),
    Consumer(frozenset({"", "ops", "cow_write", "cow_ops"}), "cow_write_delta", 0, "data", "repro_torch.kernels.cow_write.ops", "cow_write_delta"),
    # the COW copy and each layer's K/V go into the pool's payload in place
    Consumer(frozenset({"", *KV_QUALS}), "ensure_writable", 1, "cache", KV_MODULE, "ensure_writable"),
    Consumer(frozenset({"", *KV_QUALS}), "write_kv", 1, "cache", KV_MODULE, "write_kv"),
    # the payload and the block tables are written in place
    Consumer(frozenset({"", *STORE_QUALS}), "append", 1, "store", STORE_MODULE, "append"),
    Consumer(frozenset({"", *STORE_QUALS}), "write_at", 1, "store", STORE_MODULE, "write_at"),
)

#: trailing-underscore methods that change no tensor's values
NON_WRITING_INPLACE: Set[str] = {"requires_grad_", "share_memory_"}

#: calls whose result shares storage with their receiver (or first
#: argument): reading the result reads what an in-place write left there.
#: ``.to(...)`` is one unless ``copy=True``; ``.cpu()`` is the tensor
#: itself on the CPU.
ALIAS_CALLS: Set[str] = {
    "detach",
    "view",
    "view_as",
    "cpu",
    "numpy",
    "to",
    "expand",
    "expand_as",
    "unsqueeze",
    "squeeze",
    "transpose",
    "permute",
    "narrow",
    "select",
}
#: calls that return an independent copy: they end an alias
SNAPSHOT_CALLS: Set[Tuple[str, str]] = {
    ("*", "clone"),  # x.clone(), torch.clone(x)
    ("copy", "deepcopy"),
    ("executor_lib", "snapshot"),  # repro_torch.smc.executor.snapshot
    ("rnd", "snapshot"),  # repro_torch.random.snapshot
}


def consumer(call: ast.Call) -> Optional[Consumer]:
    """The :data:`CONSUMERS` entry ``call`` matches, else ``None``."""
    qual, term = split_call(call)
    for c in CONSUMERS:
        if c.matches(qual, term):
            return c
    return None


def is_inplace_method(call: ast.Call) -> bool:
    """``x.add_(...)``-shaped: a trailing-underscore method of torch's
    in-place convention (``copy_``, ``index_put_``, ``zero_``, ...)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    term = call.func.attr
    return (
        term.endswith("_")
        and not term.startswith("_")
        and not term.endswith("__")
        and term not in NON_WRITING_INPLACE
    )


def is_snapshot(call: ast.Call) -> bool:
    qual, term = split_call(call)
    return (qual, term) in SNAPSHOT_CALLS or ("*", term) in SNAPSHOT_CALLS


def contracts() -> Iterator[Tuple[str, str, int, str]]:
    """``(module, function, index, parameter)`` for every entry of the
    tables above: what the port's signatures must keep."""
    for module, table in (
        (POOL_MODULE, POOL_APIS),
        (STORE_MODULE, STORE_APIS),
        (KV_MODULE, KV_APIS),
    ):
        for term, (idx, param) in table.items():
            yield module, term, idx, param
    for c in CONSUMERS:
        yield c.module, c.func, c.index, c.param
