"""unchecked-oom: allocation can fail silently; reads must gate on it.

The pool's exhaustion signal is *sticky and device-side* (DESIGN.md §4;
the port's ``strict_oom`` stores raise on the host instead, through
``store._check_oom``): ``pool.alloc`` under pressure does not raise — it
sets ``oom_flag`` and returns a pool whose new ids point at the dump
row.  Every subsequent read of those trajectories is garbage that
*looks* like data.  Any function that allocates and then materializes
results must consult the flag (``oom_flag`` / ``strict_oom`` /
``_check_oom`` / ``free_blocks`` / an invariant check) somewhere on the
path, or it will happily return dump-row payload under memory pressure.

The rule is deliberately function-coarse: an alloc-class call followed
(in source order) by a read-class call, with *no* reference to any OOM
signal anywhere in the function, is flagged at the read site.  One
mention of the flag anywhere in the function clears it — checking is a
per-function discipline, not a per-statement one, and a finer-grained
path analysis would drown real findings in false positives from helper
indirection.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from repro_torch.analysis import apis
from repro_torch.analysis.dataflow import (
    SCOPE_NODES,
    scopes,
    split_call,
    walk_same_statement,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule

_KNOWN_QUALS = apis.POOL_QUALS | apis.STORE_QUALS | apis.KV_QUALS


def _mentions_oom_signal(scope_node: ast.AST) -> bool:
    """OOM signal referenced anywhere in the function, nested defs
    included — a nested checker still counts as discipline."""
    for n in ast.walk(scope_node):
        if isinstance(n, ast.Attribute) and n.attr in apis.OOM_SIGNALS:
            return True
        if isinstance(n, ast.Name) and n.id in apis.OOM_SIGNALS:
            return True
    return False


def _layer_calls(scope) -> List[Tuple[int, str, ast.Call]]:
    """``(line, terminal, call)`` for pool/store/kv-qualified calls in
    this scope only (nested functions are their own scopes)."""
    out: List[Tuple[int, str, ast.Call]] = []
    for stmt in scope.body:
        if isinstance(stmt, SCOPE_NODES):
            continue  # nested defs are their own scopes
        for node in walk_same_statement(stmt):
            # descend into this scope's compound statements but not into
            # nested defs (walk_same_statement stops at scope nodes; the
            # engine-visible suites are reached via stmt recursion below)
            if isinstance(node, ast.Call):
                qual, term = split_call(node)
                if qual in _KNOWN_QUALS or not qual:
                    out.append((node.lineno, term, node))
    # compound statements: walk_same_statement covers headers and bodies
    # alike because suites are child nodes of the statement
    return sorted(out, key=lambda t: t[0])


class UncheckedOom(Rule):
    name = "unchecked-oom"
    description = (
        "results read after an alloc-class call with no oom_flag / "
        "strict_oom consultation anywhere in the function"
    )

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        for scope in scopes(tree):
            if not scope.is_function:
                continue  # module-level scripts check at their own pace
            if _mentions_oom_signal(scope.node):
                continue
            calls = _layer_calls(scope)
            alloc: Optional[Tuple[int, str]] = next(
                (
                    (line, term)
                    for line, term, _ in calls
                    if term in apis.ALLOC_APIS
                ),
                None,
            )
            if alloc is None:
                continue
            alloc_line, alloc_term = alloc
            for line, term, call in calls:
                if term in apis.READ_APIS and line > alloc_line:
                    yield self.finding(
                        ctx,
                        call,
                        f"{term!r} reads results after {alloc_term!r} "
                        f"(line {alloc_line}) but {scope.name!r} never "
                        "consults oom_flag/strict_oom: under pool "
                        "exhaustion this returns dump-row garbage that "
                        "looks like data",
                    )
                    break  # one finding per function is enough signal
