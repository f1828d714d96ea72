"""stale-remap: ids/tables captured across grow/compact must be refreshed.

``pool.compact`` relocates live blocks and returns ``(pool, remap)``;
every block table captured *before* the call holds pre-relocation ids
and must be rewritten through ``pool.remap_tables`` (store/kv ``compact``
do this internally — which is why only the pool-layer form returns the
remap to the caller).  ``grow`` preserves ids but changes array shapes,
so payload views (``.data`` / ``.free_stack``) captured before a grow
alias the *old* arrays.

Three findings:

1. the remap returned by a pool-layer ``compact`` is discarded (bound to
   ``_`` or never read) — tables cannot have been rewritten;
2. a name bound from ``<state>.tables`` before a ``compact`` is read
   after it without passing through ``remap_tables``;
3. a name bound from ``<pool>.data`` / ``<pool>.free_stack`` before a
   ``grow`` is read after it (stale shape/alias).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List

from repro_torch.analysis import apis
from repro_torch.analysis.dataflow import (
    State,
    bound_names,
    calls_in,
    reads_in,
    run_flow,
    scopes,
    split_call,
    walk_same_statement,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule

_GROW_STALE_ATTRS = {"data", "free_stack"}


def _binds_attr(stmt: ast.stmt, attrs: set) -> Dict[str, int]:
    """``{name: line}`` for ``name = <expr>.attr`` / ``<expr>.attr[...]``."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return {}
    target = stmt.targets[0]
    if not isinstance(target, ast.Name):
        return {}
    value = stmt.value
    if isinstance(value, ast.Subscript):
        value = value.value
    if isinstance(value, ast.Attribute) and value.attr in attrs:
        return {target.id: stmt.lineno}
    return {}


class StaleRemap(Rule):
    name = "stale-remap"
    description = (
        "tables/ids or pool views held across grow/compact without "
        "applying the returned remap"
    )

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        found: List[Finding] = []
        if "compact" not in ctx.source and "grow" not in ctx.source:
            return  # no lifecycle call: nothing can go stale

        for scope in scopes(tree):
            # -- finding 1: discarded remap (scope-level read analysis) --
            reads_by_line = [
                (n.lineno, n.id)
                for stmt in scope.body
                for n in ast.walk(stmt)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            ]
            for stmt in ast.walk(scope.node):
                if not isinstance(stmt, ast.Assign):
                    continue
                call = stmt.value
                if not isinstance(call, ast.Call) or not apis.is_pool_compact(call):
                    continue
                elts = None
                for t in stmt.targets:
                    if isinstance(t, (ast.Tuple, ast.List)) and len(t.elts) == 2:
                        elts = t.elts
                if elts is None:
                    continue
                remap_t = elts[1]
                if not isinstance(remap_t, ast.Name):
                    continue
                if remap_t.id == "_":
                    found.append(
                        self.finding(
                            ctx,
                            call,
                            "remap returned by pool compact bound to '_': "
                            "every table captured before the compact now "
                            "holds stale ids — apply pool.remap_tables",
                        )
                    )
                elif not any(
                    line > stmt.lineno and name == remap_t.id
                    for line, name in reads_by_line
                ):
                    found.append(
                        self.finding(
                            ctx,
                            call,
                            f"remap {remap_t.id!r} returned by pool compact "
                            "is never read: tables were not rewritten "
                            "through pool.remap_tables",
                        )
                    )

            # -- findings 2+3: captures held across the lifecycle call --
            def visit(stmt: ast.stmt, state: State) -> None:
                tables = state["tables"]  # name -> bind line
                views = state["views"]  # name -> bind line
                # reads of stale captures (before updating capture maps)
                if state["compact_line"] is not None:
                    remapped = _names_fed_to_remap_tables(stmt)
                    for n in reads_in(stmt):
                        if (
                            n.id in tables
                            and tables[n.id] < state["compact_line"]
                            and n.id not in remapped
                        ):
                            found.append(
                                self.finding(
                                    ctx,
                                    n,
                                    f"{n.id!r} captured from .tables at line "
                                    f"{tables[n.id]} is read after the "
                                    f"compact at line {state['compact_line']}"
                                    " without applying the remap",
                                )
                            )
                            tables.pop(n.id, None)  # report once per name
                if state["grow_line"] is not None:
                    for n in reads_in(stmt):
                        if n.id in views and views[n.id] < state["grow_line"]:
                            found.append(
                                self.finding(
                                    ctx,
                                    n,
                                    f"{n.id!r} captured from the pool at line "
                                    f"{views[n.id]} aliases pre-grow arrays "
                                    f"(grow at line {state['grow_line']} "
                                    "changed shapes) — re-read it from the "
                                    "grown pool",
                                )
                            )
                            views.pop(n.id, None)
                for t in bound_names(stmt):
                    tables.pop(t, None)
                    views.pop(t, None)
                tables.update(_binds_attr(stmt, {"tables"}))
                views.update(_binds_attr(stmt, _GROW_STALE_ATTRS))
                for call in calls_in(stmt):
                    if apis.is_any_compact(call):
                        state["compact_line"] = call.lineno
                    if apis.is_any_grow(call):
                        state["grow_line"] = call.lineno

            def copy(state: State) -> State:
                return {
                    "tables": dict(state["tables"]),
                    "views": dict(state["views"]),
                    "compact_line": state["compact_line"],
                    "grow_line": state["grow_line"],
                }

            def merge(states: List[State]) -> State:
                out: State = {
                    "tables": {},
                    "views": {},
                    "compact_line": None,
                    "grow_line": None,
                }
                for s in states:
                    out["tables"].update(s["tables"])
                    out["views"].update(s["views"])
                    for k in ("compact_line", "grow_line"):
                        if s[k] is not None:
                            out[k] = s[k] if out[k] is None else max(out[k], s[k])
                return out

            run_flow(
                scope.body,
                {"tables": {}, "views": {}, "compact_line": None, "grow_line": None},
                visit,
                copy,
                merge,
            )
        yield from found


def _names_fed_to_remap_tables(stmt: ast.stmt) -> set:
    """Names passed to ``remap_tables`` in this statement (refresh site)."""
    out = set()
    for call in calls_in(stmt):
        _, term = split_call(call)
        if term == "remap_tables":
            for a in call.args:
                for n in walk_same_statement(a):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out
