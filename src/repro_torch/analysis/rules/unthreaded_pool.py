"""unthreaded-pool: every pool/store/cache API returns the successor state.

The platform is functional (DESIGN.md §2), and the port keeps it so for
its bookkeeping (``serving/kv_cache.py``: only the payload is written in
place): ``pool.alloc`` does not mutate — it returns the *next* pool, and
the caller must thread it.  Two
ways to get this wrong, both silent at runtime until refcounts drift:

1. **discarded result** — calling a threading API as a bare expression
   statement (or assigning it to ``_``): the returned state is lost, the
   old binding keeps stale refcounts/free-stack;
2. **stale binding** — rebinding the successor to a *different* name and
   then passing the superseded name to another threading call: the
   second call operates on pre-update bookkeeping, losing the first
   update (the classic lost-update race, single-threaded edition).

Checkpoint/rollback code that deliberately holds an old state is fine as
long as the old binding is not *passed back into the API* — only that
re-entry is flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from repro_torch.analysis import apis
from repro_torch.analysis.dataflow import (
    State,
    bound_names,
    calls_in,
    run_flow,
    scopes,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule


class UnthreadedPool(Rule):
    name = "unthreaded-pool"
    description = (
        "result of a pool/store/cache threading API discarded, or a "
        "superseded state binding passed back into the API"
    )

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        found: List[Finding] = []

        def visit(stmt: ast.stmt, state: State) -> None:
            consumed = state["consumed"]  # name -> line it was superseded at
            targets = set(bound_names(stmt))
            discarded = isinstance(stmt, ast.Expr) or (
                isinstance(stmt, ast.Assign) and targets == {"_"}
            )
            for call in calls_in(stmt):
                hit = apis.threading_api(call)
                if hit is None:
                    continue
                term, _ = hit
                sname = apis.state_arg_name(call)
                if sname is not None and sname in consumed:
                    found.append(
                        self.finding(
                            ctx,
                            call,
                            f"stale state binding {sname!r} passed to "
                            f"{term!r}: it was superseded at line "
                            f"{consumed[sname]} — thread the returned "
                            "state instead",
                        )
                    )
                if discarded and stmt.value is call:
                    found.append(
                        self.finding(
                            ctx,
                            call,
                            f"result of {term!r} discarded: the API is "
                            "functional — bind and thread the returned "
                            "state",
                        )
                    )
                elif sname is not None and not discarded:
                    if sname in targets:
                        consumed.pop(sname, None)
                    elif targets:
                        # successor went to a different name: the input
                        # binding is now superseded
                        consumed.setdefault(sname, call.lineno)
            # any rebinding refreshes a name
            if isinstance(
                stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For, ast.With)
            ):
                for t in targets:
                    consumed.pop(t, None)

        def copy(state: State) -> State:
            return {"consumed": dict(state["consumed"])}

        def merge(states: List[State]) -> State:
            out: State = {"consumed": {}}
            for s in states:
                for k, v in s["consumed"].items():
                    prev = out["consumed"].get(k)
                    out["consumed"][k] = min(prev, v) if prev is not None else v
            return out

        for scope in scopes(tree):
            run_flow(scope.body, {"consumed": {}}, visit, copy, merge)
        yield from found
