"""Shared AST plumbing for the torch-lint rules (the port's copy of
``repro.analysis.dataflow``, kept in step with it).

Three layers, all stdlib-``ast``:

* **name resolution** — :func:`dotted` flattens ``a.b.c`` chains so rules
  can match calls by qualifier + terminal (``pool_lib.alloc`` and
  ``repro_torch.core.pool.alloc`` both resolve to qualifier ``pool``/
  ``pool_lib``, terminal ``alloc``);
* **scopes** — :func:`scopes` yields the module body and every function
  body as independent analysis units (nested functions become their own
  scopes and are *not* re-visited inline, so closure-captured state never
  double-reports);
* **flow driver** — :func:`run_flow` walks a statement list in source
  order with branch forking: ``if``/``try``/``match`` arms each get a
  copy of the inbound state and the arm states are merged afterwards
  (per-rule ``merge`` semantics), loops run twice so loop-carried
  staleness is seen (the engine dedupes the repeated findings), and a
  ``return``/``raise``/``continue``/``break`` terminates its arm so dead
  branches cannot poison the join.
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

#: Statement types that introduce a new scope — their bodies are analyzed
#: as separate units by :func:`scopes`, never inline.
SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
#: Expression types whose bodies are skipped when collecting reads
#: (deferred execution: the read does not happen at this statement).
DEFERRED_NODES = (ast.Lambda, ast.GeneratorExp)


def dotted(node: ast.AST) -> str:
    """``Name``/``Attribute`` chain as ``"a.b.c"`` (empty if not a chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    """Dotted name of the called object (empty for computed callees)."""
    return dotted(call.func)


def split_call(call: ast.Call) -> Tuple[str, str]:
    """``(qualifier, terminal)`` of a call: the last two dotted segments.

    ``pool_lib.alloc(...)`` -> ``("pool_lib", "alloc")``;
    ``repro_torch.core.pool.alloc(...)`` -> ``("pool", "alloc")``;
    ``alloc(...)`` -> ``("", "alloc")``.
    """
    name = call_name(call)
    if not name:
        return "", ""
    parts = name.split(".")
    if len(parts) == 1:
        return "", parts[0]
    return parts[-2], parts[-1]


class Scope:
    """One analysis unit: the module body or one function body."""

    def __init__(self, node: ast.AST, qualname: str):
        self.node = node
        self.qualname = qualname
        self.body: List[ast.stmt] = list(getattr(node, "body", []))

    @property
    def is_function(self) -> bool:
        return isinstance(self.node, (ast.FunctionDef, ast.AsyncFunctionDef))

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<module>")

    @property
    def decorators(self) -> List[ast.expr]:
        return list(getattr(self.node, "decorator_list", []))

    def params(self) -> List[str]:
        if not self.is_function:
            return []
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names


def scopes(tree: ast.Module) -> Iterator[Scope]:
    """Module scope followed by every (possibly nested) function scope."""
    yield Scope(tree, "<module>")

    def rec(node: ast.AST, prefix: str) -> Iterator[Scope]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield Scope(child, qual)
                yield from rec(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def attach_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """Child -> parent map for ancestry queries (loops, enclosing defs)."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def ancestors(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> Iterator[ast.AST]:
    while node in parents:
        node = parents[node]
        yield node


def walk_same_statement(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` restricted to this statement: nested scopes and
    deferred expressions (lambdas, genexps) are not descended into."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, SCOPE_NODES + DEFERRED_NODES):
                continue
            stack.append(child)


def reads_in(node: ast.AST) -> List[ast.Name]:
    """``Name`` loads executed by this statement (same-statement walk)."""
    return [
        n
        for n in walk_same_statement(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    ]


def calls_in(node: ast.AST) -> List[ast.Call]:
    """Calls executed by this statement (same-statement walk)."""
    return [n for n in walk_same_statement(node) if isinstance(n, ast.Call)]


def bound_names(stmt: ast.stmt) -> List[str]:
    """Names (re)bound by this statement's assignment targets."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    names: List[str] = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                names.append(n.id)
    return names


def flat_targets(stmt: ast.stmt) -> Optional[List[ast.expr]]:
    """For ``a, b = call()``: the element targets, else ``None``.

    ``a = b = call()`` returns ``None`` unless one target is a tuple.
    """
    if not isinstance(stmt, ast.Assign):
        return None
    for t in stmt.targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            return list(t.elts)
    return None


TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)

State = Dict[str, Any]
Visit = Callable[[ast.stmt, State], None]
Merge = Callable[[List[State]], State]
Copy = Callable[[State], State]


def run_flow(
    body: Sequence[ast.stmt],
    state: State,
    visit: Visit,
    copy: Copy,
    merge: Merge,
    _pass: int = 1,
) -> Tuple[State, bool]:
    """Drive ``visit`` over ``body`` in source order with branch forking.

    ``visit(stmt, state)`` is called for *every* statement, compound ones
    included — the visitor inspects the statement's header expressions
    via :func:`walk_same_statement` (which does not descend into nested
    suites because those are driven separately below).  Returns
    ``(state, terminated)``; ``terminated`` arms are excluded from joins.
    """

    def sub(stmts: Sequence[ast.stmt], st: State) -> Tuple[State, bool]:
        return run_flow(stmts, st, visit, copy, merge, _pass)

    def join(arms: List[Tuple[State, bool]]) -> State:
        live = [s for s, dead in arms if not dead]
        if not live:
            live = [s for s, _ in arms]
        return merge(live)

    terminated = False
    for stmt in body:
        if isinstance(stmt, SCOPE_NODES):
            continue  # separate scope (functions) or namespace (classes)
        visit_header(stmt, state, visit)
        if isinstance(stmt, ast.If):
            state = join([sub(stmt.body, copy(state)), sub(stmt.orelse, copy(state))])
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            once, _ = sub(stmt.body, copy(state))
            # Second pass exposes loop-carried staleness; duplicated
            # findings are deduped by the engine.
            twice, _ = sub(stmt.body, copy(once))
            state = merge([state, once, twice])
            if stmt.orelse:
                state, _ = sub(stmt.orelse, state)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            state, term = sub(stmt.body, state)
            terminated = terminated or term
        elif isinstance(stmt, ast.Try):
            after_body, term_body = sub(stmt.body, copy(state))
            arms: List[Tuple[State, bool]] = []
            if stmt.orelse:
                arms.append(sub(stmt.orelse, copy(after_body)))
            else:
                arms.append((after_body, term_body))
            for handler in stmt.handlers:
                # A handler can run from any point inside the body:
                # merge the entry and post-body views.
                entry = merge([copy(state), copy(after_body)])
                arms.append(sub(handler.body, entry))
            state = join(arms)
            if stmt.finalbody:
                state, term = sub(stmt.finalbody, state)
                terminated = terminated or term
        elif hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            arms = [sub(case.body, copy(state)) for case in stmt.cases]
            state = join(arms) if arms else state
        elif isinstance(stmt, TERMINATORS):
            return state, True
    return state, terminated


def visit_header(stmt: ast.stmt, state: State, visit: Visit) -> None:
    """Apply ``visit`` to the statement itself.  For compound statements
    the visitor must restrict itself to header expressions — which
    :func:`walk_same_statement` guarantees by construction only when the
    node passed in is a *simple* statement, so we synthesize per-header
    visits here."""
    if isinstance(
        stmt,
        (ast.If, ast.While, ast.For, ast.AsyncFor, ast.With, ast.AsyncWith, ast.Try),
    ):
        headers: List[ast.AST] = []
        if isinstance(stmt, (ast.If, ast.While)):
            headers = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            headers = [stmt.iter, stmt.target]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            headers = [i.context_expr for i in stmt.items]
        for h in headers:
            expr = ast.Expr(value=h) if isinstance(h, ast.expr) else None
            if expr is not None:
                ast.copy_location(expr, stmt)
                visit(expr, state)
    else:
        visit(stmt, state)
