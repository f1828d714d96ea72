"""use-after-consume: a state written in place is not the old state.

The port's counterpart of ``use-after-donate``.  Where the reference's
jitted step donates a buffer (JAX then deletes it), the port writes into
the argument in place, so every binding that shares its storage holds
the *new* values: ``LanguageModel.decode_step`` writes the token's K/V
and SSM states into its cache, ``kvc.ensure_writable``/``kvc.write_kv``
and the engine's prefill write ``cache.pool.data``, the store's
``append``/``write_at`` write the payload and tables, ``cow_write``
writes ``data``.  Nothing fails; a rollback snapshot, or a comparison
against "the state before", silently reads the state after.

Which calls consume (:data:`repro_torch.analysis.apis.CONSUMERS` and):

* torch's trailing-underscore in-place methods called on a name or an
  attribute chain (``x.copy_``, ``x.index_put_``, ``x.zero_``,
  ``x.add_``, ...), and the name passed as ``out=``;
* a ``torch.library.custom_op`` with a *literal* ``mutates_args`` (the
  analogue of a literal ``donate_argnums``): its calls consume the named
  parameters; a computed ``mutates_args`` stays unflagged.

Two findings:

(a) a read of the consumed name after a table call whose successor was
    bound to another name (``logits, new = lm.decode_step(p, tok,
    cache)`` then ``cache.position``: new K/V under the old position);
(b) a read, after any consuming call, of an alias bound before it:
    ``snap = cache``, ``old_k = cache.k``, a tuple, list or dict holding
    it, a NamedTuple ``_replace``, a basic-indexing slice, or a view-like
    call (``.detach()``, ``.view()``, ``.cpu()``, ``.numpy()``,
    ``.to(...)`` without ``copy=True``).

Rebinding a name ends its alias, as does binding it from a copy
(``.clone()``, ``torch.clone``, ``copy.deepcopy``,
``executor_lib.snapshot``, ``rnd.snapshot``).  Anything the analysis
cannot see (another call's result, a subscript by a computed index, a
write through a subscript) is not tracked and never flagged.  Scopes are
a function at a time; branches fork and merge, loops run twice.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis import apis
from repro_torch.analysis.dataflow import (
    State,
    dotted,
    run_flow,
    scopes,
    split_call,
    walk_same_statement,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule

#: qualifiers of array modules: ``torch.squeeze(x)`` is the function form
#: of an alias call
_ARRAY_MODULES = {"torch", "np", "numpy"}


def _related(a: str, b: str) -> bool:
    """One dotted path is the other or a part of it."""
    return a == b or a.startswith(b + ".") or b.startswith(a + ".")


def _basic_index(node: ast.AST) -> bool:
    """Basic indexing (slices, integer literals, ``...``/``None``):
    the result is a view of the indexed tensor."""
    if isinstance(node, ast.Tuple):
        return all(_basic_index(e) for e in node.elts)
    if isinstance(node, ast.Slice):
        return True
    if isinstance(node, ast.UnaryOp):
        return _basic_index(node.operand)
    return isinstance(node, ast.Constant)


def _literal_mutates(call: ast.Call) -> Optional[Set[str]]:
    """Parameter names a ``custom_op(..., mutates_args=...)`` declares,
    when the declaration is a literal (``{"*"}`` for ``"unknown"``)."""
    for kw in call.keywords:
        if kw.arg != "mutates_args":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and v.value == "unknown":
            return {"*"}
        if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
            out: Set[str] = set()
            for e in v.elts:
                if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                    return None
                out.add(e.value)
            return out
        return None
    return None


def _is_custom_op(call: ast.Call) -> bool:
    qual, term = split_call(call)
    return term == "custom_op" and qual in {"", "library"}


def _op_name(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant):
        name = call.args[0].value
        if isinstance(name, str):
            return name.split("::")[-1]
    return None


def _positions(fn: ast.AST, params: Set[str]) -> Dict[int, str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    return {i: n for i, n in enumerate(names) if "*" in params or n in params}


def custom_ops(tree: ast.Module) -> Dict[str, Dict[int, str]]:
    """``{callable name: {position: param}}`` for every function of the
    module decorated with a ``custom_op`` whose ``mutates_args`` is a
    literal and not empty: the function's name and the op's name after
    ``::`` (called as ``torch.ops.<ns>.<op>``)."""
    out: Dict[str, Dict[int, str]] = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in fn.decorator_list:
            if not (isinstance(dec, ast.Call) and _is_custom_op(dec)):
                continue
            params = _literal_mutates(dec)
            pos = _positions(fn, params) if params else {}
            for name in (fn.name, _op_name(dec)):
                if name and pos:
                    out[name] = pos
    return out


def _target_paths(stmt: ast.stmt) -> List[str]:
    """Dotted paths (re)bound by this statement: names and attribute
    chains, through tuple targets."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    elif isinstance(stmt, ast.Expr) and isinstance(
        getattr(stmt.value, "ctx", None), ast.Store
    ):
        targets = [stmt.value]  # a loop's target, as the flow driver visits it
    out: List[str] = []

    def rec(t: ast.expr) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                rec(e)
        elif isinstance(t, ast.Starred):
            rec(t.value)
        else:
            path = dotted(t)
            if path:
                out.append(path)

    for t in targets:
        rec(t)
    return out


def _sources(expr: ast.AST, alias: Dict[str, Tuple[Set[str], int]]) -> Set[str]:
    """Dotted paths whose storage ``expr``'s value shares."""
    path = dotted(expr)
    if path:
        root, _, rest = path.partition(".")
        out = {path}
        if root in alias:
            out |= {s + ("." + rest if rest else "") for s in alias[root][0]}
        return out
    if isinstance(expr, ast.Subscript):
        if _basic_index(expr.slice):
            return _sources(expr.value, alias)
        return set()
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return set().union(*(_sources(e, alias) for e in expr.elts))
    if isinstance(expr, ast.Starred):
        return _sources(expr.value, alias)
    if isinstance(expr, ast.Dict):
        return set().union(*(_sources(v, alias) for v in expr.values))
    if isinstance(expr, ast.IfExp):
        return _sources(expr.body, alias) | _sources(expr.orelse, alias)
    if isinstance(expr, ast.Call):
        if apis.is_snapshot(expr):
            return set()
        qual, term = split_call(expr)
        kw_sources = set().union(
            *(_sources(k.value, alias) for k in expr.keywords)
        )
        if term == "dict" and not qual:
            return kw_sources.union(*(_sources(a, alias) for a in expr.args))
        if not isinstance(expr.func, ast.Attribute):
            return set()
        if term == "_replace":
            return _sources(expr.func.value, alias) | kw_sources
        if term in apis.ALIAS_CALLS:
            if term == "to" and any(
                k.arg == "copy"
                and not (isinstance(k.value, ast.Constant) and not k.value.value)
                for k in expr.keywords
            ):
                return set()
            if qual in _ARRAY_MODULES:
                return _sources(expr.args[0], alias) if expr.args else set()
            return _sources(expr.func.value, alias)
    return set()

def _consumed_by(call: ast.Call, ops: Dict[str, Dict[int, str]]) -> List[Tuple[str, str, bool]]:
    """``(path, what, returns_successor)`` this call writes."""
    out: List[Tuple[str, str, bool]] = []
    qual, term = split_call(call)
    c = apis.consumer(call)
    if c is not None:
        arg: Optional[ast.AST] = None
        if c.index < len(call.args):
            arg = call.args[c.index]
        else:
            arg = next((k.value for k in call.keywords if k.arg == c.param), None)
        path = dotted(arg) if arg is not None else ""
        if path:
            out.append((path, term, True))
    if apis.is_inplace_method(call):
        path = dotted(call.func.value)
        if path:
            out.append((path, term, False))
    for kw in call.keywords:
        if kw.arg == "out":
            outs = kw.value.elts if isinstance(kw.value, ast.Tuple) else [kw.value]
            for o in outs:
                if dotted(o):
                    out.append((dotted(o), f"{term}(out=)", False))
    name = _call_key(call)
    if name in ops:
        for i, param in ops[name].items():
            arg = call.args[i] if i < len(call.args) else next(
                (k.value for k in call.keywords if k.arg == param), None
            )
            if arg is not None and dotted(arg):
                out.append((dotted(arg), name, False))
    return out


def _call_key(call: ast.Call) -> str:
    """The name a custom op is called by: a bare name, or the op's name
    in ``torch.ops.<ns>.<op>[.default]``."""
    name = dotted(call.func)
    if not name:
        return ""
    if name.startswith("torch.ops."):
        parts = name.split(".")
        if parts[-1] == "default":
            parts = parts[:-1]
        return parts[-1] if len(parts) >= 4 else ""
    return name if "." not in name else ""


class UseAfterConsume(Rule):
    name = "use-after-consume"
    description = (
        "state read after a call that wrote into it in place (decode_step, "
        "the KV/store writes, cow_write, x.op_(), out=, custom_op "
        "mutates_args), or an alias of it bound before the call"
    )

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        found: List[Finding] = []
        ops = custom_ops(tree)

        def visit(stmt: ast.stmt, state: State) -> None:
            alias: Dict[str, Tuple[Set[str], int]] = state["alias"]
            stale: Dict[str, Tuple[int, str, str, int]] = state["stale"]
            dead: Dict[str, Tuple[int, str]] = state["dead"]

            nodes = list(walk_same_statement(stmt))
            # reads first: the statement runs against the state before it
            for n in nodes:
                if not (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)):
                    continue
                if n.id in stale:
                    line, fn, path, bound = stale.pop(n.id)
                    found.append(
                        self.finding(
                            ctx,
                            n,
                            f"{n.id!r} (bound at line {bound}) shares "
                            f"storage with {path!r}, which {fn!r} wrote "
                            f"in place at line {line}: it reads the new "
                            "values, not the old state — copy it before "
                            "the call (.clone(), executor_lib.snapshot)",
                        )
                    )
                elif n.id in dead:
                    self_read(n, n.id, dead)
            for node in nodes if any("." in p for p in dead) else ():
                if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                    path = dotted(node)
                    hit = next((p for p in dead if "." in p and (
                        path == p or path.startswith(p + "."))), None)
                    if hit is not None:
                        self_read(node, hit, dead)

            # calls that consume
            rebound = _target_paths(stmt)
            assigned = rebound if isinstance(stmt, (ast.Assign, ast.AnnAssign)) else []
            for call in nodes:
                if not isinstance(call, ast.Call):
                    continue
                for path, fn, successor in _consumed_by(call, ops):
                    for a, (srcs, bound) in list(alias.items()):
                        if a == path or path.startswith(a + "."):
                            continue  # the consumed binding itself
                        hit = next((s for s in srcs if _related(s, path)), None)
                        if hit is not None:
                            stale[a] = (call.lineno, fn, hit, bound)
                    if successor and assigned and not any(
                        path == t or path.startswith(t + ".") for t in assigned
                    ):
                        dead[path] = (call.lineno, fn)

            # bindings: rebinding ends aliases and resurrects names
            for t in rebound:
                for p in [p for p in dead if p == t or p.startswith(t + ".")]:
                    dead.pop(p)
                stale.pop(t, None)
                alias.pop(t, None)
                for a, (srcs, bound) in list(alias.items()):
                    keep = {s for s in srcs if not (s == t or s.startswith(t + "."))}
                    if keep != srcs:
                        if keep:
                            alias[a] = (keep, bound)
                        else:
                            alias.pop(a)
            value = getattr(stmt, "value", None)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and value is not None:
                pre = dict(alias)
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                for t in targets:
                    pairs: List[Tuple[ast.expr, ast.expr]] = [(t, value)]
                    if isinstance(t, (ast.Tuple, ast.List)):
                        pairs = []
                        if isinstance(value, (ast.Tuple, ast.List)) and len(
                            value.elts
                        ) == len(t.elts):
                            pairs = list(zip(t.elts, value.elts))
                    for tt, vv in pairs:
                        if isinstance(tt, ast.Name):
                            srcs = _sources(vv, pre) - {tt.id}
                            if srcs:
                                alias[tt.id] = (srcs, stmt.lineno)

        def self_read(node: ast.AST, path: str, dead: Dict[str, Tuple[int, str]]) -> None:
            line, fn = dead.pop(path)
            found.append(
                self.finding(
                    ctx,
                    node,
                    f"{path!r} was consumed by {fn!r} at line {line}, "
                    "which wrote into it in place and returned its "
                    "successor under another name: reading it now sees "
                    "a mixed state — read the returned state, or copy "
                    "before the call",
                )
            )

        def copy(state: State) -> State:
            return {
                "alias": {k: (set(s), b) for k, (s, b) in state["alias"].items()},
                "stale": dict(state["stale"]),
                "dead": dict(state["dead"]),
            }

        def merge(states: List[State]) -> State:
            out: State = {"alias": {}, "stale": {}, "dead": {}}
            for s in states:
                for k, (srcs, b) in s["alias"].items():
                    prev = out["alias"].get(k)
                    out["alias"][k] = (
                        (prev[0] | srcs, min(prev[1], b)) if prev else (set(srcs), b)
                    )
                out["stale"].update(s["stale"])
                out["dead"].update(s["dead"])
            return out

        for scope in scopes(tree):
            run_flow(scope.body, {"alias": {}, "stale": {}, "dead": {}}, visit, copy, merge)
        yield from found

