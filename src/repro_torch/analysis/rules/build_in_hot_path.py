"""build-in-hot-path: build once, call many — never rebuild per call.

The port's counterpart of ``jit-in-hot-path``.  Where the reference
builds a ``jax.jit`` or ``pallas_call`` once, the port builds its own
expensive objects once: the kernel library (``ctypes.CDLL`` behind
``functools.cache`` in ``kernels/_build.py``), the
``torch.library.custom_op`` registrations at module level
(``kernels/*/ops.py``), and whatever a user compiles or captures
(``torch.compile``, ``torch.jit.script``/``trace``, CUDA graphs,
``torch.utils.cpp_extension.load``/``load_inline``).  Building one per
call recompiles, re-captures, re-registers or reloads every time; the
only symptom is the wall clock.

Flagged shapes (the reference's three):

* construction inside any loop body;
* immediate invocation ``torch.compile(f)(*args)`` anywhere below module
  level (the callable is born and discarded in one expression);
* construction in a plain function/method body whose result is bound to
  a local and used in the same scope: called, or a method of it called
  (``g.replay()`` on a graph, ``lib.fn(...)`` on a loaded library).

Exempt shapes (the reference's): module-level construction (a
decorator's call runs where its ``def`` does, so a ``custom_op``
decorator on a module-level function is module level); ``__init__`` (one
per object); an enclosing function decorated with ``functools.cache`` /
``lru_cache``; assignment onto ``self``-attributes
or ``self``-subscripts (an instance cache); and a bare ``return`` (an
explicit builder the caller is expected to cache).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from repro_torch.analysis.dataflow import (
    ancestors,
    attach_parents,
    dotted,
    split_call,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule

#: (qualifier, terminal) of every builder
_BUILDERS = {
    ("torch", "compile"),
    ("jit", "script"),
    ("jit", "trace"),
    ("cuda", "CUDAGraph"),
    ("cuda", "graph"),
    ("cuda", "make_graphed_callables"),
    ("library", "custom_op"),
    ("library", "Library"),
    ("cpp_extension", "load"),
    ("cpp_extension", "load_inline"),
    ("ctypes", "CDLL"),
}
#: builders also recognized when imported bare (the others' terminals
#: are common words: ``compile``, ``load``, ``graph``, ``trace``)
_BARE_BUILDERS = {"CUDAGraph", "make_graphed_callables", "custom_op", "load_inline", "CDLL"}
_CACHING_DECORATORS = {"lru_cache", "cache"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_builder(call: ast.Call) -> bool:
    qual, term = split_call(call)
    if not qual:
        return term in _BARE_BUILDERS
    return (qual, term) in _BUILDERS


def _decorator_exempts(dec: ast.expr) -> bool:
    """cache / lru_cache memoize: construction under them runs once per
    key."""
    name = dotted(dec.func) if isinstance(dec, ast.Call) else dotted(dec)
    return name.rsplit(".", 1)[-1] in _CACHING_DECORATORS


def _enclosing(node: ast.AST, chain: List[ast.AST]) -> Optional[ast.AST]:
    """The function whose *body* runs ``node``: a decorator (or default)
    of a ``def`` runs in the scope around the ``def``."""
    child = node
    for a in chain:
        if isinstance(a, _FUNCS) and child in a.body:
            return a
        child = a
    return None


class BuildInHotPath(Rule):
    name = "build-in-hot-path"
    description = (
        "torch.compile / CUDA graph / custom_op / kernel library built per "
        "call (in a loop or hot method body) instead of once"
    )

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        parents = attach_parents(tree)

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not _is_builder(node):
                continue
            chain = list(ancestors(node, parents))
            what = dotted(node.func)
            parent = parents.get(node)

            enclosing = _enclosing(node, chain)
            below = chain if enclosing is None else chain[: chain.index(enclosing)]
            in_loop = any(isinstance(a, _LOOPS) for a in below)

            if enclosing is None:
                if in_loop:
                    yield self.finding(
                        ctx,
                        node,
                        f"{what} built inside a module-level loop: each "
                        "iteration builds it again — hoist the construction "
                        "out of the loop",
                    )
                continue  # module level (outside loops) is the idiom

            if enclosing.name == "__init__":
                if in_loop:
                    yield self.finding(
                        ctx,
                        node,
                        f"{what} built in a loop inside __init__: one build "
                        "per iteration — build once and reuse",
                    )
                continue
            if any(_decorator_exempts(d) for d in enclosing.decorator_list):
                continue

            stmt = next((a for a in [node] + chain if isinstance(a, ast.stmt)), None)
            if in_loop:
                yield self.finding(
                    ctx,
                    node,
                    f"{what} built inside a loop: every iteration compiles, "
                    "captures, registers or loads it afresh — hoist it",
                )
                continue

            # immediate invocation: torch.compile(f)(args)
            if isinstance(parent, ast.Call) and parent.func is node:
                yield self.finding(
                    ctx,
                    node,
                    f"{what}(...)(...) builds and invokes a fresh callable in "
                    "one expression: the build is discarded immediately — "
                    "cache it (module level, __init__, or functools.cache)",
                )
                continue

            if isinstance(stmt, ast.Return):
                continue  # explicit builder: caller caches
            if isinstance(stmt, _FUNCS) and node in stmt.decorator_list:
                # @torch.library.custom_op(...) on a nested def: registered
                # again every time the enclosing function runs
                if _invoked_later(enclosing, stmt, stmt.name):
                    yield self.finding(
                        ctx,
                        node,
                        f"{what} decorates {stmt.name!r}, defined and invoked "
                        f"in the same call of {enclosing.name!r}: rebuilt on "
                        "every call — define it at module level",
                    )
                continue
            if isinstance(stmt, ast.Assign):
                if all(_is_instance_cache(t) for t in stmt.targets):
                    continue  # self._fn = torch.compile(...) / self._cache[k] = ...
                local = _sole_name_target(stmt)
                if local is not None and _invoked_later(enclosing, stmt, local):
                    yield self.finding(
                        ctx,
                        node,
                        f"{what} result bound to local {local!r} and invoked "
                        f"in the same call of {enclosing.name!r}: rebuilt on "
                        "every call — cache it (module level, __init__, or "
                        "functools.cache)",
                    )


def _is_instance_cache(target: ast.expr) -> bool:
    """``self.x = ...`` or ``self._cache[k] = ...``."""
    base = target
    while isinstance(base, (ast.Attribute, ast.Subscript)):
        base = base.value
    return isinstance(base, ast.Name) and base.id in {"self", "cls"}


def _sole_name_target(stmt: ast.Assign) -> Optional[str]:
    """The local name when *some* target is a plain name and *no* target
    is an instance cache (chained self-cache assignment exempts)."""
    if any(_is_instance_cache(t) for t in stmt.targets):
        return None
    for t in stmt.targets:
        if isinstance(t, ast.Name):
            return t.id
    return None


def _invoked_later(func: ast.AST, after: ast.stmt, name: str) -> bool:
    """``name(...)`` called, or ``name.replay()``/``name.<attr>(...)`` on a
    built object (a graph, a library) used, after the binding."""
    end = getattr(after, "end_lineno", None) or after.lineno
    for n in ast.walk(func):
        if not isinstance(n, ast.Call) or n.lineno <= end:
            continue
        f = n.func
        if isinstance(f, ast.Name) and f.id == name:
            return True
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id == name:
            return True
    return False
