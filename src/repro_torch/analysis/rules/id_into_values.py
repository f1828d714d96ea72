"""id-into-values: block ids never leak into value math.

Block ids are *addresses* (the bit-exactness contract: ``grow`` and
``compact`` may renumber or relocate them at any host boundary, and the
dump-row index moves with capacity).  The moment an id array enters
arithmetic with payload values — or is concatenated into a value tensor,
or written *as* payload — trajectories silently change under relocation
and every bit-exactness check against the reference is void.

Taint analysis: sources are ``.tables`` reads, the id half of
``alloc``/``alloc_compact``/``alloc_scan`` results, ``remap_tables``
results, and parameters conventionally carrying tables/ids.  Taint
propagates through ``where``/reshape-like calls (numpy's names and
torch's: ``view``, ``to``, ``long``, ``clamp``, ``unsqueeze``, ...),
subscripts of tainted bases, and id↔id arithmetic; it *dies* when used
as an index (gathering payload yields values): a subscript's index, and
the index operand of ``index_select``/``gather``/``take``.  Sinks: mixed
arithmetic, mixed concatenation (``cat``/``concat`` as well), and id
arrays in a ``values`` slot of a write API (``write_blocks``,
``cow_write``/``cow_write_delta``, ``append``, ``write_at``,
``import_trajectories``, ``kvc.write_kv``'s ``k`` and ``v``).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from repro_torch.analysis.dataflow import (
    State,
    bound_names,
    run_flow,
    scopes,
    split_call,
    walk_same_statement,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import Rule

_ALLOC_TERMS = {"alloc", "alloc_scan", "alloc_compact"}
_TAINT_PARAMS = {"tables", "new_tables", "old_tables", "remap", "block_ids", "bids"}
#: method/function names that preserve the id-ness of their input
_PRESERVING_CALLS = {
    "where",
    "reshape",
    "astype",
    "clip",
    "maximum",
    "minimum",
    "broadcast_to",
    "asarray",
    "flatten",
    "ravel",
    "squeeze",
    # torch's
    "view",
    "to",
    "long",
    "int",
    "clamp",
    "unsqueeze",
    "expand",
    "contiguous",
    "as_tensor",
}
#: gathers: the result carries the id-ness of the *source* operand only
#: (``torch.gather(src, dim, index)``, ``src.index_select(dim, index)``,
#: ``torch.take(src, index)``); ids used as the index gather payload
_GATHER_TERMS = {"index_select", "gather", "take"}
_ARRAY_MODULES = {"torch", "np", "numpy", "jnp"}
_CONCAT_TERMS = {
    "concatenate",
    "stack",
    "hstack",
    "vstack",
    "column_stack",
    "cat",
    "concat",
}
#: terminal -> positional indices of the payload/values arguments, from
#: the port's signatures
_VALUE_SINK_ARGS = {
    "write_blocks": (2,),  # pool.write_blocks(pool, ids, values, mask)
    "cow_write": (4,),  # cow_write(data, src, dst, pos, values)
    "cow_write_delta": (4,),  # cow_write_delta(data, src, dst, pos, values, keep)
    "append": (2,),  # store.append(cfg, store, values)
    "write_at": (3,),  # store.write_at(cfg, store, positions, values, mask)
    "import_trajectories": (2,),  # (cfg, store, trajs, new_lengths, mask)
    "write_kv": (5, 6),  # kvc.write_kv(cfg, cache, bid, pos, layer, k, v, mask)
}
_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Pow, ast.MatMult)


class IdIntoValues(Rule):
    name = "id-into-values"
    description = "block-id arrays reaching arithmetic/concat with value arrays"

    def check(self, tree: ast.Module, ctx) -> Iterator[Finding]:
        found: List[Finding] = []

        for scope in scopes(tree):
            seed: Set[str] = {p for p in scope.params() if p in _TAINT_PARAMS}

            def tainted_expr(expr: ast.AST, taint: Set[str]) -> bool:
                if isinstance(expr, ast.Name):
                    return expr.id in taint
                if isinstance(expr, ast.Attribute):
                    return expr.attr == "tables"
                if isinstance(expr, ast.Subscript):
                    # subscript of an id array is ids; ids used as the
                    # *index* gather payload -> not ids
                    return tainted_expr(expr.value, taint)
                if isinstance(expr, ast.IfExp):
                    return tainted_expr(expr.body, taint) or tainted_expr(
                        expr.orelse, taint
                    )
                if isinstance(expr, ast.BinOp):
                    return tainted_expr(expr.left, taint) and tainted_expr(
                        expr.right, taint
                    )
                if isinstance(expr, ast.Call):
                    qual, term = split_call(expr)
                    if not term and isinstance(expr.func, ast.Attribute):
                        # a method of a computed receiver: x.view(-1).long()
                        term = expr.func.attr
                    if term == "remap_tables":
                        return True
                    if term in _GATHER_TERMS:
                        # method form: the receiver is the source;
                        # function form: the first argument is
                        if (
                            isinstance(expr.func, ast.Attribute)
                            and qual not in _ARRAY_MODULES
                        ):
                            return tainted_expr(expr.func.value, taint)
                        return bool(expr.args) and tainted_expr(expr.args[0], taint)
                    if term in _PRESERVING_CALLS:
                        # torch.where(c, a, b): id-ness comes from the
                        # branches; method form x.to(...) from x
                        if term == "where" and len(expr.args) == 3:
                            return tainted_expr(expr.args[1], taint) or tainted_expr(
                                expr.args[2], taint
                            )
                        if isinstance(expr.func, ast.Attribute) and tainted_expr(
                            expr.func.value, taint
                        ):
                            return True
                        return any(tainted_expr(a, taint) for a in expr.args)
                return False

            def visit(stmt: ast.stmt, state: State) -> None:
                taint: Set[str] = state["taint"]
                # -- sinks -------------------------------------------------
                for node in walk_same_statement(stmt):
                    if isinstance(node, ast.BinOp) and isinstance(
                        node.op, _ARITH_OPS
                    ):
                        lt = tainted_expr(node.left, taint)
                        rt = tainted_expr(node.right, taint)
                        if lt != rt:
                            other = node.right if lt else node.left
                            if _is_neutral(other):
                                continue
                            found.append(
                                self.finding(
                                    ctx,
                                    node,
                                    "block-id array used in arithmetic with "
                                    "a value expression — ids are addresses "
                                    "(grow/compact renumber them), never "
                                    "operands",
                                )
                            )
                    elif isinstance(node, ast.Call):
                        qual, term = split_call(node)
                        if term in _CONCAT_TERMS and node.args:
                            seq = node.args[0]
                            if isinstance(seq, (ast.List, ast.Tuple)):
                                flags = [tainted_expr(e, taint) for e in seq.elts]
                                if any(flags) and not all(flags):
                                    found.append(
                                        self.finding(
                                            ctx,
                                            node,
                                            "block-id array concatenated "
                                            "with value arrays — the result "
                                            "mixes addresses into payload",
                                        )
                                    )
                        for idx in _VALUE_SINK_ARGS.get(term, ()):
                            if idx < len(node.args) and tainted_expr(
                                node.args[idx], taint
                            ):
                                found.append(
                                    self.finding(
                                        ctx,
                                        node,
                                        f"block-id array passed as the "
                                        f"values argument of {term!r} — ids "
                                        "written as payload",
                                    )
                                )
                # -- taint update ------------------------------------------
                if isinstance(stmt, ast.Assign):
                    targets = bound_names(stmt)
                    value = stmt.value
                    # tuple-unpack of an alloc: the id half is tainted
                    if isinstance(value, ast.Call):
                        _, term = split_call(value)
                        elts = None
                        for t in stmt.targets:
                            if isinstance(t, (ast.Tuple, ast.List)):
                                elts = t.elts
                        if term in _ALLOC_TERMS and elts and len(elts) == 2:
                            if isinstance(elts[1], ast.Name):
                                taint.add(elts[1].id)
                            if isinstance(elts[0], ast.Name):
                                taint.discard(elts[0].id)
                            return
                    is_id = tainted_expr(value, taint)
                    for t in targets:
                        (taint.add if is_id else taint.discard)(t)
                else:
                    for t in bound_names(stmt):
                        taint.discard(t)

            def copy(state: State) -> State:
                return {"taint": set(state["taint"])}

            def merge(states: List[State]) -> State:
                out: Set[str] = set()
                for s in states:
                    out |= s["taint"]
                return {"taint": out}

            run_flow(scope.body, {"taint": set(seed)}, visit, copy, merge)
        yield from found


def _is_neutral(expr: ast.AST) -> bool:
    """Integer literals and negations thereof: offset math on ids
    (``bid + 1`` while paging) is address arithmetic, not a leak."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, (int, bool)):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, (ast.USub, ast.UAdd)):
        return _is_neutral(expr.operand)
    return False
