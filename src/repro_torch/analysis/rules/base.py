"""Rule base class: one contract, one ``check`` pass over a module."""

from __future__ import annotations

import ast
from typing import TYPE_CHECKING, Iterator, List

from repro_torch.analysis.findings import Finding

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.analysis.engine import FileContext


class Rule:
    """A single checked contract.

    Subclasses set ``name`` (the suppression token) and ``description``
    (one line, shown by ``--list-rules``) and implement :meth:`check`,
    yielding findings.  Rules must not import or execute the analyzed
    code — everything is derived from the AST.
    """

    name: str = ""
    description: str = ""

    def check(self, tree: ast.Module, ctx: "FileContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str) -> Finding:
        return Finding(
            path=ctx.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            rule=self.name,
            message=message,
        )

    def run(self, tree: ast.Module, ctx: "FileContext") -> List[Finding]:
        return list(self.check(tree, ctx))
