"""torch-lint engine: parse once, run every rule, honor suppressions.

A file is linted by parsing it to an AST (syntax errors become a single
``parse-error`` finding rather than a crash — the linter must survive
whatever it is fed), running each rule's ``check`` over the tree, and
then folding in suppressions.

Suppression syntax (the reference linter's own, so one comment serves
both linters; it mirrors the familiar ``noqa``/``pylint`` shape)::

    pool = pool_lib.alloc(pool, n)[0]  # repro-lint: disable=unthreaded-pool
    # repro-lint: disable=stale-remap  <- standalone: covers the next line
    tables = old.tables

``disable=all`` silences every rule on that line.  Suppressed findings
are *kept* (marked ``suppressed=True``) so ``--show-suppressed`` can
audit them; they do not affect the exit code.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_NAME, Rule

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\-]+)")


@dataclasses.dataclass
class FileContext:
    """Everything a rule may consult besides the tree itself."""

    path: str
    source: str

    @property
    def lines(self) -> List[str]:
        return self.source.splitlines()


def suppressions(source: str) -> Dict[int, Set[str]]:
    """``{line: {rule, ...}}`` of suppressed rules ("all" wildcards).

    A trailing comment covers its own line; a comment alone on a line
    covers the *next* line (so long suppression justifications can sit
    above the code they excuse).
    """
    out: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = tok.start[0]
        before = lines[line - 1][: tok.start[1]] if line - 1 < len(lines) else ""
        target = line + 1 if not before.strip() else line
        out.setdefault(target, set()).update(rules)
    return out


def _select(only: Optional[Iterable[str]]) -> List[Rule]:
    if only is None:
        return list(ALL_RULES)
    missing = [n for n in only if n not in RULES_BY_NAME]
    if missing:
        raise KeyError(
            f"unknown rule(s): {', '.join(missing)} "
            f"(known: {', '.join(sorted(RULES_BY_NAME))})"
        )
    return [RULES_BY_NAME[n] for n in only]


def lint_source(
    source: str,
    path: str = "<string>",
    select: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Lint one source string.  Returns all findings, suppressed ones
    marked, sorted by position; duplicates (the flow driver runs loop
    bodies twice) are folded."""
    ctx = FileContext(path=path, source=source)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                path=path,
                line=e.lineno or 1,
                col=(e.offset or 1) - 1,
                rule="parse-error",
                message=f"could not parse: {e.msg}",
            )
        ]
    suppressed_at = suppressions(source)
    found: List[Finding] = []
    for rule in _select(select):
        found.extend(rule.run(tree, ctx))
    deduped = sorted(set(found))
    out: List[Finding] = []
    for f in deduped:
        off = suppressed_at.get(f.line, set())
        if f.rule in off or "all" in off:
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out


def lint_file(path: Path, select: Optional[Iterable[str]] = None) -> List[Finding]:
    source = path.read_text(encoding="utf-8")
    return lint_source(source, path=str(path), select=select)


def iter_python_files(paths: Sequence[Path]) -> List[Path]:
    """Expand files/directories into a sorted, de-duplicated file list."""
    out: Set[Path] = set()
    for p in paths:
        if p.is_dir():
            out.update(q for q in p.rglob("*.py"))
        elif p.suffix == ".py":
            out.add(p)
    return sorted(out)


def lint_paths(
    paths: Sequence[Path], select: Optional[Iterable[str]] = None
) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f, select=select))
    return findings
