#!/usr/bin/env python
"""torch-lint CLI: the PyTorch port's contract analyzer over a file tree.

Usage::

    python scripts/torch_lint.py src/                 # lint, text output
    python scripts/torch_lint.py src/ --json          # machine-readable
    python scripts/torch_lint.py src/ --select stale-remap,unchecked-oom
    python scripts/torch_lint.py --list-rules

Exit code 0 when every finding is suppressed (or there are none),
1 when unsuppressed findings remain, 2 on usage errors.  See the
docstring of ``repro_torch.analysis`` for the rules and the suppression
syntax.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.analysis.engine import lint_paths  # noqa: E402
from repro_torch.analysis.rules import ALL_RULES  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch-lint", description=__doc__.splitlines()[0]
    )
    ap.add_argument("paths", nargs="*", type=Path, help="files or directories")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--select",
        metavar="RULES",
        help="comma-separated rule names to run (default: all)",
    )
    ap.add_argument("--list-rules", action="store_true", help="list rules and exit")
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="include suppressed findings in the report",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:20s} {rule.description}")
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
    try:
        findings = lint_paths(args.paths, select=select)
    except KeyError as e:
        print(f"torch-lint: {e.args[0]}", file=sys.stderr)
        return 2

    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in shown],
                    "unsuppressed": len(active),
                    "suppressed": sum(1 for f in findings if f.suppressed),
                },
                indent=2,
            )
        )
    else:
        for f in shown:
            print(f.render())
        n_sup = sum(1 for f in findings if f.suppressed)
        print(
            f"torch-lint: {len(active)} finding(s), {n_sup} suppressed",
            file=sys.stderr,
        )
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
