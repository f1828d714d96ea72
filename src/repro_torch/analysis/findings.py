"""The finding record shared by every rule and both output formats."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.

    ``suppressed`` findings carried a matching inline
    ``# repro-lint: disable=<rule>`` comment; they are kept (for
    ``--show-suppressed``) but do not affect the exit code.
    """

    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{tag}"
