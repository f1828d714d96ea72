"""Copy-strategy configuration shared by the object-graph and array platforms.

The paper evaluates three compile-time configurations (Section 4):

1. ``EAGER``   — every ``deep_copy`` physically copies the reachable
                 subgraph immediately (the baseline).
2. ``LAZY``    — lazy copy-on-write: ``deep_copy`` is O(1) bookkeeping and
                 objects are copied on first write (Algorithms 3-8).
3. ``LAZY_SR`` — lazy copy plus the single-reference optimization of
                 Remark 1 (skip memo entries for in-degree-1 vertices, and
                 thaw/reuse sole-reference frozen objects in place).

The array-world :mod:`repro_torch.core.store` maps these onto block-pool
behaviour; see that module for the correspondence.  (A copy of the JAX
package's ``repro.core.config``: importing that module would pull in
jax through its package ``__init__``.)
"""

from __future__ import annotations

import enum


class CopyMode(enum.Enum):
    """The paper's three evaluation configurations."""

    EAGER = "eager"
    LAZY = "lazy"
    LAZY_SR = "lazy_sr"

    @property
    def is_lazy(self) -> bool:
        return self is not CopyMode.EAGER

    @property
    def single_reference(self) -> bool:
        return self is CopyMode.LAZY_SR


ALL_MODES = (CopyMode.EAGER, CopyMode.LAZY, CopyMode.LAZY_SR)
