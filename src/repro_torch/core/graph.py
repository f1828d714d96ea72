"""Faithful implementation of the paper's lazy object-copy semantics.

This module implements Section 2 (Definitions 1-5, Algorithms 1-8) and the
Section 3 implementation sketch of

    Murray (2020), "Lazy object copy as a platform for population-based
    probabilistic programming".

It is the executable ground truth the array-world platform is checked
against; DESIGN.md §2 gives the full correspondence between these graph
semantics and the block-pool representation of :mod:`repro_torch.core.pool` /
:mod:`repro_torch.core.store`.  It is the port of the JAX package's
``repro.core.graph``, plain Python as that module is, with one repair:
:meth:`Runtime.deep_copy` freezes the memo values a new label inherits
(see there), without which a lazy copy can lose a write that an eager
copy keeps.

Memory is a labeled directed multigraph ``H``:

* **vertices** are objects (:class:`Vertex`) with payload data ``b(v)``
  (a dict of fields; pointer-valued fields are the out-edges),
* **edges** are lazy pointers (:class:`Slot`) — a mutable pair of a target
  vertex ``t(e)`` and a label ``h(e)``,
* **labels** (:class:`Label`) identify deep-copy operations; each label
  carries its memo ``m_l`` *flattened* over ancestors per Definition 5, so
  the label tree ``a`` need not be maintained at runtime (the paper's
  recommended choice, end of Section 3),
* ``f(v)`` (``Vertex.label``) is the label of the deep copy that created
  the vertex; ``R`` is the set of frozen (read-only) vertices.

The runtime operations map 1:1 onto the paper's pseudocode:

=================  ====================================================
paper              here
=================  ====================================================
``DEEP-COPY(e)``   :meth:`Runtime.deep_copy`   (Algorithm 3)
``PULL(e)``        :meth:`Runtime.pull`        (Algorithm 4)
``GET(e)``         :meth:`Runtime.get`         (Algorithm 5)
``COPY(e)``        :meth:`Runtime._copy`       (Algorithm 6)
``FREEZE(e)``      :meth:`Runtime._freeze`     (Algorithm 7)
``FINISH(e)``      :meth:`Runtime._finish`     (Algorithm 8)
=================  ====================================================

Cross references — out-edges ``d`` of a vertex ``v`` with
``h(d) != f(v)`` — fall outside the tree-structured labeling of ``H`` and
are resolved *eagerly* during :meth:`Runtime._copy` (``Finish`` then
``Freeze``), after which the copied vertex **shares** the finished,
frozen target (this reproduces the correct branch of the paper's
Table 2).  Tree edges are relabeled to the copying label, per
Condition 4 (new edges take the current context, which during a copy is
the label of the vertex under construction).

Reference counting follows Section 3 exactly: every object carries a
*shared*, *weak* and *memo* count; memo **keys** increment only the memo
count (so memos never keep objects alive); memo **values** hold shared
references; sweeps drop entries whose key is no longer shared/weakly
reachable, and run whenever a memo hash table is copied (label
inheritance) — plus on demand via :meth:`Label.sweep`.

The single-reference optimization (Remark 1) is enabled by
:data:`CopyMode.LAZY_SR`:

* at freeze time a vertex with in-degree one (``shared == 1``) that does
  not appear in the range of any memo is *flagged*; copies of flagged
  vertices skip the memo insertion;
* duplicating a pointer to a flagged frozen vertex would create two
  in-edges with identical labels (violating Remark 1's second condition),
  so — as in the paper — ``GET`` is triggered on the edge first,
  maintaining distinct labels;
* copy elimination: if at copy time the *only* reference to the frozen
  vertex is the edge being written through, the vertex is *thawed* and
  reused in place instead of being copied (Section 3: "a frozen object
  can be thawed for reuse").

``CopyMode.EAGER`` implements the baseline configuration: ``deep_copy``
physically copies the reachable subgraph immediately (with a per-call
memo so shared substructure stays shared within one copy).

Everything is intentionally pure Python: this module is the *semantic
reference* for the platform.  The tensor adaptation lives in
:mod:`repro_torch.core.pool` / :mod:`repro_torch.core.store`.
"""

from __future__ import annotations

import itertools
from typing import Any, ContextManager, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.config import CopyMode

__all__ = [
    "CopyMode",
    "Label",
    "Vertex",
    "Slot",
    "Runtime",
    "RuntimeStats",
]

_vertex_ids = itertools.count()
_label_ids = itertools.count()

# Approximate byte model, for the memory accounting used by benchmarks:
# mirrors the paper's reported overhead of "8 bytes per pointer and
# 12 bytes per object" for lazy support, on top of the payload.
_BYTES_PER_OBJECT_HEADER = 16
_BYTES_PER_LAZY_OBJECT_EXTRA = 12
_BYTES_PER_POINTER = 8
_BYTES_PER_LAZY_POINTER_EXTRA = 8
_BYTES_PER_FIELD = 8
_BYTES_PER_MEMO_ENTRY = 24


class Label:
    """A deep-copy label ``l`` in ``L``, carrying its flattened memo ``m_l``.

    Per Definition 5 the memo holds the entries of the label *and all of
    its ancestors*; :meth:`Runtime.deep_copy` therefore initializes a new
    label's memo as a (swept) copy of the parent's, and the ``a`` function
    is kept only for introspection/debugging.
    """

    __slots__ = ("id", "memo", "parent_id")

    def __init__(self, parent: Optional["Label"] = None) -> None:
        self.id: int = next(_label_ids)
        self.parent_id: Optional[int] = parent.id if parent is not None else None
        self.memo: Dict[int, Tuple["Vertex", "Vertex"]] = {}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Label({self.id}, memo={len(self.memo)})"


class Vertex:
    """An object: payload ``b(v)``, creating label ``f(v)``, and counts.

    Pointer-valued fields of the payload are :class:`Slot` instances — the
    out-edges of the vertex.  Primitive fields are plain Python values.
    """

    __slots__ = (
        "id",
        "label",
        "payload",
        "frozen",
        "single_ref",
        "memo_value_count",
        "shared",
        "weak",
        "memo",
        "alive",
    )

    def __init__(self, label: Label) -> None:
        self.id: int = next(_vertex_ids)
        self.label: Label = label  # f(v)
        self.payload: Dict[str, Any] = {}
        self.frozen: bool = False  # v in R
        self.single_ref: bool = False  # Remark 1 flag, set at freeze time
        self.memo_value_count: int = 0  # number of memo entries with v in ran(m)
        # Section 3 triple reference count. A new object is initialized
        # with shared, weak, and memo counts of one.
        self.shared: int = 1
        self.weak: int = 1
        self.memo: int = 1
        self.alive: bool = True  # payload not yet destroyed

    def out_edges(self) -> Iterator["Slot"]:
        for value in self.payload.values():
            if isinstance(value, Slot):
                yield value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Vertex(#{self.id}, f={self.label.id}, frozen={self.frozen}, "
            f"sr={self.single_ref}, shared={self.shared})"
        )


class Slot:
    """An edge ``e``: a mutable ``(t(e), h(e))`` lazy-pointer pair.

    A slot lives either in a vertex field or as a root variable held by
    user code.  ``Pull``/``Get`` retarget slots in place; retargeting is
    bookkeeping and is permitted even when the *holding* vertex is frozen
    (Condition 1 restricts payload data, not edge maintenance).
    """

    __slots__ = ("target", "label")

    def __init__(self, target: Optional[Vertex], label: Label) -> None:
        self.target = target  # t(e)
        self.label = label  # h(e)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        t = f"#{self.target.id}" if self.target is not None else "nil"
        return f"Slot({t}, h={self.label.id})"


class RuntimeStats:
    """Counters used by the paper-figure benchmarks."""

    __slots__ = (
        "allocated",
        "live",
        "freed",
        "payload_copies",
        "copies_elided",
        "memo_entries",
        "memo_hits",
        "eager_finishes",
        "peak_live",
        "peak_bytes",
    )

    def __init__(self) -> None:
        self.allocated = 0
        self.live = 0
        self.freed = 0
        self.payload_copies = 0
        self.copies_elided = 0
        self.memo_entries = 0
        self.memo_hits = 0
        self.eager_finishes = 0
        self.peak_live = 0
        self.peak_bytes = 0

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


class Runtime:
    """The lazy-copy runtime: context stack, operations, and GC accounting."""

    def __init__(self, mode: CopyMode = CopyMode.LAZY_SR) -> None:
        self.mode = mode
        self.root_label = Label()
        # Definition 4: per-thread context stack, initialized with the
        # root label.  (Single-threaded here; SPMD shards in the array
        # platform play the role of threads.)
        self._context: List[Label] = [self.root_label]
        self.stats = RuntimeStats()
        self._labels: List[Label] = [self.root_label]

    # ------------------------------------------------------------------
    # context handling (Definition 4)
    # ------------------------------------------------------------------
    @property
    def context(self) -> Label:
        return self._context[-1]

    def _push_context(self, label: Label) -> None:
        self._context.append(label)

    def _pop_context(self) -> None:
        self._context.pop()

    # ------------------------------------------------------------------
    # reference counting (Section 3)
    # ------------------------------------------------------------------
    def _incref(self, v: Optional[Vertex]) -> None:
        if v is not None:
            v.shared += 1

    def _decref(self, v: Optional[Vertex]) -> None:
        """Iterative decref cascade (deep chains exceed recursion limits)."""
        if v is None:
            return
        worklist = [v]
        while worklist:
            w = worklist.pop()
            w.shared -= 1
            if w.shared == 0 and w.alive:
                worklist.extend(self._destroy(w))

    def _destroy(self, v: Vertex) -> List[Vertex]:
        """Rule 2: shared count hit zero — destroy, decrement weak.

        Returns the out-edge targets whose shared counts must now drop
        (handled by the caller's worklist).
        """
        v.alive = False
        self.stats.live -= 1
        # Dropping the payload releases the out-edges.
        children = [e.target for e in v.out_edges() if e.target is not None]
        v.payload.clear()
        v.weak -= 1
        if v.weak == 0:
            self._weak_zero(v)
        return children

    def _weak_zero(self, v: Vertex) -> None:
        """Rule 3: weak count hit zero — decrement memo."""
        v.memo -= 1
        if v.memo == 0:
            self._free(v)

    def _free(self, v: Vertex) -> None:
        """Rule 4: memo count hit zero — memory is freed."""
        self.stats.freed += 1

    def _memo_insert(self, label: Label, key: Vertex, value: Vertex) -> None:
        """Keys take a memo count only; values take a shared count."""
        if key.id in label.memo:
            old_key, old_value = label.memo[key.id]
            self._memo_drop_entry(old_key, old_value)
        key.memo += 1
        value.shared += 1
        value.memo_value_count += 1
        label.memo[key.id] = (key, value)
        self.stats.memo_entries += 1

    def _memo_drop_entry(self, key: Vertex, value: Vertex) -> None:
        value.memo_value_count -= 1
        key.memo -= 1
        if key.memo == 0 and key.weak == 0:
            self._free(key)
        self._decref(value)
        self.stats.memo_entries -= 1

    def sweep(self, label: Label) -> int:
        """Drop memo entries whose key has zero shared and weak count.

        The paper performs these sweeps when resizing and copying hash
        tables; we additionally expose it for explicit calls.  Returns the
        number of entries removed.
        """
        dead = [
            kid
            for kid, (key, _) in label.memo.items()
            if key.shared == 0 and not _weakly_held(key)
        ]
        for kid in dead:
            key, value = label.memo.pop(kid)
            self._memo_drop_entry(key, value)
        return len(dead)

    # ------------------------------------------------------------------
    # allocation and field access
    # ------------------------------------------------------------------
    def new(self, **fields: Any) -> Slot:
        """Create a new object in the current context (Condition 4)."""
        v = Vertex(self.context)
        self.stats.allocated += 1
        self.stats.live += 1
        self.stats.peak_live = max(self.stats.peak_live, self.stats.live)
        for name, value in fields.items():
            v.payload[name] = self._field_value(v, value)
        # The returned root slot holds the single shared reference that
        # the Vertex constructor initialized.
        return Slot(v, self.context)

    def _field_value(self, holder: Vertex, value: Any) -> Any:
        """Materialize an assigned value into a payload entry."""
        if isinstance(value, Slot):
            target, label = self._dup_edge(value)
            self._incref(target)
            return Slot(target, label)
        return value

    def _dup_edge(self, slot: Slot) -> Tuple[Optional[Vertex], Label]:
        """Duplicate a pointer, preserving Remark 1's invariant.

        Copying a pointer to a frozen single-reference-flagged vertex
        would create two in-edges with identical labels; per Section 3,
        GET is triggered on the edge first (which thaws or copies), after
        which the duplicate points at the new, unfrozen target.
        """
        v = slot.target
        if (
            self.mode.single_reference
            and v is not None
            and v.frozen
            and v.single_ref
        ):
            self.get(slot)
        return slot.target, slot.label

    def read(self, slot: Slot, name: str) -> Any:
        """Read ``slot.name``.

        Primitive reads trigger only a ``Pull`` (Algorithm 4) — "read-only
        access, copy not required".  Pointer-field reads trigger ``Get``
        on the holder, exactly as in the paper's Table 1 ("as each node in
        the list is accessed it must be copied"): the returned edge must
        carry correct sharing semantics, which requires the holder to be
        this label's own copy.  Pointer fields are returned as fresh root
        slots (duplicated edges); primitives as-is.
        """
        v = self.pull(slot)
        value = v.payload.get(name)
        if isinstance(value, Slot):
            v = self.get(slot)
            value = v.payload.get(name)
        if isinstance(value, Slot):
            target, label = self._dup_edge(value)
            self._incref(target)
            return Slot(target, label)
        return value

    def write(self, slot: Slot, name: str, value: Any) -> None:
        """Write ``slot.name = value`` — a ``Get`` (Algorithm 5) then mutation."""
        v = self.get(slot)
        self._push_context(v.label)  # Definition 4, case 2
        try:
            old = v.payload.get(name)
            v.payload[name] = self._field_value(v, value)
            if isinstance(old, Slot):
                self._decref(old.target)
        finally:
            self._pop_context()

    def method(self, slot: Slot) -> ContextManager[Vertex]:
        """Context manager emulating a member-function call on ``slot``.

        Inside the block the current context is ``f(v)`` so that freshly
        created objects take the vertex's label (Definition 4, case 2).
        """
        runtime = self
        v = runtime.get(slot)

        class _Ctx:
            def __enter__(self) -> Vertex:
                runtime._push_context(v.label)
                return v

            def __exit__(self, *exc: Any) -> None:
                runtime._pop_context()

        return _Ctx()

    def write_new(self, slot: Slot, name: str, **fields: Any) -> None:
        """Create a fresh object *in the context of* ``slot`` and assign it.

        This is how a member function extends a data structure: per
        Definition 4 the new vertex (and the new edge) take the label of
        the vertex being modified, keeping the program in the
        tree-structured pattern (no cross reference arises).
        """
        v = self.get(slot)
        self._push_context(v.label)
        try:
            child = self.new(**fields)
            old = v.payload.get(name)
            v.payload[name] = Slot(child.target, child.label)
            if isinstance(old, Slot):
                self._decref(old.target)
        finally:
            self._pop_context()

    def drop(self, slot: Slot) -> None:
        """Release a root variable (its shared reference)."""
        self._decref(slot.target)
        slot.target = None

    # ------------------------------------------------------------------
    # the paper's operations
    # ------------------------------------------------------------------
    def deep_copy(self, slot: Slot) -> Slot:
        """Algorithm 3 (lazy) or a physical recursive copy (eager mode)."""
        if slot.target is None:
            return Slot(None, self.context)
        if self.mode is CopyMode.EAGER:
            memo: Dict[int, Vertex] = {}
            u = self._eager_copy_vertex(slot.target, memo)
            self._incref(u)
            return Slot(u, self.root_label)
        # FREEZE(e); let l be a new label; m_l <- m_{h(e)}.
        self._freeze(slot)
        label = Label(parent=slot.label)
        self._labels.append(label)
        inherited = []
        for key, value in slot.label.memo.values():
            # Copying the hash table: sweep dead keys on the way through.
            if key.shared == 0 and not _weakly_held(key):
                continue
            self._memo_insert(label, key, value)
            inherited.append(value)
        # Freeze what the new label inherits.  ``_freeze`` above follows
        # payload edges without chasing memos and stops at a frozen
        # vertex, so the vertex an earlier copy-on-write made (a memo
        # value of the parent label) can still be writable; the new label
        # reaches it through the inherited entry, and a write through
        # either label would then change what the other reads.
        for value in inherited:
            self._freeze_from(value)
        self._incref(slot.target)
        return Slot(slot.target, label)

    def _eager_copy_vertex(self, root: Vertex, memo: Dict[int, Vertex]) -> Vertex:
        """Plain deep copy ("each vertex copied only once"), iterative."""

        def shell(v: Vertex) -> Vertex:
            u = Vertex(self.root_label)
            self.stats.allocated += 1
            self.stats.live += 1
            self.stats.peak_live = max(self.stats.peak_live, self.stats.live)
            self.stats.payload_copies += 1
            u.shared -= 1  # the referencing edge takes the constructor's ref
            memo[v.id] = u
            return u

        if root.id in memo:
            return memo[root.id]
        out = shell(root)
        worklist: List[Tuple[Vertex, Vertex]] = [(root, out)]
        while worklist:
            v, u = worklist.pop()
            for name, value in v.payload.items():
                if isinstance(value, Slot) and value.target is not None:
                    child = memo.get(value.target.id)
                    if child is None:
                        child = shell(value.target)
                        worklist.append((value.target, child))
                    self._incref(child)
                    u.payload[name] = Slot(child, self.root_label)
                else:
                    u.payload[name] = value
        return out

    def pull(self, slot: Slot) -> Vertex:
        """Algorithm 4: chase the memo ``m_l`` and retarget the edge."""
        v = slot.target
        if v is None:
            raise ValueError("nil pointer dereference")
        label = slot.label
        moved = False
        while v.id in label.memo:
            v = label.memo[v.id][1]
            self.stats.memo_hits += 1
            moved = True
        if moved:
            self._incref(v)
            self._decref(slot.target)
            slot.target = v
        return v

    def get(self, slot: Slot) -> Vertex:
        """Algorithm 5: Pull, then copy-on-write if the target is frozen."""
        v = self.pull(slot)
        if not v.frozen:
            return v
        label = slot.label
        u = self._copy(slot)
        if u is v:
            # Thawed in place (copy elimination) — nothing to retarget.
            return v
        # update t(e) <- u, and m_l(v) <- u unless Remark 1 applies.
        if not (self.mode.single_reference and v.single_ref):
            self._memo_insert(label, v, u)
        self._incref(u)
        self._decref(slot.target)
        slot.target = u
        return u

    def _copy(self, slot: Slot) -> Vertex:
        """Algorithm 6: shallow copy with eager handling of cross references.

        Out-edges ``d`` with ``h(d) != f(v)`` are cross references: they
        are Finished (pending lazy copies completed eagerly) and Frozen,
        then *shared* by the copy.  Tree edges are relabeled to the
        copying label ``l`` — the context during construction of the copy
        (Condition 4).
        """
        v = slot.target
        assert v is not None and v.frozen
        l = slot.label
        for d in v.out_edges():
            if d.label is not v.label and d.target is not None:
                self.stats.eager_finishes += 1
                self._finish(d, visited=set())
                self._freeze(d)
        # Copy elimination: sole reference and flagged -> thaw and reuse.
        if (
            self.mode.single_reference
            and v.single_ref
            and v.shared == 1
            and v.memo == 1
            and v.memo_value_count == 0
        ):
            # Reusing v as the copy relabels it to l; its tree out-edges
            # must be relabeled with it (exactly as a fresh copy would
            # have them), so their pending-copy chains stay correct.
            # Cross references were finished+frozen above and stay as-is.
            for d in v.out_edges():
                if d.label is v.label:
                    d.label = l
            v.frozen = False
            v.single_ref = False
            v.label = l
            self.stats.copies_elided += 1
            return v
        u = Vertex(l)
        self.stats.allocated += 1
        self.stats.live += 1
        self.stats.peak_live = max(self.stats.peak_live, self.stats.live)
        self.stats.payload_copies += 1
        for name, value in v.payload.items():
            if isinstance(value, Slot):
                self._incref(value.target)
                if value.label is not v.label:
                    # Cross reference: share the finished, frozen target.
                    u.payload[name] = Slot(value.target, value.label)
                else:
                    # Tree edge: the new edge takes the current context l.
                    u.payload[name] = Slot(value.target, l)
            else:
                u.payload[name] = value
        u.shared -= 1  # caller assumes the constructor's reference
        return u

    def _freeze(self, slot: Slot) -> None:
        """Algorithm 7, iteratively: mark the reachable subgraph read-only.

        At freeze time, Remark 1's flag is set for vertices whose
        in-degree is one and which do not appear in the range of a memo.
        """
        if slot.target is not None:
            self._freeze_from(slot.target)

    def _freeze_from(self, root: Vertex) -> None:
        stack = [root]
        while stack:
            v = stack.pop()
            if v.frozen:
                continue
            v.frozen = True
            if self.mode.single_reference:
                v.single_ref = v.shared == 1 and v.memo_value_count == 0
            for d in v.out_edges():
                if d.target is not None:
                    stack.append(d.target)

    def _finish(self, slot: Slot, visited: set) -> None:
        """Algorithm 8: complete all pending lazy copies in the subgraph."""
        if slot.target is None:
            return
        v = self.pull(slot)
        if slot.label is not v.label:
            v = self.get(slot)
        if v.id in visited:
            return
        visited.add(v.id)
        for d in v.out_edges():
            self._finish(d, visited)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def live_bytes(self) -> int:
        """Approximate live heap bytes under the byte model above."""
        lazy = self.mode.is_lazy
        total = 0
        seen_labels = 0
        for label in self._labels:
            seen_labels += 1
            total += _BYTES_PER_MEMO_ENTRY * len(label.memo)
        total += seen_labels * _BYTES_PER_OBJECT_HEADER
        per_obj = _BYTES_PER_OBJECT_HEADER + (
            _BYTES_PER_LAZY_OBJECT_EXTRA if lazy else 0
        )
        per_ptr = _BYTES_PER_POINTER + (_BYTES_PER_LAZY_POINTER_EXTRA if lazy else 0)
        # live vertices scanned via stats.live plus an estimated field
        # footprint; benchmarks that need exact numbers walk the graph.
        total += self.stats.live * (per_obj + 4 * _BYTES_PER_FIELD)
        total += self.stats.live * per_ptr
        self.stats.peak_bytes = max(self.stats.peak_bytes, total)
        return total


def _weakly_held(v: Vertex) -> bool:
    """Whether any weak references remain besides the shared-count hold.

    ``weak`` is initialized to one and holds an implicit reference for
    ``shared > 0`` (rule 2 decrements it when shared hits zero), so a
    destroyed vertex has ``weak == 0`` unless user weak pointers exist —
    we do not expose user weak pointers, so this reduces to ``weak > 0``
    for alive vertices and ``False`` for destroyed ones.
    """
    return v.alive and v.weak > 0
