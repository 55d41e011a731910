"""Delta streams — the engine's unit of data exchange.

TPU-native rebuild of differential-dataflow update semantics restricted to
totally-ordered times (the reference's engine time is a total order too:
src/engine/timestamp.rs — u64, even values mark batch boundaries). A delta is
`(key, values, diff)` with diff ∈ {+1, -1}; a batch is all deltas of one
logical time. Consolidation sums diffs of equal (key, values) pairs so
operators see a minimal change set.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Tuple

from pathway_tpu_torch.engine.value import Pointer, values_equal
from pathway_tpu_torch.internals import sanitizer as _sanitizer

# (key, values-tuple, diff)
Delta = Tuple[Pointer, tuple, int]


def consolidate(deltas: Iterable[Delta]) -> List[Delta]:
    """Sum diffs of identical (key, values); drop zero net changes. Keeps
    retractions before insertions per key so single-valued state transitions
    are well-ordered. Prefers the native C++ pass (native/wire_ext.cpp
    consolidate) and falls back to the normalizing python walk for batches
    holding unhashable values (ndarrays/lists/dicts)."""
    if not isinstance(deltas, list):
        deltas = list(deltas)
    native = _native_consolidate()
    if native is not None:
        try:
            return native(deltas)
        except TypeError:
            return _consolidate_unhashable(deltas)
    # fast path: pure insert batches with distinct keys (the bulk-ingest
    # shape) need no value hashing at all — only key uniqueness matters.
    # Both checks are single C-speed passes.
    all_insert = True
    for d in deltas:
        if d[2] < 0:
            all_insert = False
            break
    if all_insert and len({d[0] for d in deltas}) == len(deltas):
        return deltas
    acc: dict = {}
    get = acc.get
    try:
        # common case: values tuples of plain hashables — group directly
        # (key, values) -> summed diff; dict insertion order preserves
        # first-seen order
        for key, values, diff in deltas:
            g = (key, values)
            prev = get(g)
            acc[g] = diff if prev is None else prev + diff
    except TypeError:
        return _consolidate_unhashable(deltas)
    # retractions first, insertions second; stable within each class
    neg = []
    pos = []
    for (key, values), diff in acc.items():
        if diff == 0:
            continue
        (neg if diff < 0 else pos).append((key, values, diff))
    return neg + pos


def _consolidate_unhashable(deltas: List[Delta]) -> List[Delta]:
    """Consolidation for batches holding ndarrays/lists/dicts — the
    normalizing walk (rare path; correctness over speed)."""
    acc: dict = {}
    originals: dict = {}
    for key, values, diff in deltas:
        try:
            g = (key, _hashable(values))
        except TypeError:
            g = (key, id(values))
        prev = acc.get(g)
        acc[g] = diff if prev is None else prev + diff
        if prev is None:
            originals[g] = values
    neg = []
    pos = []
    for g, diff in acc.items():
        if diff == 0:
            continue
        (neg if diff < 0 else pos).append((g[0], originals[g], diff))
    return neg + pos


_native_consolidate_fn = None
_native_consolidate_checked = False


def _native_consolidate():
    global _native_consolidate_fn, _native_consolidate_checked
    if not _native_consolidate_checked:
        _native_consolidate_checked = True
        try:
            from pathway_tpu_torch import native

            ext = native.load_wire_ext()
            if ext is not None:
                _native_consolidate_fn = ext.consolidate
        except Exception:  # noqa: BLE001 — python path is always correct
            _native_consolidate_fn = None
    return _native_consolidate_fn


def _hashable(values: tuple):
    return tuple(_hashable_one(v) for v in values)


def _hashable_one(v: Any):
    import numpy as np

    if isinstance(v, np.ndarray):
        return (v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable_one(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable_one(x)) for k, x in v.items()))
    return v


_ABSENT = object()


class TableState:
    """Materialized current content of a stream: key -> values tuple.

    Enforces the unique-key-per-universe invariant (a Pathway table is a
    keyed collection, not a general multiset) — except in ``multiset``
    mode, used to materialize *event streams* (``to_stream`` outputs),
    where the same key legitimately recurs across batches (reference:
    dataflow.rs table_to_stream:3098 emits per-event insertions keyed by
    the original row). There, rows are stored under synthetic
    ``(key, seq)`` ids."""

    __slots__ = ("rows", "multiset", "_index", "_next")

    def __init__(self, multiset: bool = False):
        self.rows: dict = {}
        self.multiset = multiset
        self._index: dict = {}
        self._next = 0

    def apply(self, deltas: Iterable[Delta], *, source: str = "") -> None:
        if _sanitizer.ACTIVE:
            _sanitizer.tracker().note_multiset()
        if self.multiset:
            self._apply_multiset(deltas, source)
            return
        rows = self.rows
        pop = rows.pop
        get = rows.get
        for key, values, diff in deltas:
            if diff == -1:
                if pop(key, _ABSENT) is _ABSENT:
                    if _sanitizer.ACTIVE:
                        _sanitizer.tracker().multiset_violation(source, key)
                    raise KeyError(
                        f"{source}: retraction of absent key {key!r}"
                    )
            elif diff == 1:
                prev = get(key)
                if prev is not None and not values_equal_tuple(prev, values):
                    raise KeyError(
                        f"{source}: duplicate key {key!r}: "
                        f"{prev!r} vs {values!r}"
                    )
                rows[key] = values
            elif diff < 0:
                for _ in range(-diff):
                    if pop(key, _ABSENT) is _ABSENT:
                        if _sanitizer.ACTIVE:
                            _sanitizer.tracker().multiset_violation(
                                source, key
                            )
                        raise KeyError(
                            f"{source}: retraction of absent key {key!r}"
                        )
            else:
                for _ in range(diff):
                    prev = get(key)
                    if prev is not None and not values_equal_tuple(
                        prev, values
                    ):
                        raise KeyError(
                            f"{source}: duplicate key {key!r}: "
                            f"{prev!r} vs {values!r}"
                        )
                    rows[key] = values

    def _apply_multiset(self, deltas: Iterable[Delta], source: str) -> None:
        for key, values, diff in deltas:
            if diff > 0:
                for _ in range(diff):
                    sid = self._next
                    self._next += 1
                    self.rows[(key, sid)] = values
                    self._index.setdefault(key, []).append(sid)
            else:
                for _ in range(-diff):
                    sids = self._index.get(key) or []
                    for sid in sids:
                        if values_equal_tuple(self.rows[(key, sid)], values):
                            del self.rows[(key, sid)]
                            sids.remove(sid)
                            break
                    else:
                        if _sanitizer.ACTIVE:
                            _sanitizer.tracker().multiset_violation(
                                source, key
                            )
                        raise KeyError(
                            f"{source}: retraction of absent row {key!r}"
                        )

    def snapshot_deltas(self) -> List[Delta]:
        if self.multiset:
            return [(k, v, 1) for (k, _sid), v in self.rows.items()]
        return [(k, v, 1) for k, v in self.rows.items()]


def values_equal_tuple(a: tuple, b: tuple) -> bool:
    if a is b:
        return True
    try:
        # plain scalars compare at C speed; ndarrays make `==` return an
        # array whose truthiness raises, falling through to the slow path
        eq = a == b
        if eq is True:
            return True
        if eq is False and _all_scalar(a) and _all_scalar(b):
            return False
    except (TypeError, ValueError):
        pass
    if len(a) != len(b):
        return False
    return all(values_equal(x, y) for x, y in zip(a, b))


# float excluded: values_equal treats NaN == NaN as True, so a False from
# plain tuple comparison is not authoritative when floats are present
_SCALAR_TYPES = (str, int, bool, bytes, type(None), Pointer)


def _all_scalar(values: tuple) -> bool:
    return all(isinstance(v, _SCALAR_TYPES) for v in values)
