"""Stateful dataflow operators: joins, reductions, lookups, universe algebra.

TPU-native rebuild of the reference's differential operators (reference:
src/engine/dataflow.rs join_tables:2691, group_by_table, ix_table;
src/engine/reduce.rs). Instead of differential arrangements, each operator
keeps keyed state and recomputes *affected groups* per micro-batch, emitting
consolidated retract/insert diffs — the same observable semantics
(retractions, batch-boundary consistency) with a much simpler state model.
Group-level recomputation also batches naturally onto numpy/XLA for numeric
aggregations.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.exchange import exchange_by_value
from pathway_tpu_torch.engine.stream import (
    Delta,
    TableState,
    consolidate,
    values_equal_tuple,
)
from pathway_tpu_torch.engine.value import ERROR, Error, Pointer, ref_scalar
from pathway_tpu_torch.internals import provenance as _provenance


class _DiffCache:
    """Per-group emitted-output cache; diffing against it yields minimal
    retract/insert sets."""

    __slots__ = ("emitted",)

    def __init__(self):
        # group -> {out_key: row}
        self.emitted: Dict[Any, Dict[Pointer, tuple]] = {}

    def diff(self, group: Any, new_rows: Dict[Pointer, tuple], out: List[Delta]):
        old_rows = self.emitted.get(group, {})
        for k, row in old_rows.items():
            if k not in new_rows or not values_equal_tuple(new_rows[k], row):
                out.append((k, row, -1))
        for k, row in new_rows.items():
            if k not in old_rows or not values_equal_tuple(old_rows[k], row):
                out.append((k, row, 1))
        if new_rows:
            self.emitted[group] = new_rows
        else:
            self.emitted.pop(group, None)


BatchFn = Callable[[List[Pointer], Tuple[List[tuple], ...]], List[Any]]


class JoinNode(Node):
    """Binary equi-join with optional outer sides (reference: join_tables,
    src/engine/dataflow.rs:2691; JoinType in graph.rs).

    Output rows are `(left_id, right_id, *left_row, *right_row)`; unmatched
    sides are None-padded. Row ids derive from side ids per `id_mode`
    ('both' = hash(l, r), 'left', 'right').
    """

    name = "join"
    path = "classic"
    snapshot_attrs = ('left_index', 'right_index', 'cache')

    def __init__(
        self,
        engine: Engine,
        left: Node,
        right: Node,
        left_key_fn: BatchFn,
        right_key_fn: BatchFn,
        *,
        left_width: int,
        right_width: int,
        left_outer: bool = False,
        right_outer: bool = False,
        id_mode: str = "both",
        exact_match: bool = False,
    ):
        # multi-worker: co-locate rows by join value so each jv bucket is
        # complete on one worker (reference: shard.rs exchange pact)
        left = exchange_by_value(engine, left, left_key_fn)
        right = exchange_by_value(engine, right, right_key_fn)
        super().__init__(engine, [left, right])
        self.left_key_fn = left_key_fn
        self.right_key_fn = right_key_fn
        self.left_width = left_width
        self.right_width = right_width
        self.left_outer = left_outer
        self.right_outer = right_outer
        self.id_mode = id_mode
        # jv -> {row_key: row}
        self.left_index: Dict[Any, Dict[Pointer, tuple]] = {}
        self.right_index: Dict[Any, Dict[Pointer, tuple]] = {}
        self.cache = _DiffCache()
        # Inner joins with hash-pair ids are bilinear: emit
        # ΔL⋈R_old + L_new⋈ΔR directly, O(delta·match) per batch, no
        # emitted-output cache. Outer joins and id=left/right (which need
        # pad-row transitions / duplicate-id detection) keep the
        # affected-bucket diff path.
        self._delta_mode = (
            not left_outer and not right_outer and id_mode == "both"
        )

    def _apply_side(
        self, index: Dict, deltas: List[Delta], key_fn: BatchFn, affected: Set
    ) -> None:
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        jvs = key_fn(keys, rows)
        for (key, values, diff), jv in zip(deltas, jvs):
            if isinstance(jv, Error):
                self.log_error("Error value in join condition")
                continue
            jv = _freeze(jv)
            affected.add(jv)
            bucket = index.setdefault(jv, {})
            if diff > 0:
                bucket[key] = values
            else:
                bucket.pop(key, None)
                if not bucket:
                    del index[jv]

    def _out_id(self, lk: Optional[Pointer], rk: Optional[Pointer]) -> Pointer:
        if self.id_mode == "left" and lk is not None:
            return lk
        if self.id_mode == "right" and rk is not None:
            return rk
        return ref_scalar(lk, rk)

    def _jvs_of(self, deltas: List[Delta], key_fn: BatchFn) -> List[Any]:
        if not deltas:
            return []
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        return key_fn(keys, rows)

    @staticmethod
    def _index_apply(index: Dict, jv: Any, key: Pointer, row: tuple, diff: int) -> None:
        bucket = index.setdefault(jv, {})
        if diff > 0:
            bucket[key] = row
        else:
            bucket.pop(key, None)
            if not bucket:
                del index[jv]

    def _delta_side(
        self,
        deltas: List[Delta],
        jvs: List[Any],
        own_index: Dict,
        other_index: Dict,
        left_side: bool,
        out: List[Delta],
    ) -> None:
        """Join one side's deltas against the other side's current index,
        applying each delta to the own index as it streams past."""
        for (key, row, diff), jv in zip(deltas, jvs):
            if isinstance(jv, Error):
                self.log_error("Error value in join condition")
                continue
            jv = _freeze(jv)
            for okey, orow in other_index.get(jv, {}).items():
                if left_side:
                    lk, lrow, rk, rrow = key, row, okey, orow
                else:
                    lk, lrow, rk, rrow = okey, orow, key, row
                out.append((ref_scalar(lk, rk), (lk, rk, *lrow, *rrow), diff))
            self._index_apply(own_index, jv, key, row, diff)

    def _process_delta(self, left_deltas: List[Delta], right_deltas: List[Delta], time: int) -> None:
        """Bilinear inner-join update: ΔL⋈R_old, then L_new⋈ΔR."""
        out: List[Delta] = []
        left_jvs = self._jvs_of(left_deltas, self.left_key_fn)
        right_jvs = self._jvs_of(right_deltas, self.right_key_fn)
        self._delta_side(
            left_deltas, left_jvs, self.left_index, self.right_index, True, out
        )
        self._delta_side(
            right_deltas, right_jvs, self.right_index, self.left_index, False, out
        )
        if _provenance.ACTIVE:
            _provenance.tracker().record_join(self, time, out)
        self.emit(time, out)

    def process(self, time: int) -> None:
        left_deltas = self.take(0)
        right_deltas = self.take(1)
        if not left_deltas and not right_deltas:
            return
        self.rows_processed += len(left_deltas) + len(right_deltas)
        self.batches_processed += 1
        if self._delta_mode:
            self._process_delta(left_deltas, right_deltas, time)
            return
        affected: Set = set()
        self._apply_side(self.left_index, left_deltas, self.left_key_fn, affected)
        self._apply_side(self.right_index, right_deltas, self.right_key_fn, affected)
        out: List[Delta] = []
        l_nones = (None,) * self.left_width
        r_nones = (None,) * self.right_width
        for jv in affected:
            lefts = self.left_index.get(jv, {})
            rights = self.right_index.get(jv, {})
            new_rows: Dict[Pointer, tuple] = {}
            if lefts and rights:
                for lk, lrow in lefts.items():
                    for rk, rrow in rights.items():
                        out_id = self._out_id(lk, rk)
                        if out_id in new_rows:
                            self.log_error(
                                f"join: duplicate row id {out_id!r} "
                                "(id= side matches multiple rows)"
                            )
                            continue
                        new_rows[out_id] = (lk, rk, *lrow, *rrow)
            elif lefts and self.left_outer:
                for lk, lrow in lefts.items():
                    new_rows[self._out_id(lk, None)] = (lk, None, *lrow, *r_nones)
            elif rights and self.right_outer:
                for rk, rrow in rights.items():
                    new_rows[self._out_id(None, rk)] = (None, rk, *l_nones, *rrow)
            self.cache.diff(jv, new_rows, out)
        if _provenance.ACTIVE:
            _provenance.tracker().record_join(self, time, out)
        self.emit(time, out)


def _freeze(v):
    from pathway_tpu_torch.engine.stream import _hashable_one

    if isinstance(v, tuple):
        return tuple(_hashable_one(x) for x in v)
    return _hashable_one(v)


class _GroupState:
    """Per-group reduce state: keyed rows (the correctness fallback and the
    source of original (args, t, s) for retractions) + one incremental
    accumulator per reducer (None = permanently on the full-recompute path
    for this group). `order_heap` lazily tracks the earliest surviving row,
    whose gvals the emitted group row carries (rows sharing a gkey normally
    share gvals, but groupby(id=...) can mix them)."""

    __slots__ = ("bucket", "accs", "order_heap")

    def __init__(self, accs: List[Any]):
        # row_key -> (gvals, args-per-reducer, t, s)
        self.bucket: Dict[Pointer, tuple] = {}
        self.accs = accs
        self.order_heap: list = []  # (t, s, row_key)

    def push_order(self, t, s, row_key) -> None:
        heapq.heappush(self.order_heap, (t, s, row_key))
        if len(self.order_heap) > 2 * len(self.bucket) + 16:
            self.order_heap = [
                node for node in self.order_heap
                if self._live(node)
            ]
            heapq.heapify(self.order_heap)

    def _live(self, node) -> bool:
        entry = self.bucket.get(node[2])
        return entry is not None and entry[2] == node[0] and entry[3] == node[1]

    def gvals(self) -> tuple:
        while self.order_heap:
            node = self.order_heap[0]
            if self._live(node):
                return self.bucket[node[2]][0]
            heapq.heappop(self.order_heap)
        raise KeyError("gvals of empty group")


class ReduceNode(Node):
    """groupby().reduce() (reference: group_by_table, src/engine/reduce.rs).

    `group_fn` returns (group_key, group_values) per row; `args_fns` yields
    each reducer's argument tuple per row. Semigroup reducers are maintained
    incrementally in O(delta) per group (reference: reduce.rs:47-67);
    reducers without accumulators (tuple/ndarray/custom-without-retract) or
    groups that hit non-incremental inputs recompute from the keyed row set.
    """

    name = "reduce"
    path = "classic"
    snapshot_attrs = ('groups', 'cache', '_seq')

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        group_fn: Callable[..., List[Tuple[Pointer, tuple]]],
        reducers: List[Any],  # Reducer specs
        args_fns: List[BatchFn],
        *,
        gval_width: int,
        sort_fn: Optional[BatchFn] = None,
    ):
        # multi-worker: co-locate rows by group key (output keys == gkey,
        # so the result lands on its owner with no output exchange)
        input_ = exchange_by_value(
            engine, input_, lambda keys, rows: [gk for gk, _ in group_fn(keys, rows)]
        )
        super().__init__(engine, [input_])
        self.group_fn = group_fn
        self.reducers = reducers
        self.args_fns = args_fns
        self.gval_width = gval_width
        self.sort_fn = sort_fn
        self.groups: Dict[Pointer, _GroupState] = {}
        self.cache = _DiffCache()
        self._seq = 0

    def _new_group(self) -> _GroupState:
        accs = [
            r.make_acc() if getattr(r, "make_acc", None) is not None else None
            for r in self.reducers
        ]
        return _GroupState(accs)

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self.rows_processed += len(deltas)
        self.batches_processed += 1
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        gks = self.group_fn(keys, rows)
        per_reducer_args = [fn(keys, rows) for fn in self.args_fns]
        sort_vals = self.sort_fn(keys, rows) if self.sort_fn is not None else None
        affected: Set[Pointer] = set()
        contrib: Optional[Dict[Any, list]] = (
            {} if _provenance.ACTIVE else None
        )
        for i, (key, values, diff) in enumerate(deltas):
            gkey, gvals = gks[i]
            if isinstance(gkey, Error):
                self.log_error("Error value in groupby key")
                continue
            affected.add(gkey)
            if contrib is not None:
                contrib.setdefault(_provenance.key_str(gkey), []).append(key)
            st = self.groups.get(gkey)
            if st is None:
                st = self._new_group()
                self.groups[gkey] = st
            if diff > 0:
                self._seq += 1
                args = tuple(col[i] for col in per_reducer_args)
                if sort_vals is not None:
                    # sort_by overrides arrival order for order-sensitive
                    # reducers (tuple/earliest/latest)
                    t, s = 0, sort_vals[i]
                else:
                    t, s = time, self._seq
                st.bucket[key] = (gvals, args, t, s)
                st.push_order(t, s, key)
                for r_idx, acc in enumerate(st.accs):
                    if acc is None:
                        continue
                    try:
                        acc.insert(key, args[r_idx], t, s)
                    except Exception:  # noqa: BLE001
                        st.accs[r_idx] = None  # full-recompute from now on
            else:
                entry = st.bucket.pop(key, None)
                if entry is not None:
                    _gv, args, t, s = entry
                    for r_idx, acc in enumerate(st.accs):
                        if acc is None:
                            continue
                        try:
                            acc.retract(key, args[r_idx], t, s)
                        except Exception:  # noqa: BLE001
                            st.accs[r_idx] = None
                if not st.bucket:
                    del self.groups[gkey]
        out: List[Delta] = []
        for gkey in affected:
            st = self.groups.get(gkey)
            new_rows: Dict[Pointer, tuple] = {}
            if st is not None and st.bucket:
                results = []
                entries = None  # materialized lazily, only for fallbacks
                for r_idx, reducer in enumerate(self.reducers):
                    acc = st.accs[r_idx]
                    try:
                        if acc is not None:
                            results.append(acc.result())
                        else:
                            if entries is None:
                                entries = list(st.bucket.items())
                            r_entries = [
                                (rk, e[1][r_idx], e[2], e[3]) for rk, e in entries
                            ]
                            results.append(reducer.compute(r_entries))
                    except Exception as exc:  # noqa: BLE001
                        self.log_error(
                            f"reducer {reducer.name}: {type(exc).__name__}: {exc}"
                        )
                        results.append(ERROR)
                new_rows[gkey] = (*st.gvals(), *results)
            self.cache.diff(gkey, new_rows, out)
        if contrib is not None:
            _provenance.tracker().record_reduce(self, time, out, contrib)
        self.emit(time, out)


class IxNode(Node):
    """Keyed lookup `target.ix(keys)` (reference: ix_table, graph.rs).

    Output universe = the keys table's; columns = target's row at the pointer
    value. `optional` pads missing targets with None, otherwise they produce
    Error rows.
    """

    name = "ix"
    snapshot_attrs = ('source_ptr', 'target_state', 'reverse', 'cache')

    def __init__(
        self,
        engine: Engine,
        source: Node,
        target: Node,
        key_fn: BatchFn,
        *,
        target_width: int,
        optional: bool = False,
    ):
        # multi-worker: ship each source row to the worker owning the
        # pointed-at target key (targets already live at their own keys);
        # the construction site re-exchanges output back to skey's owner
        source = exchange_by_value(engine, source, key_fn)
        super().__init__(engine, [source, target])
        self.key_fn = key_fn
        self.target_width = target_width
        self.optional = optional
        self.source_ptr: Dict[Pointer, Optional[Pointer]] = {}
        self.target_state = TableState()
        self.reverse: Dict[Pointer, Set[Pointer]] = {}
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        source_deltas = self.take(0)
        target_deltas = self.take(1)
        if not source_deltas and not target_deltas:
            return
        affected: Set[Pointer] = set()
        if source_deltas:
            keys = [d[0] for d in source_deltas]
            rows = ([d[1] for d in source_deltas],)
            ptrs = self.key_fn(keys, rows)
            for (key, values, diff), ptr in zip(source_deltas, ptrs):
                affected.add(key)
                old_ptr = self.source_ptr.get(key)
                if diff > 0:
                    self.source_ptr[key] = ptr
                    if isinstance(ptr, Pointer):
                        self.reverse.setdefault(ptr, set()).add(key)
                else:
                    self.source_ptr.pop(key, None)
                    if isinstance(old_ptr, Pointer):
                        self.reverse.get(old_ptr, set()).discard(key)
        if target_deltas:
            self.target_state.apply(target_deltas, source=self.name)
            for tkey, _, _ in target_deltas:
                affected.update(self.reverse.get(tkey, ()))
        out: List[Delta] = []
        for skey in affected:
            new_rows: Dict[Pointer, tuple] = {}
            if skey in self.source_ptr:
                ptr = self.source_ptr[skey]
                if isinstance(ptr, Error):
                    new_rows[skey] = (ERROR,) * self.target_width
                elif ptr is None:
                    if self.optional:
                        new_rows[skey] = (None,) * self.target_width
                    else:
                        self.log_error("ix: None key (use optional=True)")
                        new_rows[skey] = (ERROR,) * self.target_width
                else:
                    row = self.target_state.rows.get(ptr)
                    if row is not None:
                        new_rows[skey] = row
                    elif self.optional:
                        new_rows[skey] = (None,) * self.target_width
                    else:
                        self.log_error(f"ix: missing key {ptr!r}")
                        new_rows[skey] = (ERROR,) * self.target_width
            self.cache.diff(skey, new_rows, out)
        self.emit(time, out)


class SemijoinNode(Node):
    """intersect / difference / restrict / having (reference:
    intersect_tables, subtract_table, restrict_table in graph.rs).

    Keeps input rows whose key is (or is not) present in the filter input.
    `filter_key_fn` maps filter rows to the keys they assert (identity for
    intersect, a column value for `having`).
    """

    name = "semijoin"
    snapshot_attrs = ('input_state', 'filter_counts', 'cache')

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        filter_: Node,
        *,
        keep_present: bool = True,
        filter_key_fn: Optional[BatchFn] = None,
    ):
        if filter_key_fn is not None:
            # multi-worker: filter rows assert arbitrary keys (`having`) —
            # ship each assertion to the asserted key's owner
            filter_ = exchange_by_value(engine, filter_, filter_key_fn)
        super().__init__(engine, [input_, filter_])
        self.keep_present = keep_present
        self.filter_key_fn = filter_key_fn
        self.input_state = TableState()
        self.filter_counts: Dict[Pointer, int] = {}
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        input_deltas = self.take(0)
        filter_deltas = self.take(1)
        if not input_deltas and not filter_deltas:
            return
        affected: Set[Pointer] = set()
        if input_deltas:
            self.input_state.apply(input_deltas, source=self.name)
            affected.update(d[0] for d in input_deltas)
        if filter_deltas:
            if self.filter_key_fn is not None:
                keys = [d[0] for d in filter_deltas]
                rows = ([d[1] for d in filter_deltas],)
                fkeys = self.filter_key_fn(keys, rows)
            else:
                fkeys = [d[0] for d in filter_deltas]
            for (key, values, diff), fkey in zip(filter_deltas, fkeys):
                if not isinstance(fkey, Pointer):
                    continue
                self.filter_counts[fkey] = self.filter_counts.get(fkey, 0) + diff
                if self.filter_counts[fkey] <= 0:
                    del self.filter_counts[fkey]
                affected.add(fkey)
        out: List[Delta] = []
        for key in affected:
            new_rows: Dict[Pointer, tuple] = {}
            row = self.input_state.rows.get(key)
            present = self.filter_counts.get(key, 0) > 0
            if row is not None and present == self.keep_present:
                new_rows[key] = row
            self.cache.diff(key, new_rows, out)
        self.emit(time, out)


class ConcatNode(Node):
    """Disjoint union (reference: concat_tables). A key collision means
    the build-time disjointness promise was false — fail the run like the
    reference's `duplicated entries for key` KeyError."""

    name = "concat"
    snapshot_attrs = ('owner',)

    def __init__(self, engine: Engine, inputs: List[Node]):
        super().__init__(engine, inputs)
        # key -> input port owning it
        self.owner: Dict[Pointer, int] = {}

    def process(self, time: int) -> None:
        # retractions apply before insertions within one timestamp, so a
        # key legitimately MOVING between inputs at time T (retract on one
        # port, insert on another) is not misread as a duplicate
        out: List[Delta] = []
        inserts: List[Tuple[int, Delta]] = []
        for port in range(len(self.inputs)):
            for key, values, diff in self.take(port):
                if diff > 0:
                    inserts.append((port, (key, values, diff)))
                else:
                    if self.owner.get(key) == port:
                        del self.owner[key]
                        out.append((key, values, diff))
                    else:
                        # a non-owner retraction must not delete the
                        # owner's row downstream
                        self.log_error(
                            f"concat: retraction of non-owned key {key!r}"
                        )
        for port, (key, values, diff) in inserts:
            cur = self.owner.get(key)
            if cur is not None and cur != port:
                raise KeyError(
                    f"duplicated entries for key {key!r} in concat"
                )
            self.owner[key] = port
            out.append((key, values, diff))
        self.emit(time, out)


class UpdateRowsNode(Node):
    """update_rows: rows of `other` override rows of `self` per key
    (reference: update_rows_table, graph.rs)."""

    name = "update_rows"
    snapshot_attrs = ('base_state', 'other_state', 'cache')

    def __init__(self, engine: Engine, base: Node, other: Node):
        super().__init__(engine, [base, other])
        self.base_state = TableState()
        self.other_state = TableState()
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        base_deltas = self.take(0)
        other_deltas = self.take(1)
        if not base_deltas and not other_deltas:
            return
        affected: Set[Pointer] = set()
        if base_deltas:
            self.base_state.apply(base_deltas, source=self.name)
            affected.update(d[0] for d in base_deltas)
        if other_deltas:
            self.other_state.apply(other_deltas, source=self.name)
            affected.update(d[0] for d in other_deltas)
        out: List[Delta] = []
        for key in affected:
            new_rows: Dict[Pointer, tuple] = {}
            row = self.other_state.rows.get(key, self.base_state.rows.get(key))
            if row is not None:
                new_rows[key] = row
            self.cache.diff(key, new_rows, out)
        self.emit(time, out)


class FlattenNode(Node):
    """flatten a sequence column into one row per element (reference:
    flatten_table, graph.rs). Element keys derive deterministically from
    (parent key, position) via an xor-multiply-shift finalizer — non-linear,
    so numerically adjacent parent keys cannot alias (key_a + i_a == key_b +
    i_b no longer collides), stable across workers/restarts, and still much
    cheaper than a cryptographic hash on the bulk-ingest path."""

    name = "flatten"
    path = "classic"

    # odd 128-bit mix constants (golden-ratio style)
    _MIX = 0x9E3779B97F4A7C15F39CC0605CEDC835
    _MIX2 = 0xC6A4A7935BD1E995C2B2AE3D27D4EB4F
    _MASK = (1 << 128) - 1

    def __init__(self, engine: Engine, input_: Node, flat_idx: int):
        super().__init__(engine, [input_])
        self.flat_idx = flat_idx

    @classmethod
    def _derive_key(cls, key: Pointer, i: int) -> Pointer:
        # splitmix-style 128-bit finalizer over (key, position): xor then
        # multiply then xor-shift twice.  The xor/shift steps break the
        # additive structure a bare multiply preserves.
        x = (key.value ^ ((i + 1) * cls._MIX2)) & cls._MASK
        x ^= x >> 67
        x = (x * cls._MIX) & cls._MASK
        x ^= x >> 64
        x = (x * cls._MIX2) & cls._MASK
        x ^= x >> 67
        return Pointer(x)

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self.rows_processed += len(deltas)
        self.batches_processed += 1
        out: List[Delta] = []
        lineage: Optional[list] = [] if _provenance.ACTIVE else None
        for key, values, diff in deltas:
            seq = values[self.flat_idx]
            if isinstance(seq, Error):
                self.log_error("flatten: Error value")
                continue
            if seq is None:
                continue
            from pathway_tpu_torch.engine.value import Json

            if isinstance(seq, Json):
                # only Json ARRAYS flatten; a dict would iterate raw str
                # keys under a Json-typed column (reference treats
                # non-array Json as an error row)
                if not isinstance(seq.value, list):
                    self.log_error(
                        f"flatten: Json value is not an array: {seq!r}"
                    )
                    continue
                elements: Any = [Json(v) for v in seq.value]
            elif isinstance(seq, str):
                elements = list(seq)
            else:
                try:
                    elements = list(seq)
                except TypeError:
                    self.log_error(f"flatten: not a sequence: {seq!r}")
                    continue
            for i, elem in enumerate(elements):
                new_key = self._derive_key(key, i)
                new_row = (
                    values[: self.flat_idx] + (elem,) + values[self.flat_idx + 1 :]
                )
                out.append((new_key, new_row, diff))
                if lineage is not None:
                    lineage.append((new_key, key, diff))
        if lineage is not None:
            _provenance.tracker().record_flatten(self, time, lineage)
        self.emit(time, out)


class SortNode(Node):
    """sort → prev/next pointer columns per instance (reference:
    operators/prev_next.rs:891, sort_table dataflow.rs:2283)."""

    name = "sort"
    snapshot_attrs = ('rows', 'cache')

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        key_fn: BatchFn,
        instance_fn: Optional[BatchFn] = None,
    ):
        # multi-worker: a sort instance is a total order — co-locate it
        # (no instance column = one global order on one worker)
        input_ = exchange_by_value(
            engine,
            input_,
            instance_fn or (lambda keys, rows: [None] * len(keys)),
        )
        super().__init__(engine, [input_])
        self.key_fn = key_fn
        self.instance_fn = instance_fn
        # row_key -> (sort_value, instance)
        self.rows: Dict[Pointer, tuple] = {}
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        sort_vals = self.key_fn(keys, rows)
        instances = (
            self.instance_fn(keys, rows)
            if self.instance_fn is not None
            else [None] * len(keys)
        )
        affected_instances: Set = set()
        for (key, values, diff), sv, inst in zip(deltas, sort_vals, instances):
            inst = _freeze(inst)
            affected_instances.add(inst)
            if diff > 0:
                self.rows[key] = (sv, inst)
            else:
                self.rows.pop(key, None)
        out: List[Delta] = []
        for inst in affected_instances:
            members = sorted(
                ((sv, k) for k, (sv, i) in self.rows.items() if i == inst),
            )
            new_rows: Dict[Pointer, tuple] = {}
            for pos, (sv, k) in enumerate(members):
                prev_k = members[pos - 1][1] if pos > 0 else None
                next_k = members[pos + 1][1] if pos + 1 < len(members) else None
                new_rows[k] = (prev_k, next_k)
            self.cache.diff(inst, new_rows, out)
        self.emit(time, out)


class DeduplicateNode(Node):
    """pw.stateful.deduplicate — keep the latest accepted value per instance
    (reference: Graph::deduplicate, stdlib/stateful/deduplicate.py)."""

    name = "deduplicate"
    snapshot_attrs = ('current', 'cache')

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        value_fn: BatchFn,
        instance_fn: Optional[BatchFn],
        acceptor: Callable[[Any, Any], bool],
    ):
        # multi-worker: deduplication is a per-instance total order
        input_ = exchange_by_value(
            engine,
            input_,
            instance_fn or (lambda keys, rows: [None] * len(keys)),
        )
        super().__init__(engine, [input_])
        self.value_fn = value_fn
        self.instance_fn = instance_fn
        self.acceptor = acceptor
        # instance -> (value, full_row)
        self.current: Dict[Any, tuple] = {}
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        values = self.value_fn(keys, rows)
        instances = (
            self.instance_fn(keys, rows)
            if self.instance_fn is not None
            else [None] * len(keys)
        )
        affected: Set = set()
        for (key, row, diff), val, inst in zip(deltas, values, instances):
            if diff <= 0:
                continue  # dedup consumes an append-only stream
            inst = _freeze(inst)
            cur = self.current.get(inst)
            try:
                accept = cur is None or self.acceptor(val, cur[0])
            except Exception as exc:  # noqa: BLE001
                self.log_error(f"deduplicate acceptor: {type(exc).__name__}: {exc}")
                continue
            if accept:
                self.current[inst] = (val, row)
                affected.add(inst)
        out: List[Delta] = []
        for inst in affected:
            val, row = self.current[inst]
            out_key = ref_scalar("dedup", inst)
            self.cache.diff(inst, {out_key: row}, out)
        self.emit(time, out)


class GradualBroadcastNode(Node):
    """`t._gradual_broadcast(threshold, lower, value, upper)` (reference:
    src/engine/dataflow/operators/gradual_broadcast.rs:491).

    Attaches an `apx_value` column to every input row: a deterministic
    per-key fraction in [0,1) decides whether the row reads `upper` or
    `lower`, with the share of `upper` rows equal to
    (value - lower) / (upper - lower). As `value` moves, only the rows
    whose fraction crosses the moving threshold flip — the "gradual" part
    that avoids retracting the whole table at once (ALS-style use)."""

    name = "gradual_broadcast"

    snapshot_attrs = ("rows", "threshold_rows", "threshold", "cache")

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        threshold_node: Node,
        lower_prog: BatchFn,
        value_prog: BatchFn,
        upper_prog: BatchFn,
    ):
        from pathway_tpu_torch.engine.exchange import exchange_broadcast

        # the threshold table is tiny and global: replicate it to every
        # worker so each can interpolate its own rows (the reference
        # broadcasts the arrangement the same way)
        threshold_node = exchange_broadcast(engine, threshold_node)
        super().__init__(engine, [input_, threshold_node])
        self.lower_prog = lower_prog
        self.value_prog = value_prog
        self.upper_prog = upper_prog
        self.rows: Dict[Pointer, tuple] = {}
        self.threshold_rows: Dict[Pointer, tuple] = {}
        self.threshold: tuple | None = None
        self.cache = _DiffCache()

    @staticmethod
    def _fraction(key: Pointer) -> float:
        # bit-mix so the fraction is independent of the shard-carrying low
        # bits and uniform over [0, 1)
        x = (key.value * 0x9E3779B97F4A7C15) & ((1 << 128) - 1)
        return (x >> 75) / float(1 << 53)

    def _apx(self, key: Pointer) -> Any:
        if self.threshold is None:
            return None
        lower, value, upper = self.threshold
        try:
            span = upper - lower
            f = (value - lower) / span if span else 1.0
        except TypeError:
            return ERROR
        return upper if self._fraction(key) < f else lower

    def process(self, time: int) -> None:
        data_deltas = self.take(0)
        thr_deltas = self.take(1)
        if not data_deltas and not thr_deltas:
            return
        out: List[Delta] = []
        changed_threshold = False
        if thr_deltas:
            # maintain the threshold table as keyed state so the result is
            # independent of delta order within a batch, and a
            # retraction-only update clears/recomputes the threshold
            for key, row, diff in thr_deltas:
                if diff > 0:
                    self.threshold_rows[key] = row
                else:
                    self.threshold_rows.pop(key, None)
            old = self.threshold
            if self.threshold_rows:
                # deterministic choice among survivors: max key (latest-ish,
                # stable regardless of arrival order)
                pick = max(self.threshold_rows)
                keys = [pick]
                rows = ([self.threshold_rows[pick]],)
                lowers = self.lower_prog(keys, rows)
                values = self.value_prog(keys, rows)
                uppers = self.upper_prog(keys, rows)
                self.threshold = (lowers[-1], values[-1], uppers[-1])
            else:
                self.threshold = None
            changed_threshold = self.threshold != old
        for key, row, diff in data_deltas:
            if diff > 0:
                self.rows[key] = row
            else:
                self.rows.pop(key, None)
        if changed_threshold:
            affected = set(self.rows) | set(self.cache.emitted.keys())
        else:
            affected = {d[0] for d in data_deltas}
        for key in affected:
            if key in self.rows:
                self.cache.diff(key, {key: (self._apx(key),)}, out)
            else:
                self.cache.diff(key, {}, out)
        self.emit(time, out)


class ToStreamNode(Node):
    """Turn a changing table into an append-only event stream (reference:
    python/pathway/internals/table.py to_stream:2782; engine op
    dataflow.rs table_to_stream:3098 — insertions sorted first, a
    deletion is skipped when the same batch carries an insertion).

    Events keep the original row key (so ``stream_to_table`` can replay
    them into keyed state); the output is a multiset event stream in
    which a key may recur across batches.
    """

    name = "to_stream"

    def __init__(self, engine: Engine, input_: Node):
        super().__init__(engine, [input_])

    def process(self, time: int) -> None:
        deltas, clean = self.take_with_clean(0)
        if not deltas:
            return
        if not clean:
            # merged chunks may carry a net-zero insert+retract for a key;
            # consolidating first keeps phantom rows out of the event stream
            deltas = consolidate(deltas)
        inserts: Dict[Pointer, tuple] = {}
        deletes: Dict[Pointer, tuple] = {}
        order: List[Pointer] = []
        for key, values, diff in deltas:
            if key not in inserts and key not in deletes:
                order.append(key)
            if diff > 0:
                inserts[key] = values
            else:
                deletes[key] = values
        out: List[Delta] = []
        for key in order:
            if key in inserts:
                out.append((key, inserts[key] + (True,), 1))
            else:
                out.append((key, deletes[key] + (False,), 1))
        # bypass emit(): its consolidation assumes unique keys per batch,
        # but an event stream is a multiset — batches here are minimal
        self.emit_consolidated(time, out)


class StreamToTableNode(Node):
    """Replay an upsert/delete event stream into keyed table state
    (reference: table.py stream_to_table:2836, StreamToTableContext)."""

    name = "stream_to_table"
    snapshot_attrs = ("state",)

    def __init__(self, engine: Engine, input_: Node, upsert_prog: BatchFn):
        super().__init__(engine, [input_])
        self.upsert_prog = upsert_prog
        self.state: Dict[Pointer, tuple] = {}

    def process(self, time: int) -> None:
        deltas = self.take(0)
        events = [(k, v) for k, v, d in deltas if d > 0]
        if not events:
            return
        keys = [e[0] for e in events]
        rows = ([e[1] for e in events],)
        flags = self.upsert_prog(keys, rows)
        out: List[Delta] = []
        for (key, values), flag in zip(events, flags):
            if isinstance(flag, Error):
                self.log_error("stream_to_table: Error in is_upsert column")
                continue
            old = self.state.get(key)
            if flag:
                if old is not None:
                    if values_equal_tuple(old, values):
                        continue
                    out.append((key, old, -1))
                self.state[key] = values
                out.append((key, values, 1))
            elif old is not None:
                del self.state[key]
                out.append((key, old, -1))
        self.emit(time, out)


class MergeStreamsNode(Node):
    """Merge an updates stream (port 0) and a deletions stream (port 1) into
    keyed table state (reference: table.py from_streams:2891,
    MergeStreamsToTableContext). Only ids matter on the deletion side."""

    name = "from_streams"
    snapshot_attrs = ("state",)

    def __init__(self, engine: Engine, updates: Node, deletions: Node):
        super().__init__(engine, [updates, deletions])
        self.state: Dict[Pointer, tuple] = {}

    def process(self, time: int) -> None:
        ups = self.take(0)
        dels = self.take(1)
        out: List[Delta] = []
        for key, values, diff in ups:
            if diff <= 0:
                continue
            old = self.state.get(key)
            if old is not None and values_equal_tuple(old, values):
                continue
            if old is not None:
                out.append((key, old, -1))
            self.state[key] = values
            out.append((key, values, 1))
        for key, _values, diff in dels:
            if diff <= 0:
                continue
            old = self.state.pop(key, None)
            if old is not None:
                out.append((key, old, -1))
        self.emit(time, out)


class AssertAppendOnlyNode(Node):
    """Pass-through that aborts the run on any retraction (reference:
    table.py assert_append_only:2941)."""

    name = "assert_append_only"

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        for _key, _values, diff in deltas:
            if diff < 0:
                from pathway_tpu_torch.engine.engine import EngineError

                raise EngineError(
                    "assert_append_only: table received a retraction"
                )
        self.emit(time, deltas)


class WindowFunctionNode(Node):
    """SQL window functions: per-partition ranking / running aggregates
    (reference surface: internals/sql/processing.py window handling via
    sqlglot; engine analogue built the micro-batch way — affected
    partitions recompute vectorized with numpy cumulatives, emitting
    minimal diffs).

    ``specs`` is a list of ``(fname, has_order)`` with per-row argument
    values supplied by ``arg_progs``. Supported fname: row_number, rank,
    dense_rank, sum, count, min, max, avg. With ORDER BY, aggregates use
    the standard SQL frame (RANGE UNBOUNDED PRECEDING — ties included);
    without it they span the whole partition. NULL arguments are skipped
    (SQL semantics); ``directions`` gives one DESC flag per ORDER BY key
    with NULLS LAST on ascending, NULLS FIRST on descending (postgres
    defaults). A partition whose computation fails (e.g. unorderable or
    non-numeric values) yields ERROR window values for its rows instead
    of killing the run.
    """

    name = "window_fn"
    snapshot_attrs = ("partitions", "cache")

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        part_prog: BatchFn,
        order_prog: Optional[BatchFn],
        specs: List[tuple],
        arg_progs: List[Optional[BatchFn]],
        *,
        directions: Tuple[bool, ...] = (),
    ):
        # co-locate rows by partition key so each partition recomputes on
        # one worker (same contract as ReduceNode)
        input_ = exchange_by_value(
            engine, input_, lambda keys, rows: part_prog(keys, rows)
        )
        super().__init__(engine, [input_])
        self.part_prog = part_prog
        self.order_prog = order_prog
        self.specs = specs
        self.arg_progs = arg_progs
        self.directions = directions
        # pkey -> {row_key: (values, order_val, (arg0, arg1, ...))}
        self.partitions: Dict[Any, Dict[Pointer, tuple]] = {}
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        pkeys = self.part_prog(keys, rows)
        order_vals = (
            self.order_prog(keys, rows) if self.order_prog is not None else None
        )
        arg_cols = [
            p(keys, rows) if p is not None else None for p in self.arg_progs
        ]
        affected = set()
        for i, (key, values, diff) in enumerate(deltas):
            pk = pkeys[i]
            if isinstance(pk, Error):
                self.log_error("Error value in window PARTITION BY key")
                continue
            pk = _freeze(pk)
            affected.add(pk)
            part = self.partitions.setdefault(pk, {})
            if diff > 0:
                part[key] = (
                    values,
                    order_vals[i] if order_vals is not None else None,
                    tuple(c[i] if c is not None else None for c in arg_cols),
                )
            else:
                part.pop(key, None)
                if not part:
                    del self.partitions[pk]
        out: List[Delta] = []
        n_specs = len(self.specs)
        for pk in affected:
            part = self.partitions.get(pk)
            new_rows: Dict[Pointer, tuple] = {}
            if part:
                try:
                    new_rows = self._compute_partition(part)
                except Exception as exc:  # noqa: BLE001
                    self.log_error(
                        f"window function: {type(exc).__name__}: {exc}"
                    )
                    new_rows = {
                        key: (*values, *((ERROR,) * n_specs))
                        for key, (values, _ov, _args) in part.items()
                    }
            self.cache.diff(pk, new_rows, out)
        self.emit(time, out)

    def _order_component(self, ov, j: int):
        if len(self.directions) > 1:
            return ov[j]
        return ov

    def _sorted_items(self, part: Dict[Pointer, tuple]) -> List[tuple]:
        items = sorted(part.items(), key=lambda kv: kv[0])  # deterministic
        if self.order_prog is None:
            return items
        # multi-pass stable sort, last ORDER BY key first, so each key gets
        # its own direction; NULLS LAST on asc, FIRST on desc (postgres)
        for j in reversed(range(len(self.directions))):
            desc = self.directions[j]

            def sort_key(kv, j=j):
                v = self._order_component(kv[1][1], j)
                return (v is None, 0 if v is None else v)

            items.sort(key=sort_key, reverse=desc)
        return items

    def _compute_partition(
        self, part: Dict[Pointer, tuple]
    ) -> Dict[Pointer, tuple]:
        import numpy as np

        items = self._sorted_items(part)
        n = len(items)
        has_order = self.order_prog is not None
        if has_order:
            order_arr = [kv[1][1] for kv in items]
            group_id = [0] * n
            g = 0
            for i in range(1, n):
                if order_arr[i] != order_arr[i - 1]:
                    g += 1
                group_id[i] = g
            group_first: Dict[int, int] = {}
            group_last: Dict[int, int] = {}
            for i in range(n):
                group_last[group_id[i]] = i
                group_first.setdefault(group_id[i], i)
        win_cols: List[List[Any]] = []
        for s_idx, (fname, _spec_has_order) in enumerate(self.specs):
            args = [kv[1][2][s_idx] for kv in items]
            if fname == "row_number":
                col: List[Any] = list(range(1, n + 1))
            elif fname == "rank":
                col = [group_first[group_id[i]] + 1 for i in range(n)]
            elif fname == "dense_rank":
                col = [group_id[i] + 1 for i in range(n)]
            elif fname in ("sum", "count", "min", "max", "avg"):
                col = self._aggregate(
                    fname,
                    args,
                    n,
                    has_arg=self.arg_progs[s_idx] is not None,
                    frame_end=(
                        [group_last[group_id[i]] for i in range(n)]
                        if has_order
                        else None
                    ),
                )
            else:
                raise ValueError(f"unsupported window function {fname!r}")
            win_cols.append(col)
        return {
            key: (*values, *(win_cols[s][i] for s in range(len(self.specs))))
            for i, (key, (values, _ov, _args)) in enumerate(items)
        }

    @staticmethod
    def _aggregate(
        fname: str,
        args: List[Any],
        n: int,
        *,
        has_arg: bool,
        frame_end: Optional[List[int]],
    ) -> List[Any]:
        """NULL-skipping SQL aggregate over the partition (frame_end=None)
        or the running RANGE frame ending at each row's last peer."""
        import numpy as np

        int_result = fname in ("sum", "min", "max") and all(
            isinstance(a, int) and not isinstance(a, bool)
            for a in args
            if a is not None
        )
        if int_result:
            # exact Python-int accumulation: routing through float64 would
            # silently round ints >= 2**53, diverging from the exact
            # GROUP BY reducers
            op = {"sum": sum, "min": min, "max": max}[fname]
            if frame_end is None:
                ints = [a for a in args if a is not None]
                agg_i = op(ints) if ints else None
                return [agg_i] * n
            run_i: List[Any] = []
            acc: Any = None
            for a in args:
                if a is not None:
                    acc = a if acc is None else op((acc, a))
                run_i.append(acc)
            return [run_i[frame_end[i]] for i in range(n)]
        if fname == "count" and not has_arg:
            present = np.ones(n, dtype=bool)  # COUNT(*) counts all rows
        else:
            present = np.array([a is not None for a in args], dtype=bool)
        vals = np.array(
            [float(a) if a is not None else 0.0 for a in args]
        )

        def finish(x: Any) -> Any:
            if x is None:
                return None
            if fname == "count":
                return int(x)
            return float(x)

        if frame_end is None:
            cnt = int(present.sum())
            if fname == "count":
                agg: Any = cnt
            elif cnt == 0:
                agg = None
            elif fname == "sum":
                agg = vals[present].sum()
            elif fname == "min":
                agg = vals[present].min()
            elif fname == "max":
                agg = vals[present].max()
            else:
                agg = vals[present].mean()
            return [finish(agg)] * n
        cum_cnt = np.cumsum(present.astype(np.int64))
        if fname == "count":
            run: Any = cum_cnt
        elif fname == "sum":
            run = np.cumsum(np.where(present, vals, 0.0))
        elif fname == "min":
            run = np.minimum.accumulate(np.where(present, vals, np.inf))
        elif fname == "max":
            run = np.maximum.accumulate(np.where(present, vals, -np.inf))
        else:
            run = np.cumsum(np.where(present, vals, 0.0)) / np.maximum(
                cum_cnt, 1
            )
        return [
            finish(None if fname != "count" and cum_cnt[j] == 0 else run[j])
            for j in (frame_end[i] for i in range(n))
        ]


class FusedChainNode(Node):
    """A planned select/filter chain collapsed into one operator
    (analysis/fusion.py FusionPlan; built by internals/table.py
    build_fused_chain when RunContext.node hits a chain tail).

    Classic builds materialize every stage: each RowwiseNode/FilterNode
    pays its own take/consolidate/emit/receive round-trip per batch.
    Here the batch flows through all stages inside one process() call and
    consolidates exactly once at the end — legal because every stage is
    an elementwise deterministic map or filter, and consolidation
    commutes with per-row deterministic transforms (the net diff of a
    mapped batch equals the map of the net diff).  No stage keeps state,
    so there is nothing to snapshot and multi-worker sharding is
    unaffected (select/filter are shard-stable).

    `path`/`rows_processed` follow the columnar-node observability
    convention (monitoring.node_path_stats), so tests and /status can
    prove the fused implementation actually ran.
    """

    name = "fused_chain"
    path = "fused"

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        stages: List[Tuple[str, Any]],
        *,
        op_ids: Tuple[int, ...] = (),
        kinds: Tuple[str, ...] = (),
    ):
        super().__init__(engine, [input_])
        # [("map", fn(keys, values) -> values) | ("filter", pred_fn)]
        self.stages = stages
        self.op_ids = tuple(op_ids)
        self.kinds = tuple(kinds)

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self.rows_processed += len(deltas)
        self.batches_processed += 1
        keys = [d[0] for d in deltas]
        values = [d[1] for d in deltas]
        diffs = [d[2] for d in deltas]
        for kind, fn in self.stages:
            if not keys:
                break
            if kind == "filter":
                mask = fn(keys, (values,))
                nk: List[Any] = []
                nv: List[tuple] = []
                nd: List[int] = []
                for i, keep in enumerate(mask):
                    if isinstance(keep, Error):
                        self.log_error("Error value in filter condition")
                    elif keep:
                        nk.append(keys[i])
                        nv.append(values[i])
                        nd.append(diffs[i])
                keys, values, diffs = nk, nv, nd
            else:
                values = fn(keys, values)
        out = list(zip(keys, values, diffs))
        if _provenance.ACTIVE:
            # fusion must not lose lineage: the collapsed chain records
            # endpoint identity edges tagged with its chain id (keys are
            # unchanged through select/filter stages)
            _provenance.tracker().record_fused(self, time, out)
        self.emit(time, out)
