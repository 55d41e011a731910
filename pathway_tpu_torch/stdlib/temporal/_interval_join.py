"""interval_join — join rows whose time difference falls in an interval
(reference: python/pathway/stdlib/temporal/_interval_join.py:577).

`left.t + lower <= right.t <= left.t + upper`, optionally with extra equality
conditions. Implemented as a dedicated engine node that buckets both sides by
the equality key and recomputes affected buckets per batch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import _DiffCache, _freeze
from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    MakeTupleExpression,
    collect_tables,
)
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import Table, _compile_on


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    if upper_bound < lower_bound:
        # reference: temporal/utils raises on an empty interval spec
        raise ValueError(
            f"interval(): lower_bound {lower_bound!r} exceeds "
            f"upper_bound {upper_bound!r}"
        )
    return Interval(lower_bound, upper_bound)


class IntervalJoinNode(Node):
    """Bucketed interval join with optional outer sides."""

    name = "interval_join"
    snapshot_attrs = ('left_index', 'right_index', 'cache')

    def __init__(
        self,
        engine: Engine,
        left: Node,
        right: Node,
        left_time_prog,
        right_time_prog,
        left_key_prog,
        right_key_prog,
        lower,
        upper,
        *,
        left_width: int,
        right_width: int,
        left_outer: bool,
        right_outer: bool,
    ):
        # multi-worker: co-locate rows by join key (empty key = one worker)
        from pathway_tpu_torch.engine.exchange import exchange_by_value

        left = exchange_by_value(engine, left, left_key_prog)
        right = exchange_by_value(engine, right, right_key_prog)
        super().__init__(engine, [left, right])
        self.left_time_prog = left_time_prog
        self.right_time_prog = right_time_prog
        self.left_key_prog = left_key_prog
        self.right_key_prog = right_key_prog
        self.lower = lower
        self.upper = upper
        self.left_width = left_width
        self.right_width = right_width
        self.left_outer = left_outer
        self.right_outer = right_outer
        # bucket -> {key: (time, row)}
        self.left_index: Dict[Any, Dict] = {}
        self.right_index: Dict[Any, Dict] = {}
        self.cache = _DiffCache()

    def _apply(self, index, deltas, time_prog, key_prog, affected: Set):
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        tvs = time_prog(keys, rows)
        jvs = key_prog(keys, rows)
        for (key, values, diff), tv, jv in zip(deltas, tvs, jvs):
            jv = _freeze(jv)
            affected.add(jv)
            bucket = index.setdefault(jv, {})
            if diff > 0:
                bucket[key] = (tv, values)
            else:
                bucket.pop(key, None)
                if not bucket:
                    del index[jv]

    def process(self, time: int) -> None:
        left_deltas = self.take(0)
        right_deltas = self.take(1)
        if not left_deltas and not right_deltas:
            return
        affected: Set = set()
        self._apply(
            self.left_index, left_deltas, self.left_time_prog, self.left_key_prog, affected
        )
        self._apply(
            self.right_index,
            right_deltas,
            self.right_time_prog,
            self.right_key_prog,
            affected,
        )
        out = []
        l_nones = (None,) * self.left_width
        r_nones = (None,) * self.right_width
        for jv in affected:
            lefts = self.left_index.get(jv, {})
            rights = self.right_index.get(jv, {})
            new_rows: Dict[Pointer, tuple] = {}
            matched_left: Set = set()
            matched_right: Set = set()
            for lk, (lt, lrow) in lefts.items():
                for rk, (rt, rrow) in rights.items():
                    if lt + self.lower <= rt <= lt + self.upper:
                        matched_left.add(lk)
                        matched_right.add(rk)
                        new_rows[ref_scalar(lk, rk)] = (lk, rk, *lrow, *rrow)
            if self.left_outer:
                for lk, (lt, lrow) in lefts.items():
                    if lk not in matched_left:
                        new_rows[ref_scalar(lk, None)] = (lk, None, *lrow, *r_nones)
            if self.right_outer:
                for rk, (rt, rrow) in rights.items():
                    if rk not in matched_right:
                        new_rows[ref_scalar(None, rk)] = (None, rk, *l_nones, *rrow)
            self.cache.diff(jv, new_rows, out)
        self.emit(time, out)


class IntervalJoinResult(JoinResult):
    """JoinResult flavor whose engine node is an IntervalJoinNode."""

    def __init__(
        self,
        left: Table,
        right: Table,
        left_time_expr,
        right_time_expr,
        interval_: Interval,
        on: tuple,
        mode: JoinMode,
        remap=None,
    ):
        super().__init__(left, right, on, mode=mode, remap=remap)
        # each side's time expression resolves pw.this against ITS OWN
        # table (reference semantics)
        self._left_time = desugar(
            left_time_expr,
            {thisclass.left: left, thisclass.right: right,
             thisclass.this: left},
        )
        self._right_time = desugar(
            right_time_expr,
            {thisclass.left: left, thisclass.right: right,
             thisclass.this: right},
        )
        self._interval = interval_

    def _join_node(self, ctx):
        cached = ctx.join_nodes.get(id(self))
        if cached is not None:
            return cached
        left_node = ctx.node(self._left)
        right_node = ctx.node(self._right)
        node = IntervalJoinNode(
            ctx.engine,
            left_node,
            right_node,
            _compile_on(ctx, [self._left], self._left_time),
            _compile_on(ctx, [self._right], self._right_time),
            _compile_on(ctx, [self._left], MakeTupleExpression(*self._on_left)),
            _compile_on(ctx, [self._right], MakeTupleExpression(*self._on_right)),
            self._interval.lower_bound,
            self._interval.upper_bound,
            left_width=len(self._left.column_names()),
            right_width=len(self._right.column_names()),
            left_outer=self._mode in (JoinMode.LEFT, JoinMode.OUTER),
            right_outer=self._mode in (JoinMode.RIGHT, JoinMode.OUTER),
        )
        from pathway_tpu_torch.engine.exchange import exchange_by_key

        node = exchange_by_key(ctx.engine, node)
        ctx.join_nodes[id(self)] = node
        return node


def interval_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    interval: Interval,
    *on,
    behavior=None,
    how: JoinMode = JoinMode.INNER,
) -> IntervalJoinResult:
    """Join rows whose time difference falls inside `interval` (reference:
    stdlib/temporal/_interval_join.py interval_join:577).

    >>> import pathway_tpu_torch as pw
    >>> left = pw.debug.table_from_markdown('''
    ... t | a
    ... 1 | 1
    ... 5 | 2
    ... ''')
    >>> right = pw.debug.table_from_markdown('''
    ... t | b
    ... 2 | 10
    ... 9 | 20
    ... ''')
    >>> res = left.interval_join(
    ...     right, left.t, right.t, pw.temporal.interval(-2, 2)
    ... ).select(a=pw.left.a, b=pw.right.b)
    >>> pw.debug.compute_and_print(res, include_id=False)
    a | b
    1 | 10
    """
    from pathway_tpu_torch.internals.parse_graph import record_marker

    record_marker("interval_join", has_behavior=behavior is not None)
    if isinstance(how, str):
        how = JoinMode[how.upper()]
    remap = None
    if behavior is not None:
        # behaviors gate the join's INPUT sides (reference: interval
        # joins apply cutoff/forgetting on each side's time column).
        # User expressions keep referencing the ORIGINAL tables; the
        # JoinResult remap machinery rebinds them onto the gated copies.
        from pathway_tpu_torch.stdlib.temporal._window import (
            _apply_behavior_on_time,
            _remap_by_name,
        )

        lt = desugar(
            self_time,
            {thisclass.left: self, thisclass.right: other,
             thisclass.this: self},
        )
        rt = desugar(
            other_time,
            {thisclass.left: self, thisclass.right: other,
             thisclass.this: other},
        )
        new_left = _apply_behavior_on_time(self, lt, behavior)
        new_right = _apply_behavior_on_time(other, rt, behavior)
        # right entries first: on a SELF-join (self is other) the left
        # side wins the collision, matching the no-behavior resolver's
        # left-first precedence
        remap = {}
        for c in other.column_names():
            remap[(id(other), c)] = new_right[c]
        for c in self.column_names():
            remap[(id(self), c)] = new_left[c]
        self_time = _remap_by_name(lt, new_left)
        other_time = _remap_by_name(rt, new_right)
        self, other = new_left, new_right
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, how,
        remap=remap,
    )


def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(
        self, other, self_time, other_time, interval, *on,
        how=JoinMode.INNER, **kw,
    )


def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(
        self, other, self_time, other_time, interval, *on,
        how=JoinMode.LEFT, **kw,
    )


def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(
        self, other, self_time, other_time, interval, *on,
        how=JoinMode.RIGHT, **kw,
    )


def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(
        self, other, self_time, other_time, interval, *on,
        how=JoinMode.OUTER, **kw,
    )
