"""asof_join — match each left row with the nearest right row in time
(reference: python/pathway/stdlib/temporal/_asof_join.py:479)."""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Set

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import _DiffCache, _freeze
from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.expression import MakeTupleExpression
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import Table, _compile_on


class Direction(enum.Enum):
    BACKWARD = "backward"  # right.t <= left.t (latest such)
    FORWARD = "forward"  # right.t >= left.t (earliest such)
    NEAREST = "nearest"


class AsofJoinNode(Node):
    name = "asof_join"
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
        direction: Direction,
        *,
        left_width: int,
        right_width: int,
        left_outer: bool,
        right_outer: bool,
        defaults: Dict[int, Any] | None = None,
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
        self.direction = direction
        self.left_width = left_width
        self.right_width = right_width
        self.left_outer = left_outer
        self.right_outer = right_outer
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

    def _match(self, lt, rights_sorted):
        """rights_sorted: list of (time, key, row) ascending."""
        import bisect

        times = [r[0] for r in rights_sorted]
        if self.direction == Direction.BACKWARD:
            i = bisect.bisect_right(times, lt) - 1
            return rights_sorted[i] if i >= 0 else None
        if self.direction == Direction.FORWARD:
            i = bisect.bisect_left(times, lt)
            return rights_sorted[i] if i < len(rights_sorted) else None
        # NEAREST
        i = bisect.bisect_left(times, lt)
        candidates = []
        if i > 0:
            candidates.append(rights_sorted[i - 1])
        if i < len(rights_sorted):
            candidates.append(rights_sorted[i])
        if not candidates:
            return None
        return min(candidates, key=lambda r: abs(r[0] - lt))

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
            rights_sorted = sorted(
                ((tv, k, row) for k, (tv, row) in rights.items()),
                key=lambda r: (r[0], r[1]),
            )
            new_rows: Dict[Pointer, tuple] = {}
            matched_right: Set = set()
            for lk, (lt, lrow) in lefts.items():
                m = self._match(lt, rights_sorted)
                if m is not None:
                    _rt, rk, rrow = m
                    matched_right.add(rk)
                    new_rows[ref_scalar(lk, rk)] = (lk, rk, *lrow, *rrow)
                elif self.left_outer:
                    new_rows[ref_scalar(lk, None)] = (lk, None, *lrow, *r_nones)
            if self.right_outer:
                for _tv, rk, rrow in rights_sorted:
                    if rk not in matched_right:
                        new_rows[ref_scalar(None, rk)] = (None, rk, *l_nones, *rrow)
            self.cache.diff(jv, new_rows, out)
        self.emit(time, out)


class AsofJoinResult(JoinResult):
    def __init__(
        self,
        left: Table,
        right: Table,
        left_time_expr,
        right_time_expr,
        on: tuple,
        mode: JoinMode,
        direction: Direction,
        defaults: dict | None = None,
    ):
        super().__init__(left, right, on, mode=mode)
        mapping = {thisclass.left: left, thisclass.right: right, thisclass.this: left}
        self._left_time = desugar(left_time_expr, mapping)
        self._right_time = desugar(right_time_expr, mapping)
        self._direction = direction

    def _join_node(self, ctx):
        cached = ctx.join_nodes.get(id(self))
        if cached is not None:
            return cached
        node = AsofJoinNode(
            ctx.engine,
            ctx.node(self._left),
            ctx.node(self._right),
            _compile_on(ctx, [self._left], self._left_time),
            _compile_on(ctx, [self._right], self._right_time),
            _compile_on(ctx, [self._left], MakeTupleExpression(*self._on_left)),
            _compile_on(ctx, [self._right], MakeTupleExpression(*self._on_right)),
            self._direction,
            left_width=len(self._left.column_names()),
            right_width=len(self._right.column_names()),
            left_outer=self._mode in (JoinMode.LEFT, JoinMode.OUTER),
            right_outer=self._mode in (JoinMode.RIGHT, JoinMode.OUTER),
        )
        from pathway_tpu_torch.engine.exchange import exchange_by_key

        node = exchange_by_key(ctx.engine, node)
        ctx.join_nodes[id(self)] = node
        return node


def asof_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    *on,
    how: JoinMode = JoinMode.INNER,
    defaults: dict | None = None,
    direction: Direction = Direction.BACKWARD,
    behavior=None,
) -> AsofJoinResult:
    """Join each left row with the latest right row at or before its time
    (reference: stdlib/temporal/_asof_join.py asof_join:479).

    >>> import pathway_tpu_torch as pw
    >>> trades = pw.debug.table_from_markdown('''
    ... t | qty
    ... 3 | 1
    ... ''')
    >>> quotes = pw.debug.table_from_markdown('''
    ... t | price
    ... 1 | 10
    ... 5 | 20
    ... ''')
    >>> res = trades.asof_join(
    ...     quotes, trades.t, quotes.t
    ... ).select(qty=pw.left.qty, price=pw.right.price)
    >>> pw.debug.compute_and_print(res, include_id=False)
    qty | price
    1   | 10
    """
    from pathway_tpu_torch.internals.parse_graph import record_marker

    record_marker("asof_join", has_behavior=behavior is not None)
    if isinstance(how, str):
        how = JoinMode[how.upper()]
    if isinstance(direction, str):
        direction = Direction[direction.upper()]
    return AsofJoinResult(
        self, other, self_time, other_time, on, how, direction, defaults
    )


def asof_join_inner(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.INNER, **kw)


def asof_join_left(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.LEFT, **kw)


def asof_join_right(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.RIGHT, **kw)


def asof_join_outer(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.OUTER, **kw)
