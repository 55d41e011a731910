"""asof_now_join — join left rows against the right side's state *at arrival
time*; results are never retro-updated when the right side changes later
(reference: python/pathway/stdlib/temporal/_asof_now_join.py:176). This is
the join that serves index queries (DataIndex.query_as_of_now)."""

from __future__ import annotations

from typing import Any, Dict, List, Set

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import _freeze
from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals.expression import MakeTupleExpression
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import Table, _compile_on


class AsofNowJoinNode(Node):
    """Left deltas join the right index as-of the current batch; right deltas
    only update the index (matching the reference's asof-now contract,
    external_index.rs batch-by-time)."""

    name = "asof_now_join"
    snapshot_attrs = ('right_index',)

    def __init__(
        self,
        engine: Engine,
        left: Node,
        right: Node,
        left_key_prog,
        right_key_prog,
        *,
        left_width: int,
        right_width: int,
        left_outer: bool,
        id_mode: str = "left",
    ):
        # multi-worker: co-locate queries with the index shard they probe
        from pathway_tpu_torch.engine.exchange import exchange_by_value

        left = exchange_by_value(engine, left, left_key_prog)
        right = exchange_by_value(engine, right, right_key_prog)
        super().__init__(engine, [left, right])
        self.left_key_prog = left_key_prog
        self.right_key_prog = right_key_prog
        self.left_width = left_width
        self.right_width = right_width
        self.left_outer = left_outer
        self.id_mode = id_mode
        self.right_index: Dict[Any, Dict] = {}

    def process(self, time: int) -> None:
        left_deltas = self.take(0)
        right_deltas = self.take(1)
        # update the index first: queries at time t see index state at t
        if right_deltas:
            keys = [d[0] for d in right_deltas]
            rows = ([d[1] for d in right_deltas],)
            jvs = self.right_key_prog(keys, rows)
            for (key, values, diff), jv in zip(right_deltas, jvs):
                jv = _freeze(jv)
                bucket = self.right_index.setdefault(jv, {})
                if diff > 0:
                    bucket[key] = values
                else:
                    bucket.pop(key, None)
        if not left_deltas:
            return
        out = []
        r_nones = (None,) * self.right_width
        keys = [d[0] for d in left_deltas]
        rows = ([d[1] for d in left_deltas],)
        jvs = self.left_key_prog(keys, rows)
        for (lk, lrow, diff), jv in zip(left_deltas, jvs):
            jv = _freeze(jv)
            rights = self.right_index.get(jv, {})
            matched = False
            for rk, rrow in rights.items():
                matched = True
                out_key = lk if self.id_mode == "left" else ref_scalar(lk, rk)
                out.append((out_key, (lk, rk, *lrow, *rrow), diff))
            if not matched and self.left_outer:
                out_key = lk if self.id_mode == "left" else ref_scalar(lk, None)
                out.append((out_key, (lk, None, *lrow, *r_nones), diff))
        self.emit(time, out)


class AsofNowJoinResult(JoinResult):
    def __init__(self, left, right, on, mode: JoinMode, id_expr=None):
        super().__init__(left, right, on, mode=mode, id_expr=id_expr)
        if self._id_mode == "both":
            # asof_now results default to left-row keying when unique
            self._id_mode_effective = "both"
        else:
            self._id_mode_effective = self._id_mode

    def _join_node(self, ctx):
        cached = ctx.join_nodes.get(id(self))
        if cached is not None:
            return cached
        node = AsofNowJoinNode(
            ctx.engine,
            ctx.node(self._left),
            ctx.node(self._right),
            _compile_on(ctx, [self._left], MakeTupleExpression(*self._on_left)),
            _compile_on(ctx, [self._right], MakeTupleExpression(*self._on_right)),
            left_width=len(self._left.column_names()),
            right_width=len(self._right.column_names()),
            left_outer=self._mode in (JoinMode.LEFT, JoinMode.OUTER),
            id_mode="left" if self._id_mode_effective == "left" else "both",
        )
        from pathway_tpu_torch.engine.exchange import exchange_by_key

        node = exchange_by_key(ctx.engine, node)
        ctx.join_nodes[id(self)] = node
        return node


def asof_now_join(
    self: Table,
    other: Table,
    *on,
    how: JoinMode = JoinMode.INNER,
    id=None,
    **kwargs,
) -> AsofNowJoinResult:
    if isinstance(how, str):
        how = JoinMode[how.upper()]
    return AsofNowJoinResult(self, other, on, how, id_expr=id)


def asof_now_join_inner(self, other, *on, **kw):
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how=JoinMode.INNER, **kw)


def asof_now_join_left(self, other, *on, **kw):
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how=JoinMode.LEFT, **kw)
