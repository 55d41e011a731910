"""Windows: tumbling / sliding / session / intervals_over (reference:
python/pathway/stdlib/temporal/_window.py:590-857).

Window assignment is columnar: each row gets its covering windows, is
flattened, and grouped by (instance, window_start, window_end) — the same
mechanics as the reference (`_window.py:256-380`). Session windows are
computed by a dedicated engine node that re-chains affected instances per
batch (replacing the reference's sort + pointer-jumping-in-iterate,
`_window.py:65-140`, with a recompute-style operator)."""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnExpression
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.internals.table import Table, _compile_on
from pathway_tpu_torch.internals.universe import Universe


class Window:
    pass


@dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None

    def assign(self, t):
        origin = self.origin if self.origin is not None else _zero_like(t)
        d = self.duration
        n = (t - origin) // d
        start = origin + n * d
        return ((start, start + d),)


@dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Any = None
    ratio: int | None = None
    origin: Any = None

    def assign(self, t):
        d = self.duration if self.duration is not None else self.hop * self.ratio
        h = self.hop
        origin = self.origin if self.origin is not None else _zero_like(t)
        # all starts s = origin + k*h with s <= t < s + d
        k_max = (t - origin) // h
        out = []
        k = k_max
        while True:
            start = origin + k * h
            if start + d <= t:
                break
            out.append((start, start + d))
            k -= 1
        out.reverse()
        return tuple(out)


@dataclass
class SessionWindow(Window):
    predicate: Callable | None = None
    max_gap: Any = None


@dataclass
class IntervalsOverWindow(Window):
    at: ColumnExpression
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def _zero_like(t):
    if isinstance(t, datetime.datetime):
        if t.tzinfo is not None:
            return datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
        return datetime.datetime(1970, 1, 1)
    if isinstance(t, float):
        return 0.0
    return 0


def tumbling(duration, origin=None) -> TumblingWindow:
    return TumblingWindow(duration=duration, origin=origin)


def sliding(hop, duration=None, ratio: int | None = None, origin=None) -> SlidingWindow:
    return SlidingWindow(hop=hop, duration=duration, ratio=ratio, origin=origin)


def session(*, predicate: Callable | None = None, max_gap=None) -> SessionWindow:
    if (predicate is None) == (max_gap is None):
        raise ValueError("session() requires exactly one of predicate / max_gap")
    return SessionWindow(predicate=predicate, max_gap=max_gap)


def intervals_over(
    *, at, lower_bound, upper_bound, is_outer: bool = True
) -> IntervalsOverWindow:
    return IntervalsOverWindow(
        at=at, lower_bound=lower_bound, upper_bound=upper_bound, is_outer=is_outer
    )


class WindowedTable:
    """Result of windowby, supporting reduce (reference: _window.py
    WindowedTable)."""

    def __init__(self, flat: Table, grouping_names: List[str], source: Table):
        self._flat = flat
        self._grouping_names = grouping_names
        self._source = source

    def reduce(self, *args, **kwargs) -> Table:
        flat = self._flat
        mapping = {thisclass.this: flat}
        new_args = [desugar(a, mapping) for a in args]
        new_kwargs = {k: desugar(v, mapping) for k, v in kwargs.items()}
        grouped = flat.groupby(*(flat[g] for g in self._grouping_names))
        return grouped.reduce(*new_args, **new_kwargs)


def _check_time_window_types(table: Table, time_e, window) -> None:
    """Numeric time columns need numeric durations; datetime columns need
    timedeltas (reference: temporal/utils.py check_joint_types — mismatch
    is a BUILD-time TypeError, not silent Error rows)."""
    import datetime as _dt_mod

    try:
        time_dtype = table.eval_type(time_e)
    except Exception:  # noqa: BLE001 — untyped expressions skip the gate
        return
    durations = [
        getattr(window, attr, None)
        for attr in ("duration", "hop", "max_gap", "lower_bound", "upper_bound")
    ]
    durations = [d for d in durations if d is not None and not callable(d)]
    core = dt.unoptionalize(time_dtype)
    for d in durations:
        is_delta = isinstance(d, _dt_mod.timedelta)
        if core in (dt.INT, dt.FLOAT) and is_delta:
            raise TypeError(
                f"window duration {d!r} is a timedelta but the time "
                f"column is {core}; use a number"
            )
        if core in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and not is_delta:
            raise TypeError(
                f"window duration {d!r} is a number but the time column "
                f"is {core}; use a datetime.timedelta"
            )


def _remap_by_name(expr, target: Table):
    """Rebind column references onto `target` by column name (columns
    survive flatten/with_columns under their names)."""
    import copy as copy_mod

    from pathway_tpu_torch.internals.expression import (
        ColumnExpression,
        ColumnReference,
        IdReference,
    )

    def rec(e):
        if isinstance(e, IdReference):
            return IdReference(target)
        if isinstance(e, ColumnReference):
            if e.name in target.column_names():
                return target[e.name]
            return e
        out = copy_mod.copy(e)
        for attr, value in list(vars(e).items()):
            if isinstance(value, ColumnExpression):
                setattr(out, attr, rec(value))
            elif isinstance(value, tuple) and any(
                isinstance(v, ColumnExpression) for v in value
            ):
                setattr(
                    out,
                    attr,
                    tuple(
                        rec(v) if isinstance(v, ColumnExpression) else v
                        for v in value
                    ),
                )
        return out

    return rec(expr)


def _wrap_temporal(table: Table, node_cls, threshold_expr, time_expr, **kw) -> Table:
    from pathway_tpu_torch.internals.table import _compile_on

    def build(ctx):
        node = ctx.node(table)
        return node_cls(
            ctx.engine,
            node,
            _compile_on(ctx, [table], threshold_expr),
            _compile_on(ctx, [table], time_expr),
            **kw,
        )

    return Table(schema=table._schema, universe=Universe(), build=build)


def _behavior_plan(behavior, start_of, end_of):
    """[(node_cls, threshold_of)] for a behavior. `start_of`/`end_of`
    map the current table to the buffer/cutoff anchor expressions —
    window bounds for windowby, the raw time column for join inputs —
    so BOTH appliers share one branch structure (reference:
    temporal_behavior.py; engine ops time_column.rs)."""
    from pathway_tpu_torch.engine.temporal_nodes import (
        BufferNode,
        ForgetNode,
        FreezeNode,
    )
    from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
        CommonBehavior,
        ExactlyOnceBehavior,
    )

    plan = []
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = behavior.shift

        def threshold(t):
            end = end_of(t)
            return end + shift if shift else end

        plan.append((FreezeNode, threshold))
        plan.append((BufferNode, threshold))
    elif isinstance(behavior, CommonBehavior):
        if behavior.delay is not None:
            plan.append(
                (BufferNode, lambda t: start_of(t) + behavior.delay)
            )
        if behavior.cutoff is not None:
            plan.append(
                (FreezeNode, lambda t: end_of(t) + behavior.cutoff)
            )
            if not behavior.keep_results:
                plan.append(
                    (ForgetNode, lambda t: end_of(t) + behavior.cutoff)
                )
    return plan


def _apply_plan(table: Table, time_expr, plan) -> Table:
    out = table
    for node_cls, threshold_of in plan:
        # expressions must rebind onto the current (possibly already
        # wrapped) table — columns keep their names through the chain
        out = _wrap_temporal(
            out,
            node_cls,
            threshold_of(out),
            _remap_by_name(time_expr, out),
        )
    return out


def _apply_behavior(flat2: Table, time_on_flat, behavior) -> Table:
    """Wrap the flattened window-assignment table with buffer/freeze/forget
    per the behavior, anchored on the window bounds columns."""
    plan = _behavior_plan(
        behavior,
        start_of=lambda t: t["_pw_window_start"],
        end_of=lambda t: t["_pw_window_end"],
    )
    return _apply_plan(flat2, time_on_flat, plan)


def _apply_behavior_on_time(table: Table, time_expr, behavior) -> Table:
    """Behavior gating keyed on a plain TIME column (interval/asof join
    inputs): delay buffers rows until time+delay, cutoff freezes/forgets
    rows behind time+cutoff. Same plan as _apply_behavior with the time
    column as both anchor bounds."""
    anchor = lambda t: _remap_by_name(time_expr, t)  # noqa: E731
    plan = _behavior_plan(behavior, start_of=anchor, end_of=anchor)
    return _apply_plan(table, time_expr, plan)


def windowby(
    table: Table,
    time_expr,
    *,
    window: Window,
    instance=None,
    behavior=None,
    shard=None,
) -> WindowedTable:
    """Assign windows and group (reference: stdlib/temporal/_window.py
    windowby:590).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... t  | v
    ... 1  | 10
    ... 7  | 20
    ... 13 | 5
    ... ''')
    >>> win = pw.temporal.windowby(
    ...     t, t.t, window=pw.temporal.tumbling(duration=10)
    ... ).reduce(
    ...     start=pw.this._pw_window_start,
    ...     total=pw.reducers.sum(pw.this.v),
    ... )
    >>> pw.debug.compute_and_print(win, include_id=False)
    start | total
    10    | 5
    0     | 30
    """
    from pathway_tpu_torch.internals.parse_graph import record_marker

    record_marker(
        "windowby",
        has_behavior=behavior is not None,
        window=type(window).__name__,
    )
    if instance is None and shard is not None:
        instance = shard
    mapping = {thisclass.this: table}
    time_e = desugar(time_expr, mapping)
    instance_e = desugar(instance, mapping) if instance is not None else None
    _check_time_window_types(table, time_e, window)

    if isinstance(window, (TumblingWindow, SlidingWindow)):
        assign = window.assign
        assign_expr = ApplyExpression(
            lambda t: assign(t), dt.ANY_TUPLE, time_e, deterministic=True
        )
        with_windows = table.with_columns(_pw_window=assign_expr)
        flat = with_windows.flatten(with_windows._pw_window)
        cols = {
            "_pw_window_start": flat._pw_window.get(0),
            "_pw_window_end": flat._pw_window.get(1),
        }
        if instance_e is not None:
            # instance columns survive flatten under their original name;
            # remap BOTH pw.this and concrete-table references onto the
            # flattened row set (a concrete t.g ref would otherwise dangle
            # on the pre-flatten universe and read None)
            cols["_pw_instance"] = _remap_by_name(
                desugar(instance, {thisclass.this: flat}), flat
            )
        flat2 = flat.with_columns(**cols)
        if behavior is not None:
            flat2 = _apply_behavior(
                flat2, _remap_by_name(time_e, flat2), behavior
            )
        grouping = ["_pw_window_start", "_pw_window_end"]
        if instance_e is not None:
            grouping.append("_pw_instance")
        return WindowedTable(flat2, grouping, table)

    if isinstance(window, SessionWindow):
        session_cols = _session_assign(table, time_e, instance_e, window)
        flat2_cols: Dict[str, ColumnExpression] = {
            name: table[name] for name in table.column_names()
        }
        flat2_cols["_pw_window_start"] = session_cols["start"]
        flat2_cols["_pw_window_end"] = session_cols["end"]
        if instance_e is not None:
            flat2_cols["_pw_instance"] = instance_e
        flat2 = table.select(**flat2_cols)
        if behavior is not None:
            flat2 = _apply_behavior(
                flat2, _remap_by_name(time_e, flat2), behavior
            )
        grouping = ["_pw_window_start", "_pw_window_end"]
        if instance_e is not None:
            grouping.append("_pw_instance")
        return WindowedTable(flat2, grouping, table)

    if isinstance(window, IntervalsOverWindow):
        return _intervals_over_windowby(table, time_e, window)

    raise TypeError(f"unknown window type {type(window)}")


def _session_assign(table: Table, time_e, instance_e, window: SessionWindow) -> Dict:
    """Build a same-universe table with session (start, end) columns."""

    def build(ctx):
        node = ctx.node(table)
        time_prog = _compile_on(ctx, [table], time_e)
        inst_prog = (
            _compile_on(ctx, [table], instance_e) if instance_e is not None else None
        )
        from pathway_tpu_torch.engine.exchange import exchange_by_key, exchange_by_value

        # multi-worker: sessions chain within an instance — co-locate it,
        # then send the per-row assignments back to their key owners
        node = exchange_by_value(
            ctx.engine,
            node,
            inst_prog or (lambda keys, rows: [None] * len(keys)),
        )
        return exchange_by_key(ctx.engine, SessionAssignNode(
            ctx.engine, node, time_prog, inst_prog, window.predicate, window.max_gap
        ))

    schema = schema_from_columns(
        {
            "start": ColumnSchema(name="start", dtype=dt.ANY),
            "end": ColumnSchema(name="end", dtype=dt.ANY),
        }
    )
    sess_table = Table(schema=schema, universe=table._universe, build=build)
    return {"start": sess_table.start, "end": sess_table.end}


from pathway_tpu_torch.engine.engine import Engine, Node  # noqa: E402
from pathway_tpu_torch.engine.operators import _DiffCache, _freeze  # noqa: E402


class SessionAssignNode(Node):
    """Assigns (session_start, session_end) per row by re-chaining each
    affected instance (reference: session windows via sort + pointer jumping,
    stdlib/temporal/_window.py:65-140)."""

    name = "session_assign"
    snapshot_attrs = ('rows', 'cache')

    def __init__(self, engine, input_, time_prog, inst_prog, predicate, max_gap):
        super().__init__(engine, [input_])
        self.time_prog = time_prog
        self.inst_prog = inst_prog
        self.predicate = predicate
        self.max_gap = max_gap
        self.rows: Dict[Any, tuple] = {}  # key -> (time_value, instance)
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        times = self.time_prog(keys, rows)
        insts = (
            self.inst_prog(keys, rows)
            if self.inst_prog is not None
            else [None] * len(keys)
        )
        affected: Set = set()
        for (key, values, diff), tv, inst in zip(deltas, times, insts):
            inst = _freeze(inst)
            affected.add(inst)
            if diff > 0:
                self.rows[key] = (tv, inst)
            else:
                self.rows.pop(key, None)
        out = []
        for inst in affected:
            members = sorted(
                ((tv, k) for k, (tv, i) in self.rows.items() if i == inst)
            )
            new_rows: Dict[Any, tuple] = {}
            if members:
                chain: List[List] = [[members[0]]]
                for prev, cur in zip(members, members[1:]):
                    merge = (
                        self.predicate(prev[0], cur[0])
                        if self.predicate is not None
                        else (cur[0] - prev[0]) <= self.max_gap
                    )
                    if merge:
                        chain[-1].append(cur)
                    else:
                        chain.append([cur])
                for sess in chain:
                    start = sess[0][0]
                    end = sess[-1][0]
                    for _tv, k in sess:
                        new_rows[k] = (start, end)
            self.cache.diff(inst, new_rows, out)
        self.emit(time, out)


def _intervals_over_windowby(
    table: Table, time_e, window: IntervalsOverWindow
) -> WindowedTable:
    """intervals_over: per `at` point, membership of rows with time in
    [at+lower, at+upper] (reference: _window.py:509)."""
    from pathway_tpu_torch.internals.expression import collect_tables

    at_expr = window.at
    at_tables = list(collect_tables(at_expr, set()))
    if len(at_tables) != 1:
        raise ValueError("intervals_over at= must reference exactly one table")
    at_table = at_tables[0]
    lower, upper, is_outer = window.lower_bound, window.upper_bound, window.is_outer

    def build(ctx):
        data_node = ctx.node(table)
        at_node = ctx.node(at_table)
        time_prog = _compile_on(ctx, [table], time_e)
        at_prog = _compile_on(ctx, [at_table], at_expr)
        from pathway_tpu_torch.engine.exchange import (
            exchange_by_key,
            exchange_to_worker,
        )

        # multi-worker: every at-point may touch any data row — gather
        data_node = exchange_to_worker(ctx.engine, data_node, 0)
        at_node = exchange_to_worker(ctx.engine, at_node, 0)
        return exchange_by_key(ctx.engine, IntervalsOverNode(
            ctx.engine,
            data_node,
            at_node,
            time_prog,
            at_prog,
            lower,
            upper,
            is_outer,
            data_width=len(table.column_names()),
        ))

    cols = dict(table._schema.columns().items())
    out_cols = {
        name: ColumnSchema(name=name, dtype=dt.Optionalize(c.dtype))
        for name, c in cols.items()
    }
    out_cols["_pw_window"] = ColumnSchema(name="_pw_window", dtype=dt.ANY)
    # the reference exposes the interval's at-point as
    # `_pw_window_location` (stdlib/temporal/_window.py intervals_over)
    out_cols["_pw_window_location"] = ColumnSchema(
        name="_pw_window_location", dtype=dt.ANY
    )
    flat = Table(
        schema=schema_from_columns(out_cols), universe=Universe(), build=build
    )
    return WindowedTable(flat, ["_pw_window", "_pw_window_location"], table)


class IntervalsOverNode(Node):
    """Membership rows for each at-point's interval neighborhood."""

    name = "intervals_over"
    snapshot_attrs = ('data_rows', 'at_points', 'cache')

    def __init__(
        self,
        engine,
        data_node,
        at_node,
        time_prog,
        at_prog,
        lower,
        upper,
        is_outer,
        *,
        data_width: int,
    ):
        super().__init__(engine, [data_node, at_node])
        self.time_prog = time_prog
        self.at_prog = at_prog
        self.lower = lower
        self.upper = upper
        self.is_outer = is_outer
        self.data_width = data_width
        self.data_rows: Dict[Any, tuple] = {}  # key -> (time, row)
        self.at_points: Dict[Any, Any] = {}  # key -> at value
        self.cache = _DiffCache()

    def process(self, time: int) -> None:
        from pathway_tpu_torch.engine.value import ref_scalar

        data_deltas = self.take(0)
        at_deltas = self.take(1)
        if not data_deltas and not at_deltas:
            return
        affected_ats: Set = set()
        changed_times: List = []
        if data_deltas:
            keys = [d[0] for d in data_deltas]
            rows = ([d[1] for d in data_deltas],)
            tvs = self.time_prog(keys, rows)
            for (key, values, diff), tv in zip(data_deltas, tvs):
                if diff > 0:
                    self.data_rows[key] = (tv, values)
                else:
                    self.data_rows.pop(key, None)
                changed_times.append(tv)
        if at_deltas:
            keys = [d[0] for d in at_deltas]
            rows = ([d[1] for d in at_deltas],)
            avs = self.at_prog(keys, rows)
            for (key, values, diff), av in zip(at_deltas, avs):
                if diff > 0:
                    self.at_points[key] = av
                else:
                    self.at_points.pop(key, None)
                affected_ats.add(key)
        if changed_times:
            for ak, av in self.at_points.items():
                for tv in changed_times:
                    if av + self.lower <= tv <= av + self.upper:
                        affected_ats.add(ak)
                        break
        out = []
        for ak in affected_ats:
            new_rows: Dict[Any, tuple] = {}
            if ak in self.at_points:
                av = self.at_points[ak]
                members = [
                    (k, row)
                    for k, (tv, row) in self.data_rows.items()
                    if av + self.lower <= tv <= av + self.upper
                ]
                if members:
                    for k, row in members:
                        new_rows[ref_scalar(ak, k)] = (*row, (av,), av)
                elif self.is_outer:
                    new_rows[ref_scalar(ak, None)] = (
                        *(None,) * self.data_width,
                        (av,),
                        av,
                    )
            self.cache.diff(ak, new_rows, out)
        self.emit(time, out)
