"""window_join — join rows sharing a window (reference:
python/pathway/stdlib/temporal/_window_join.py). Composed from window
assignment + the regular equi-join."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.expression import ApplyExpression
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.temporal._window import (
    SessionWindow,
    SlidingWindow,
    TumblingWindow,
    Window,
)


def _with_windows(table: Table, time_expr, window: Window, prefix: str) -> Table:
    from pathway_tpu_torch.stdlib.temporal._window import _check_time_window_types

    mapping = {thisclass.this: table}
    time_e = desugar(time_expr, mapping)
    _check_time_window_types(table, time_e, window)
    if not isinstance(window, (TumblingWindow, SlidingWindow)):
        raise TypeError("window_join supports tumbling/sliding windows")
    assign = window.assign
    assign_expr = ApplyExpression(
        lambda t: assign(t), dt.ANY_TUPLE, time_e, deterministic=True
    )
    with_w = table.with_columns(**{f"{prefix}window": assign_expr})
    flat = with_w.flatten(with_w[f"{prefix}window"])
    return flat


class WindowJoinResult:
    def __init__(
        self,
        left_flat: Table,
        right_flat: Table,
        join_result: JoinResult,
        left_orig: Table,
        right_orig: Table,
    ):
        self._jr = join_result
        self._left_flat = left_flat
        self._right_flat = right_flat
        self._left_orig = left_orig
        self._right_orig = right_orig

    def select(self, *args, **kwargs) -> Table:
        # user expressions reference the ORIGINAL tables (reference API);
        # remap them onto the window-flattened copies the join runs over
        remap = lambda e: _remap_sides(  # noqa: E731
            e, self._left_orig, self._right_orig,
            self._left_flat, self._right_flat,
        )
        args = tuple(remap(a) for a in args)
        kwargs = {k: remap(v) for k, v in kwargs.items()}
        return self._jr.select(*args, **kwargs)


def window_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    window: Window,
    *on,
    how: JoinMode = JoinMode.INNER,
) -> WindowJoinResult:
    """Join rows that fall into the same time window (reference:
    stdlib/temporal/_window_join.py window_join:26).

    >>> import pathway_tpu_torch as pw
    >>> left = pw.debug.table_from_markdown('''
    ... t | a
    ... 1 | 1
    ... ''')
    >>> right = pw.debug.table_from_markdown('''
    ... t | b
    ... 2 | 10
    ... ''')
    >>> res = left.window_join(
    ...     right, left.t, right.t, pw.temporal.tumbling(duration=5)
    ... ).select(a=pw.left.a, b=pw.right.b)
    >>> pw.debug.compute_and_print(res, include_id=False)
    a | b
    1 | 10
    """
    from pathway_tpu_torch.internals.parse_graph import record_marker

    # window_join has no behavior= knob at all, so the marker exists for
    # graph inventory, not for the missing-behavior lint (PWT201 skips it
    # — there would be no way to satisfy the lint).
    record_marker(
        "window_join", has_behavior=False, window=type(window).__name__
    )
    if isinstance(how, str):
        how = JoinMode[how.upper()]
    if isinstance(window, SessionWindow):
        left_flat, right_flat = _session_sides(
            self, other, self_time, other_time, window, on
        )
    else:
        left_flat = _with_windows(self, self_time, window, "_pw_l")
        right_flat = _with_windows(other, other_time, window, "_pw_r")
    conds = [left_flat["_pw_lwindow"] == right_flat["_pw_rwindow"]]
    for cond in on:
        conds.append(_remap_sides(cond, self, other, left_flat, right_flat))
    jr = JoinResult(left_flat, right_flat, tuple(conds), mode=how)
    return WindowJoinResult(left_flat, right_flat, jr, self, other)


def _session_sides(left, right, left_time, right_time, window, on):
    """Session windows for a join are computed over the UNION of both
    sides' times (per join-key instance): rows whose session ids match
    then pair in the ordinary equi-join (reference:
    stdlib/temporal/_window_join.py session handling)."""
    from pathway_tpu_torch.internals.expression import MakeTupleExpression
    from pathway_tpu_torch.internals.joins import split_equality_condition
    from pathway_tpu_torch.internals.reducers import reducers
    from pathway_tpu_torch.stdlib.temporal._window import windowby

    lt_e = desugar(left_time, {thisclass.this: left})
    rt_e = desugar(right_time, {thisclass.this: right})
    lons, rons = [], []
    for cond in on:
        c = desugar(
            cond,
            {
                thisclass.left: left,
                thisclass.right: right,
                thisclass.this: left,
            },
        )
        a, b = split_equality_condition(c, left, right)
        lons.append(a)
        rons.append(b)

    def union_side(tab, t_e, key_exprs):
        cols = {"_pw_t": t_e}
        if key_exprs:
            cols["_pw_i"] = MakeTupleExpression(*key_exprs)
        return tab.select(**cols)

    union = union_side(left, lt_e, lons).concat_reindex(
        union_side(right, rt_e, rons)
    )
    win = windowby(
        union,
        union._pw_t,
        window=window,
        instance=union._pw_i if lons else None,
    )
    sess = win._flat  # one row per union row, with session start/end
    gb = [sess._pw_t] + ([sess._pw_instance] if lons else [])
    key_map = sess.groupby(*gb).reduce(
        *gb,
        _pw_s=reducers.any(sess._pw_window_start),
        _pw_e=reducers.any(sess._pw_window_end),
    )

    def flat_side(tab, t_e, key_exprs, prefix):
        conds = [t_e == key_map._pw_t]
        if key_exprs:
            conds.append(MakeTupleExpression(*key_exprs) == key_map._pw_instance)
        return tab.join(key_map, *conds).select(
            *[tab[c] for c in tab.column_names()],
            **{
                f"{prefix}window": MakeTupleExpression(
                    key_map._pw_s, key_map._pw_e
                )
            },
        )

    return (
        flat_side(left, lt_e, lons, "_pw_l"),
        flat_side(right, rt_e, rons, "_pw_r"),
    )


def _remap_sides(cond, left, right, left_flat, right_flat):
    import copy

    from pathway_tpu_torch.internals.expression import (
        ColumnExpression,
        ColumnReference,
        IdReference,
        ThisColumnReference,
    )

    def rec(e):
        if isinstance(e, ThisColumnReference):
            if e._this is thisclass.left:
                return left_flat[e._name]
            if e._this is thisclass.right:
                return right_flat[e._name]
            raise ValueError("window_join conditions use pw.left/pw.right")
        if isinstance(e, IdReference):
            return e
        if isinstance(e, ColumnReference):
            if e._table is left:
                return left_flat[e.name]
            if e._table is right:
                return right_flat[e.name]
            return e
        out = copy.copy(e)
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

    return rec(cond)


def window_join_inner(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.INNER)


def window_join_left(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.LEFT)


def window_join_right(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.RIGHT)


def window_join_outer(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.OUTER)
