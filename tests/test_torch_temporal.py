"""`pw.temporal` in the port against the JAX package's, on the CPU.

The harness is tests/test_torch_framework.py's: each case is a function
`build(pw, tmp)` run once through `pathway_tpu` and once through
`pathway_tpu_torch` on the same input (markdown tables, or rows from
`numpy.random.default_rng(seed)`), and the two `pw.io.subscribe` update
streams must be EQUAL, keys and engine times included. The cases cover
the windows (tumbling, sliding, session by gap and by predicate,
intervals_over) on int and datetime times with `instance=`, the temporal
behaviors on streaming input (`__time__` / `__diff__`), asof joins in
every mode and direction, asof-now joins, interval and window joins in
every mode, the `Table` grafts, and inactivity detection.
"""

from __future__ import annotations

import datetime

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from test_torch_framework import _both

MODES = ("inner", "left", "right", "outer")
DIRECTIONS = ("BACKWARD", "FORWARD", "NEAREST")

_EVENTS = """
    t  | g | v
    1  | a | 1
    4  | b | 2
    7  | a | 3
    11 | a | 5
    12 | b | 4
    19 | b | 7
    23 | a | 6
    31 | b | 8
"""


def _rng_events(pw, n=60, seed=0):
    """`n` rows (t, g, v) from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 100, n)
    gs = rng.integers(0, 3, n)
    vs = rng.integers(-5, 20, n)
    return pw.debug.table_from_rows(
        pw.schema_from_types(t=int, g=str, v=int),
        [(int(t), f"g{g}", int(v)) for t, g, v in zip(ts, gs, vs)],
    )


def _window_columns(pw, instance: bool):
    cols = dict(
        start=pw.this._pw_window_start,
        end=pw.this._pw_window_end,
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.v),
        vals=pw.reducers.sorted_tuple(pw.this.v),
    )
    if instance:
        cols["g"] = pw.this._pw_instance
    return cols


# -- windows ------------------------------------------------------------------


def case_tumbling_instance(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.tumbling(duration=10), instance=t.g
    ).reduce(**_window_columns(pw, True))


def case_tumbling_origin(pw, tmp):
    t = _rng_events(pw, seed=1)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.tumbling(duration=7, origin=3)
    ).reduce(**_window_columns(pw, False))


def case_sliding_instance(pw, tmp):
    t = _rng_events(pw, seed=2)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.sliding(hop=5, duration=15), instance=pw.this.g
    ).reduce(**_window_columns(pw, True))


def case_sliding_ratio(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.sliding(hop=4, ratio=3)
    ).reduce(**_window_columns(pw, False))


def case_session_max_gap_instance(pw, tmp):
    t = _rng_events(pw, seed=3)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.session(max_gap=4), instance=t.g
    ).reduce(**_window_columns(pw, True))


def case_session_predicate(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.session(predicate=lambda a, b: abs(a - b) <= 4)
    ).reduce(**_window_columns(pw, False))


def _at_table(pw):
    return pw.debug.table_from_markdown(
        """
        at
        5
        12
        40
        """
    )


def case_intervals_over(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    at = _at_table(pw)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.intervals_over(at=at.at, lower_bound=-4, upper_bound=3)
    ).reduce(
        at=pw.this._pw_window_location,
        n=pw.reducers.count(),
        vals=pw.reducers.sorted_tuple(pw.this.v),
    )


def case_intervals_over_not_outer(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    at = _at_table(pw)
    return pw.temporal.windowby(
        t,
        t.t,
        window=pw.temporal.intervals_over(
            at=at.at, lower_bound=-4, upper_bound=3, is_outer=False
        ),
    ).reduce(at=pw.this._pw_window_location, vals=pw.reducers.sorted_tuple(pw.this.v))


_T0 = datetime.datetime(2024, 3, 1, 12, 0, 0)


def _dt_events(pw, seed=4, n=40):
    rng = np.random.default_rng(seed)
    secs = rng.integers(0, 3600, n)
    gs = rng.integers(0, 2, n)
    vs = rng.integers(0, 50, n)
    return pw.debug.table_from_rows(
        pw.schema_from_types(t=pw.DateTimeNaive, g=str, v=int),
        [
            (_T0 + datetime.timedelta(seconds=int(s)), f"g{g}", int(v))
            for s, g, v in zip(secs, gs, vs)
        ],
    )


def case_tumbling_datetime_instance(pw, tmp):
    t = _dt_events(pw)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.tumbling(duration=datetime.timedelta(minutes=10)),
        instance=t.g,
    ).reduce(**_window_columns(pw, True))


def case_sliding_datetime(pw, tmp):
    t = _dt_events(pw, seed=5)
    return pw.temporal.windowby(
        t,
        t.t,
        window=pw.temporal.sliding(
            hop=datetime.timedelta(minutes=5), duration=datetime.timedelta(minutes=15)
        ),
    ).reduce(**_window_columns(pw, False))


def case_session_datetime_instance(pw, tmp):
    t = _dt_events(pw, seed=6)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.session(max_gap=datetime.timedelta(minutes=3)),
        instance=t.g,
    ).reduce(**_window_columns(pw, True))


# -- behaviors on streaming input -------------------------------------------

_STREAM = """
    t  | v | __time__ | __diff__
    1  | 1 | 2        | 1
    3  | 2 | 4        | 1
    12 | 4 | 6        | 1
    2  | 5 | 8        | 1
    3  | 2 | 10       | -1
    25 | 3 | 12       | 1
    4  | 9 | 14       | 1
    38 | 6 | 16       | 1
    13 | 7 | 18       | 1
"""


def _stream_windows(pw, behavior, window=None):
    t = pw.debug.table_from_markdown(_STREAM)
    return pw.temporal.windowby(
        t, t.t, window=window or pw.temporal.tumbling(duration=10), behavior=behavior
    ).reduce(**_window_columns(pw, False))


def case_stream_no_behavior(pw, tmp):
    return _stream_windows(pw, None)


def case_stream_common_delay(pw, tmp):
    return _stream_windows(pw, pw.temporal.common_behavior(delay=5))


def case_stream_common_cutoff(pw, tmp):
    return _stream_windows(pw, pw.temporal.common_behavior(cutoff=4))


def case_stream_common_cutoff_forget(pw, tmp):
    return _stream_windows(pw, pw.temporal.common_behavior(cutoff=4, keep_results=False))


def case_stream_common_delay_cutoff_sliding(pw, tmp):
    return _stream_windows(
        pw, pw.temporal.common_behavior(delay=2, cutoff=6),
        window=pw.temporal.sliding(hop=5, duration=10),
    )


def case_stream_exactly_once(pw, tmp):
    return _stream_windows(pw, pw.temporal.exactly_once_behavior())


def case_stream_exactly_once_shift(pw, tmp):
    return _stream_windows(pw, pw.temporal.exactly_once_behavior(shift=3))


def case_stream_exactly_once_session(pw, tmp):
    return _stream_windows(
        pw, pw.temporal.exactly_once_behavior(), window=pw.temporal.session(max_gap=3)
    )


# -- temporal joins ------------------------------------------------------------

_LEFT = """
    lt | k | lv
    2  | a | 1
    5  | b | 2
    9  | a | 3
    14 | a | 4
    20 | b | 5
    27 | c | 6
"""
_RIGHT = """
    rt | k | rv
    1  | a | 10
    6  | a | 20
    6  | b | 30
    13 | b | 40
    16 | a | 50
    30 | a | 60
"""


def _sides(pw):
    return pw.debug.table_from_markdown(_LEFT), pw.debug.table_from_markdown(_RIGHT)


def _asof_case(mode, direction):
    def build(pw, tmp):
        left, right = _sides(pw)
        return pw.temporal.asof_join(
            left, right, left.lt, right.rt, left.k == right.k,
            how=pw.JoinMode[mode.upper()],
            direction=pw.temporal.Direction[direction],
        ).select(lt=pw.left.lt, lv=pw.left.lv, rt=pw.right.rt, rv=pw.right.rv)

    return build


def case_asof_join_defaults_graft(pw, tmp):
    left, right = _sides(pw)
    return left.asof_join_left(
        right, left.lt, right.rt, defaults={right.rv: -1}
    ).select(lv=pw.left.lv, rv=pw.right.rv, rt=pw.right.rt)


def case_asof_join_stream(pw, tmp):
    left = pw.debug.table_from_markdown(
        """
        lt | lv | __time__
        5  | a  | 2
        15 | b  | 4
        9  | c  | 8
        """
    )
    right = pw.debug.table_from_markdown(
        """
        rt | rv | __time__ | __diff__
        3  | x  | 2        | 1
        10 | y  | 6        | 1
        3  | x  | 8        | -1
        8  | z  | 10       | 1
        """
    )
    return left.asof_join_outer(right, left.lt, right.rt).select(
        lv=pw.left.lv, rv=pw.right.rv
    )


_NOW_QUERIES = """
    qk | qv | __time__
    a  | q1 | 4
    b  | q2 | 4
    a  | q3 | 10
    c  | q4 | 10
"""
_NOW_DATA = """
    dk | dv | __time__ | __diff__
    a  | d1 | 2        | 1
    b  | d2 | 2        | 1
    a  | d3 | 6        | 1
    b  | d2 | 8        | -1
    a  | d4 | 12       | 1
"""


def case_asof_now_join_inner(pw, tmp):
    q = pw.debug.table_from_markdown(_NOW_QUERIES)
    d = pw.debug.table_from_markdown(_NOW_DATA)
    return pw.temporal.asof_now_join(q, d, q.qk == d.dk).select(qv=q.qv, dv=d.dv)


def case_asof_now_join_left_graft(pw, tmp):
    q = pw.debug.table_from_markdown(_NOW_QUERIES)
    d = pw.debug.table_from_markdown(_NOW_DATA)
    return q.asof_now_join_left(d, q.qk == d.dk).select(qv=pw.left.qv, dv=pw.right.dv)


def _interval_case(mode):
    def build(pw, tmp):
        left, right = _sides(pw)
        return pw.temporal.interval_join(
            left, right, left.lt, right.rt, pw.temporal.interval(-3, 2), left.k == right.k,
            how=pw.JoinMode[mode.upper()],
        ).select(lt=pw.left.lt, lv=pw.left.lv, rt=pw.right.rt, rv=pw.right.rv)

    return build


def case_interval_join_grafts_no_on(pw, tmp):
    left, right = _sides(pw)
    inner = left.interval_join_inner(right, left.lt, right.rt, pw.temporal.interval(-1, 1))
    outer = left.interval_join_outer(right, left.lt, right.rt, pw.temporal.interval(0, 4))
    return {
        "inner": inner.select(lv=pw.left.lv, rv=pw.right.rv),
        "outer": outer.select(lv=pw.left.lv, rv=pw.right.rv),
    }


def case_interval_join_stream_behavior(pw, tmp):
    left = pw.debug.table_from_markdown(
        """
        lt | lv | __time__
        0  | a  | 2
        10 | b  | 4
        1  | c  | 8
        """
    )
    right = pw.debug.table_from_markdown(
        """
        rt | rv | __time__
        1  | x  | 2
        11 | y  | 6
        2  | z  | 10
        """
    )
    return pw.temporal.interval_join(
        left, right, left.lt, right.rt, pw.temporal.interval(-2, 2),
        behavior=pw.temporal.common_behavior(cutoff=5),
    ).select(lv=pw.left.lv, rv=pw.right.rv)


def _window_join_case(mode):
    def build(pw, tmp):
        left, right = _sides(pw)
        return pw.temporal.window_join(
            left, right, left.lt, right.rt, pw.temporal.tumbling(duration=8), left.k == right.k,
            how=pw.JoinMode[mode.upper()],
        ).select(lt=pw.left.lt, lv=pw.left.lv, rt=pw.right.rt, rv=pw.right.rv)

    return build


def case_window_join_sliding_graft(pw, tmp):
    left, right = _sides(pw)
    return left.window_join_left(
        right, left.lt, right.rt, pw.temporal.sliding(hop=4, duration=8)
    ).select(lv=pw.left.lv, rv=pw.right.rv)


def case_window_join_session_graft(pw, tmp):
    left, right = _sides(pw)
    return left.window_join_outer(
        right, left.lt, right.rt, pw.temporal.session(max_gap=2), left.k == right.k
    ).select(lv=pw.left.lv, rv=pw.right.rv)


def case_window_join_right_graft(pw, tmp):
    left, right = _sides(pw)
    return left.window_join_right(
        right, left.lt, right.rt, pw.temporal.tumbling(duration=5)
    ).select(lv=pw.left.lv, rv=pw.right.rv)


def case_table_windowby_graft(pw, tmp):
    t = _rng_events(pw, seed=7)
    return t.windowby(
        t.t, window=pw.temporal.sliding(hop=10, duration=30), instance=t.g
    ).reduce(**_window_columns(pw, True))


def case_pw_windowby_tumbling_export(pw, tmp):
    t = pw.debug.table_from_markdown(_EVENTS)
    return pw.windowby(t, t.t, window=pw.tumbling(duration=6)).reduce(
        **_window_columns(pw, False)
    )


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}
for _m in MODES:
    for _d in DIRECTIONS:
        CASES[f"asof_join_{_m}_{_d.lower()}"] = _asof_case(_m, _d)
    CASES[f"interval_join_{_m}"] = _interval_case(_m)
    CASES[f"window_join_{_m}"] = _window_join_case(_m)


@pytest.mark.parametrize("case", sorted(CASES))
def test_temporal_stream_matches_jax(case, tmp_path):
    want, got = _both(CASES[case], str(tmp_path))
    assert want, "the case produced no deltas"
    assert got == want


def _first_inactivity_alert(pw, stale):
    """inactivity_detection over one stale event, run until its first
    alert; utc_now is a clock-driven source, so the alert's row is held
    and not its engine time."""
    pw.G.clear()
    try:
        t = pw.debug.table_from_rows(pw.schema_from_types(ts=pw.DateTimeUtc), [(stale,)])
        inactive, resumed = pw.temporal.inactivity_detection(
            t.ts,
            allowed_inactivity_period=datetime.timedelta(minutes=5),
            refresh_rate=datetime.timedelta(milliseconds=20),
        )
        alerts, resumes = [], []
        engines = []
        pw.G.add_sink([inactive], lambda ctx, nodes: engines.append(ctx.engine))

        def on_alert(key, row, time, is_addition):  # noqa: A002
            alerts.append((row["inactive_since"], is_addition))
            engines[0].terminate_flag.set()

        pw.io.subscribe(inactive, on_change=on_alert)
        pw.io.subscribe(
            resumed,
            on_change=lambda key, row, time, is_addition: resumes.append(row["resumed_at"]),
        )
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return alerts[0], resumes


def test_inactivity_detection_matches_jax():
    stale = datetime.datetime.now(datetime.timezone.utc) - datetime.timedelta(hours=2)
    want = _first_inactivity_alert(jpw, stale)
    got = _first_inactivity_alert(tpw, stale)
    assert want == ((stale, True), [])
    assert got == want


@pytest.mark.parametrize(
    "name",
    [
        "asof_join", "asof_join_left", "asof_join_right", "asof_join_outer",
        "asof_now_join", "asof_now_join_inner", "asof_now_join_left",
        "window_join", "window_join_inner", "window_join_left", "window_join_right",
        "window_join_outer", "interval_join", "interval_join_inner", "interval_join_left",
        "interval_join_right", "interval_join_outer", "windowby", "interpolate",
        "inactivity_detection", "diff",
    ],
)
def test_table_graft_is_the_stdlib_function(name):
    """Each Table method the JAX package grafts is grafted in the port, onto
    the port's function of the same module and name."""
    jfn, tfn = getattr(jpw.Table, name), getattr(tpw.Table, name)
    assert tfn.__name__ == jfn.__name__
    assert tfn.__module__ == jfn.__module__.replace("pathway_tpu", "pathway_tpu_torch", 1)
