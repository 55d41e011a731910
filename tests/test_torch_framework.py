"""The port's host framework against the JAX package's, on the CPU.

Each case is one function `build(pw, tmp)` that builds a dataflow through
the package it is given and returns the tables to watch. It runs once
through `pathway_tpu` and once through `pathway_tpu_torch` on the same
input: a markdown table, or files written from
`numpy.random.default_rng(seed)` before either run. `pw.io.subscribe`
records every delta as (table, key, row, time, is_addition), and the two
streams must be EQUAL: same order, same values, same keys (blake2b-derived,
so deterministic) and same engine times. The one exception is the
streaming fs case, whose times come from the clock; it compares the final
table and its keys. Values are compared after mapping each package's
Pointer / Json / Error classes to plain tuples.

The two packages keep separate global parse graphs (`pw.G`); each run
clears its own before and after.
"""

from __future__ import annotations

import datetime
import io
import json
import math
import os
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"jax": jpw, "port": tpw}


def _norm(v):
    """Package-neutral form of an engine value."""
    name = type(v).__name__
    if name == "Pointer":
        return ("Pointer", v.value)
    if name == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True, default=str))
    if name == "Error":
        return ("Error",)
    if name == "PyObjectWrapper":
        return ("PyObjectWrapper", _norm(v.value))
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tolist())
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return v


def _stream(pw, build, tmp):
    """Run `build` through `pw`; every subscribed delta, in order."""
    pw.G.clear()
    try:
        tables = build(pw, tmp)
        if not isinstance(tables, dict):
            tables = {"out": tables}
        events = []
        for name, table in tables.items():

            def on_change(key, row, time, is_addition, name=name):
                events.append((name, _norm(key), _norm(row), time, is_addition))

            pw.io.subscribe(table, on_change=on_change)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return events


def _both(build, tmp):
    """(jax stream, port stream)."""
    return tuple(_stream(PACKAGES[p], build, tmp) for p in ("jax", "port"))


# -- the cases ---------------------------------------------------------------

_NUMBERS = """
    a  | b   | f    | s
    7  | 2   | 1.5  | Alpha
    -3 | 5   | -0.25| beta gamma
    10 | 4   | 2.0  | 42
    0  | 9   | 3.75 | Delta
"""


def case_select_arithmetic(pw, tmp):
    t = pw.debug.table_from_markdown(_NUMBERS)
    return t.select(
        pw.this.a,
        add=pw.this.a + pw.this.b,
        mul=pw.this.a * pw.this.b,
        div=pw.this.a / pw.this.b,
        floordiv=pw.this.a // pw.this.b,
        mod=pw.this.a % pw.this.b,
        neg=-pw.this.a,
        pow=pw.this.b ** 2,
        fmix=pw.this.f * pw.this.a + 0.5,
        cmp=pw.this.a > pw.this.b,
        both=(pw.this.a > 0) & (pw.this.b < 5),
    )


def case_with_columns_str_num(pw, tmp):
    t = pw.debug.table_from_markdown(_NUMBERS)
    return t.with_columns(
        up=pw.this.s.str.upper(),
        low=pw.this.s.str.lower(),
        n=pw.this.s.str.len(),
        rep=pw.this.s.str.replace("a", "4"),
        starts=pw.this.s.str.startswith("b"),
        absa=pw.this.a.num.abs(),
        rounded=pw.this.f.num.round(1),
        as_str=pw.cast(str, pw.this.a),
        as_float=pw.cast(float, pw.this.a),
    )


def case_dt_namespace(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        s
        2024-01-15T08:30:00
        2023-12-31T23:59:59
        2025-06-01T00:00:01
        """
    )
    ts = t.select(ts=pw.this.s.dt.strptime("%Y-%m-%dT%H:%M:%S"))
    return ts.select(
        y=pw.this.ts.dt.year(),
        mo=pw.this.ts.dt.month(),
        d=pw.this.ts.dt.day(),
        h=pw.this.ts.dt.hour(),
        back=pw.this.ts.dt.strftime("%d/%m/%Y %H:%M"),
        later=pw.this.ts + datetime.timedelta(hours=30),
    )


def case_filter(pw, tmp):
    t = pw.debug.table_from_markdown(_NUMBERS)
    return t.filter((pw.this.a > 0) | (pw.this.f > 3.0)).select(pw.this.a, pw.this.s)


_GROUPS = """
    g | v  | w   | tag
    x | 5  | 1.0 | p
    y | 3  | 2.5 | q
    x | -1 | 0.5 | r
    z | 8  | 4.0 | s
    y | 3  | 1.5 | t
    x | 2  | 2.0 | u
"""


def case_groupby_reduce(pw, tmp):
    t = pw.debug.table_from_markdown(_GROUPS)
    return t.groupby(pw.this.g).reduce(
        pw.this.g,
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.v),
        lo=pw.reducers.min(pw.this.v),
        hi=pw.reducers.max(pw.this.v),
        mean=pw.reducers.avg(pw.this.w),
        tags=pw.reducers.tuple(pw.this.tag),
        sorted_v=pw.reducers.sorted_tuple(pw.this.v),
        arg_lo=pw.reducers.argmin(pw.this.v),
        some=pw.reducers.any(pw.this.tag),
    )


def case_groupby_two_columns(pw, tmp):
    t = pw.debug.table_from_markdown(_GROUPS)
    r = t.groupby(pw.this.g, pw.this.v).reduce(
        pw.this.g, pw.this.v, wsum=pw.reducers.sum(pw.this.w)
    )
    return r.groupby(pw.this.g).reduce(pw.this.g, groups=pw.reducers.count())


def _join_inputs(pw):
    left = pw.debug.table_from_markdown(
        """
        k | a
        1 | l1
        2 | l2
        2 | l2b
        4 | l4
        """
    )
    right = pw.debug.table_from_markdown(
        """
        k | b
        2 | r2
        3 | r3
        4 | r4
        4 | r4b
        """
    )
    return left, right


def case_join_inner(pw, tmp):
    left, right = _join_inputs(pw)
    return left.join(right, left.k == right.k).select(left.k, left.a, right.b)


def case_join_left(pw, tmp):
    left, right = _join_inputs(pw)
    return left.join_left(right, left.k == right.k).select(
        left.a, rb=pw.coalesce(right.b, "none")
    )


def case_join_outer(pw, tmp):
    left, right = _join_inputs(pw)
    return left.join_outer(right, left.k == right.k).select(
        lk=left.k, rk=right.k, a=left.a, b=right.b
    )


def case_concat_update_rows(pw, tmp):
    one = pw.debug.table_from_markdown(
        """
        v
        1
        2
        """
    )
    two = pw.debug.table_from_markdown(
        """
        v
        3
        4
        """
    )
    base = pw.debug.table_from_markdown(
        """
        id | v
        1  | 10
        2  | 20
        """
    )
    patch = pw.debug.table_from_markdown(
        """
        id | v
        2  | 99
        3  | 30
        """
    )
    return {"concat": one.concat_reindex(two), "updated": base.update_rows(patch)}


def case_flatten_wordcount(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        line
        the_quick_fox
        the_lazy_dog
        a_quick_dog_the
        """
    )
    words = t.select(ws=pw.this.line.str.split("_")).flatten(pw.this.ws)
    return words.groupby(pw.this.ws).reduce(word=pw.this.ws, count=pw.reducers.count())


def case_ix_ref(pw, tmp):
    t = pw.debug.table_from_markdown(_GROUPS)
    sums = t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v))
    return t.select(pw.this.g, pw.this.v, gsum=sums.ix_ref(pw.this.g).s)


def case_sort(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        v
        30
        10
        20
        40
        """
    )
    return t.sort(key=pw.this.v)


def case_deduplicate(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        v | __time__
        1 | 2
        5 | 4
        3 | 6
        9 | 8
        """
    )
    return t.deduplicate(value=pw.this.v, acceptor=lambda new, old: new > old)


def case_apply_if_else_coalesce(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 4
        5 |
        -2| 7
        """
    )
    return t.select(
        sq=pw.apply(lambda x: x * x + 1, pw.this.a),
        typed=pw.apply_with_type(lambda x: f"<{x}>", str, pw.this.a),
        sign=pw.if_else(pw.this.a > 0, "pos", "neg"),
        b=pw.coalesce(pw.this.b, -1),
        tup=pw.make_tuple(pw.this.a, pw.this.b),
    )


def case_error_values(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        a | b
        6 | 3
        1 | 0
        8 | 2
        """
    )
    r = t.select(pw.this.a, q=pw.this.a // pw.this.b)
    return {"raw": r, "filled": r.select(pw.this.a, q=pw.fill_error(pw.this.q, -1))}


def case_time_diff_stream(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        id | g | v | __time__ | __diff__
        1  | a | 1 | 2        | 1
        2  | b | 2 | 2        | 1
        3  | a | 3 | 4        | 1
        1  | a | 1 | 6        | -1
        4  | b | 5 | 6        | 1
        2  | b | 2 | 8        | -1
        """
    )
    return {
        "rows": t.select(pw.this.g, pw.this.v),
        "sums": t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v)),
    }


def _write_inputs(tmp, seed=0, n_files=3, rows=40):
    """csv, jsonlines and plaintext inputs from one seeded generator."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    for fmt in ("csv", "jsonl", "txt"):
        os.makedirs(os.path.join(tmp, fmt), exist_ok=True)
    for f in range(n_files):
        ks = rng.choice(words, size=rows)
        vs = rng.integers(-50, 50, size=rows)
        xs = np.round(rng.standard_normal(rows), 4)
        with open(os.path.join(tmp, "csv", f"part{f}.csv"), "w") as fh:
            fh.write("k,v,x\n")
            fh.writelines(f"{k},{v},{x}\n" for k, v, x in zip(ks, vs, xs))
        with open(os.path.join(tmp, "jsonl", f"part{f}.jsonl"), "w") as fh:
            fh.writelines(
                json.dumps({"k": str(k), "v": int(v), "x": float(x)}) + "\n"
                for k, v, x in zip(ks, vs, xs)
            )
        with open(os.path.join(tmp, "txt", f"part{f}.txt"), "w") as fh:
            fh.writelines(" ".join(rng.choice(words, size=5)) + "\n" for _ in range(rows // 4))


def _schema(pw):
    class S(pw.Schema):
        k: str
        v: int
        x: float

    return S


def case_fs_csv_static(pw, tmp):
    t = pw.io.fs.read(os.path.join(tmp, "csv"), format="csv", schema=_schema(pw), mode="static")
    return t.groupby(pw.this.k).reduce(
        pw.this.k, n=pw.reducers.count(), v=pw.reducers.sum(pw.this.v),
        x=pw.reducers.max(pw.this.x),
    )


def case_csv_read_rows(pw, tmp):
    return pw.io.csv.read(os.path.join(tmp, "csv"), schema=_schema(pw), mode="static")


def case_fs_jsonlines_static(pw, tmp):
    t = pw.io.jsonlines.read(os.path.join(tmp, "jsonl"), schema=_schema(pw), mode="static")
    return t.filter(pw.this.v > 0).select(pw.this.k, y=pw.this.x * pw.this.v)


def case_fs_plaintext_static(pw, tmp):
    t = pw.io.plaintext.read(os.path.join(tmp, "txt"), mode="static")
    words = t.select(ws=pw.this.data.str.split(" ")).flatten(pw.this.ws)
    return words.groupby(pw.this.ws).reduce(word=pw.this.ws, n=pw.reducers.count())


def case_slice_end_to_end(pw, tmp):
    """The slice as a whole: two fs formats -> select / filter / flatten /
    groupby / join -> subscribe."""
    rows = pw.io.fs.read(os.path.join(tmp, "jsonl"), format="json", schema=_schema(pw), mode="static")
    text = pw.io.fs.read(os.path.join(tmp, "txt"), format="plaintext", mode="static")
    words = text.select(ws=pw.this.data.str.split(" ")).flatten(pw.this.ws)
    counts = words.groupby(pw.this.ws).reduce(k=pw.this.ws, mentions=pw.reducers.count())
    stats = rows.filter(pw.this.x > -1.0).groupby(pw.this.k).reduce(
        pw.this.k, v=pw.reducers.sum(pw.this.v), n=pw.reducers.count()
    )
    return stats.join(counts, stats.k == counts.k).select(
        stats.k, stats.v, stats.n, counts.mentions, ratio=stats.v / counts.mentions
    )


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}
_FILE_CASES = {"fs_csv_static", "csv_read_rows", "fs_jsonlines_static", "fs_plaintext_static",
               "slice_end_to_end"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_subscribe_stream_matches_jax(case, tmp_path):
    tmp = str(tmp_path)
    if case in _FILE_CASES:
        _write_inputs(tmp)
    want, got = _both(CASES[case], tmp)
    assert want, "the case produced no deltas"
    assert got == want


def test_compute_and_print_matches_jax(tmp_path):
    outs = []
    for pw in (jpw, tpw):
        pw.G.clear()
        buf = io.StringIO()
        with redirect_stdout(buf):
            pw.debug.compute_and_print(case_groupby_reduce(pw, str(tmp_path)))
            pw.debug.compute_and_print(case_join_outer(pw, str(tmp_path)), include_id=False)
        pw.G.clear()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "tags" in outs[0]


def test_csv_write_is_byte_identical(tmp_path):
    tmp = str(tmp_path)
    _write_inputs(tmp, seed=3)
    outs = {}
    for name, pw in PACKAGES.items():
        pw.G.clear()
        t = case_fs_csv_static(pw, tmp)
        stream = case_time_diff_stream(pw, tmp)["sums"]
        pw.io.csv.write(t, os.path.join(tmp, f"{name}_static.csv"))
        pw.io.csv.write(stream, os.path.join(tmp, f"{name}_stream.csv"))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        pw.G.clear()
        outs[name] = [
            open(os.path.join(tmp, f"{name}_{kind}.csv"), "rb").read()
            for kind in ("static", "stream")
        ]
    assert outs["jax"] == outs["port"]
    assert outs["port"][0].count(b"\n") == 6 and b"diff" in outs["port"][1]


def test_streaming_fs_matches_jax_final_table(tmp_path):
    """fs read in streaming mode picks up a file written after the run
    starts; times come from the clock, so the final table and its keys are
    compared, not the times."""
    final = [{"k": "a", "s": 4}, {"k": "b", "s": 2}, {"k": "c", "s": 5}]
    finals = {}
    for name, pw in PACKAGES.items():
        src = tmp_path / name
        src.mkdir()
        (src / "a.csv").write_text("k,v\na,1\nb,2\n")

        class S(pw.Schema):
            k: str
            v: int

        pw.G.clear()
        t = pw.io.csv.read(str(src), schema=S, mode="streaming", refresh_interval=0.05)
        sums = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
        engines, state = [], {}
        pw.G.add_sink([t], lambda ctx, nodes: engines.append(ctx.engine))
        done = threading.Event()

        def on_change(key, row, time, is_addition, state=state, done=done):
            if is_addition:
                state[_norm(key)] = _norm(row)
            elif state.get(_norm(key)) == _norm(row):
                del state[_norm(key)]
            if sorted(state.values(), key=repr) == final:
                done.set()

        pw.io.subscribe(sums, on_change=on_change)

        def feed(src=src, engines=engines, done=done):
            time.sleep(0.3)
            (src / "b.csv").write_text("k,v\na,3\nc,5\n")
            done.wait(20)
            while not engines:
                time.sleep(0.01)
            engines[0].terminate_flag.set()

        feeder = threading.Thread(target=feed)
        feeder.start()
        try:
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        finally:
            done.set()
            feeder.join(30)
            pw.G.clear()
        assert not feeder.is_alive()
        finals[name] = state
    assert finals["port"] == finals["jax"]
    assert sorted(finals["port"].values(), key=repr) == final


# -- DevicePipeline ----------------------------------------------------------


def _pipeline_run(module, make_handle, fail_at=None):
    """Submit 6 batches while prepare is held back, then let it run;
    prepare raises once at `fail_at`. The failed batches are taken with
    take_failed() and submitted again. Returns the dispatch order, the
    replayed items and the stats."""
    order, lock, go, failed_once = [], threading.Lock(), threading.Event(), set()

    def prepare(item):
        go.wait(30)
        if item == fail_at and item not in failed_once:
            failed_once.add(item)
            raise ValueError("injected prepare failure")
        rows = item + 1
        return (item, make_handle(item)), {"rows": rows, "real_tokens": 3 * rows,
                                          "slab_tokens": 4 * rows, "slab_bytes": 16}

    def dispatch(payload):
        item, handle = payload
        with lock:
            order.append(item)
        return handle

    pipe = module.DevicePipeline(prepare=prepare, dispatch=dispatch, name="parity",
                                 prep_workers=2, max_prepared=8, max_in_flight=2)
    replayed = []
    try:
        for item in range(6):
            pipe.submit(item)  # nothing can fail before `go`
        go.set()
        try:
            pipe.drain()
        except module.DevicePipelineError:
            replayed = pipe.take_failed()
            for item in replayed:
                pipe.submit(item)
            pipe.drain()
        stats = pipe.stats()
    finally:
        go.set()
        pipe.close()
    return order, replayed, stats


@pytest.mark.parametrize("fail_at", [None, 2, 5])
def test_device_pipeline_matches_jax(fail_at):
    import torch

    from pathway_tpu.internals import device_pipeline as jdp
    from pathway_tpu_torch.internals import device_pipeline as tdp

    want = _pipeline_run(jdp, lambda i: np.full((4,), i, dtype=np.float32), fail_at)
    got = _pipeline_run(tdp, lambda i: torch.full((4,), float(i)), fail_at)
    assert got[0] == want[0] == list(range(6))  # submission order, replays last
    assert got[1] == want[1] == ([] if fail_at is None else list(range(fail_at, 6)))
    assert set(got[2]) == set(want[2])
    assert got[2] == want[2] and got[2]["pad_waste_ratio"] == 0.25


def test_device_pipeline_default_wait_takes_cpu_tensors_and_none():
    import torch

    from pathway_tpu_torch.internals.device_pipeline import _default_wait

    for handle in (None, torch.zeros(3), torch.zeros(0), np.zeros(2)):
        assert _default_wait(handle) is None


def test_trace_points_at_the_users_line():
    """The port's user-frame tracer skips its own package's frames."""
    from pathway_tpu_torch.internals import trace

    assert os.path.basename(trace._PACKAGE_DIR) == "pathway_tpu_torch"
    tpw.G.clear()
    t = tpw.debug.table_from_markdown("v\n1\n").select(w=tpw.this.v)
    tpw.G.clear()
    assert t._trace is not None and t._trace.file == os.path.abspath(__file__)


@pytest.mark.parametrize("kwargs", [{"analysis": "warn"}, {"analysis": "strict"}, {"mesh": "dp=2"}])
def test_run_takes_the_analyzer_and_mesh_paths(kwargs):
    """Every one of these paths runs:
    analysis="warn" / "strict" run the ported static analyzer, which finds
    nothing to refuse here and attaches its result to the engine
    (tests/test_torch_analysis.py holds it to the JAX package's); a mesh
    with no held mesh and no CUDA device leaves the backend inactive, the
    spec a lint target (the analyzer on, at least "warn"), as the JAX
    package does with too few devices."""
    from pathway_tpu_torch.internals import mesh_backend
    from pathway_tpu_torch.internals.runner import last_engine

    tpw.G.clear()
    backends = []
    try:
        tpw.io.subscribe(
            tpw.debug.table_from_markdown("v\n1\n"),
            on_change=lambda *a, **k: backends.append(mesh_backend.active_backend()),
        )
        tpw.run(monitoring_level=tpw.MonitoringLevel.NONE, **kwargs)
        analysis = last_engine().analysis
        assert analysis is not None and analysis["findings"] == []
        assert backends == [None]
        if "mesh" in kwargs:
            assert last_engine().mesh == {"dp": 2}
    finally:
        tpw.G.clear()


def test_an_ingest_throttle_as_long_as_the_autocommit_interval_paces_reads(monkeypatch):
    """Under backpressure the streaming driver sleeps the health
    controller's delay each tick. A delay as long as the autocommit
    interval must pace ingest, not stop it: the sleep used to count
    toward the autocommit deadline, so every tick flushed before reading
    and the driver never read its queue again."""
    from pathway_tpu_torch.internals import health
    from pathway_tpu_torch.internals.runner import last_engine

    monkeypatch.setattr(health, "ENABLED", True)
    monkeypatch.setattr(health.controller(), "throttle_delay", lambda: 0.05)

    class Rows(tpw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(5):
                self.next(v=i)
                self.commit()

    tpw.G.clear()
    seen: list = []
    tpw.io.subscribe(
        tpw.io.python.read(Rows(), schema=tpw.schema_from_types(v=int)),
        on_change=lambda key, row, time, is_addition: seen.append(row["v"]),
    )
    run = threading.Thread(
        target=tpw.run,
        kwargs={"autocommit_duration_ms": 25, "monitoring_level": tpw.MonitoringLevel.NONE},
        daemon=True,
    )
    run.start()
    try:
        run.join(timeout=30)
        assert not run.is_alive(), f"the run read {seen} and did not end"
    finally:
        if run.is_alive():
            last_engine().terminate_flag.set()
            run.join(timeout=10)
        tpw.G.clear()
    assert sorted(seen) == list(range(5))
