"""The port's static analyzer (analysis/) against the JAX package's, on
the CPU.

Each case is one function `build(pw)` that records a pipeline of
tests/test_analysis.py through the package it is given; it runs once
through `pathway_tpu` and once through `pathway_tpu_torch`, and both
`analyze()` results must hold the same findings (code, severity and
message, in order) and the same capacity section. `pw.run(analysis=...)`
must raise `AnalysisError` where the JAX package's does and attach the
same codes where it runs. The capacity plan is also held against the
port's own live memtrack bytes at widths (3, 6) where the port's index
rows are padded and the JAX package's are not.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from importlib import import_module

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"jax": jpw, "port": tpw}
# a 256 MiB card, so the PWT6xx capacity findings are the same on every
# machine (the resolver would otherwise ask the device)
ASSUMED_HBM = str(256 * 2**20)


def _mod(pw, name):
    return import_module(f"{pw.__name__}.{name}")


def _sink(pw, *tables):
    for t in tables:
        pw.io.subscribe(t, on_change=lambda *a, **k: None)


# -- the pipelines of tests/test_analysis.py, for either package -----------


def _lintful(pw):
    """tests/test_analysis.py build_lintful_graph: one graph that trips
    every statically reachable diagnostic."""
    dt = _mod(pw, "internals.dtype")
    record_op = _mod(pw, "internals.parse_graph").record_op
    t = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, age=int, score=float, grp=float),
        [("a", 1, 1.5, 0.5), ("b", 2, 2.5, 0.5)],
    )
    lossy = t.select(name=t.name, age_i=pw.cast(int, t.score))
    bad_cmp = t.filter(t.name == t.age)
    opt = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, v=dt.Optionalized(dt.INT)), [("a", 1)]
    )
    arith = opt.select(k=opt.k, w=opt.v + 1)
    by_float = t.groupby(t.grp).reduce(t.grp, c=pw.reducers.count())
    tup = t.groupby(t.name).reduce(t.name, xs=pw.reducers.tuple(t.age))
    left = t.select(key=pw.apply_with_type(lambda s: [s], list, t.name), age=t.age)
    right = t.select(key=pw.apply_with_type(lambda s: [s], list, t.name), score=t.score)
    joined = left.join(right, left.key == right.key).select(left.age, right.score)
    nd = t.select(name=t.name, r=pw.apply(lambda x: x + 1, t.age))
    nd_red = nd.groupby(nd.name).reduce(nd.name, s=pw.reducers.sum(nd.r))
    au = t.select(name=t.name, r=pw.apply_async(lambda x: x * 2, t.age))
    au_red = au.groupby(au.name).reduce(au.name, s=pw.reducers.sum(au.r))
    ts = pw.debug.table_from_rows(pw.schema_from_types(at=int, v=int), [(1, 1)])
    win = ts.windowby(ts.at, window=pw.temporal.tumbling(duration=2)).reduce(
        c=pw.reducers.count()
    )

    def step(tab):
        return tab.select(v=pw.this.v)

    it = pw.iterate(step, tab=ts.select(v=ts.v))
    wide = t.select(name=t.name, age=t.age, score=t.score)
    narrow = wide.select(name=wide.name)

    def tiny_embed(text: str) -> str:
        return text

    tiny_embed._pw_embedder = {
        "model": "tiny", "max_batch_size": 3, "max_len": 256, "dimension": 384,
    }
    emb = t.select(name=t.name, e=pw.apply_with_type(tiny_embed, str, t.name))
    stateful = t.groupby(t.name).reduce(
        t.name, m=pw.reducers.stateful_single(lambda s, v: max(s or 0, v))(t.age)
    )

    class _NullSubject(pw.io.python.ConnectorSubject):
        def run(self):
            pass

    pinned = pw.io.python.read(
        _NullSubject(), schema=pw.schema_from_types(x=int), name="pinned_src"
    )
    pinned_sel = pinned.select(x=pinned.x)
    s1 = t.select(name=t.name, v=t.age + 1)
    s2 = s1.select(name=s1.name, v=s1.v * 2)
    fan_a = s2.filter(s2.v > 0)
    fan_b = s2.filter(s2.v < 100)
    c1 = t.select(name=t.name, v=t.age * 3)
    c2 = c1.filter(c1.v > 0)
    chain_red = c2.groupby(c2.name).reduce(c2.name, s=pw.reducers.sum(c2.v))
    idx_unknown = t.select(name=t.name)
    record_op(
        idx_unknown, "external_index", (t,), index="CustomInner", dimensions=None,
        reserved_space=None, metric=None, encoder=None,
    )
    # PWT601 + PWT603 + PWT605 under dp=3,tp=5 at d = 384, where the
    # port's padded rows and the JAX package's rows are the same width
    idx_sized = t.select(name=t.name)
    record_op(
        idx_sized, "external_index", (t,), index="BruteForceKnn", dimensions=384,
        reserved_space=1_000_000, metric="cosine_similarity",
        encoder={"vocab_size": 30522, "hidden": 384, "layers": 6, "mlp_dim": 1536,
                 "max_len": 512},
    )

    @pw.udf(deterministic=True)
    def clock_liar(x: int) -> float:
        return x + time.time()

    nondet_udf = t.select(name=t.name, c=clock_liar(t.age))

    def scrambled(s: str) -> str:
        return "".join(set(s))

    unordered = t.select(name=t.name, u=pw.apply_with_type(scrambled, str, t.name))

    def audit_row(v: int) -> int:
        with open(os.devnull, "a") as fh:
            fh.write(str(v))
        return v

    audited = t.select(name=t.name, a=pw.apply_with_type(audit_row, int, t.age))
    audited_red = audited.groupby(audited.name).reduce(
        audited.name, s=pw.reducers.sum(audited.a)
    )
    lock = threading.Lock()

    def guarded_max(state, v):
        with lock:
            return max(state or 0, v)

    locked_red = t.groupby(t.name).reduce(
        t.name, m=pw.reducers.stateful_single(guarded_max)(t.age)
    )

    def mutate_row(xs) -> int:
        xs.append(0)
        return len(xs)

    mutated = left.select(n=pw.apply_with_type(mutate_row, int, left.key))
    _sink(
        pw, lossy, bad_cmp, arith, by_float, tup, joined, nd_red, au_red, win, it,
        narrow, emb, stateful, pinned_sel, fan_a, fan_b, chain_red, idx_unknown,
        idx_sized, nondet_udf, unordered, audited_red, locked_red, mutated,
    )
    # PWT110: computed after the sinks, read by nobody (kept alive by the
    # caller: the parse graph holds tables weakly)
    return t.select(doomed=t.age * 2)


def _clean(pw):
    """tests/test_analysis.py _clean_topologies: well-formed pipelines."""
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, v=int, w=float), [("a", 1, 1.0), ("b", 2, 2.0)]
    )
    other = t.select(k=t.k, label=t.k + "!")
    lists = pw.debug.table_from_rows(pw.schema_from_types(i=int, vs=list), [(1, [1, 2])])
    ts = pw.debug.table_from_rows(pw.schema_from_types(at=int, v=int), [(1, 1)])

    def step(tab):
        return tab.select(v=pw.this.v)

    tables = [
        t.select(k=t.k, doubled=t.v * 2),
        t.filter(t.v > 1).select(k=pw.this.k, v=pw.this.v),
        t.groupby(t.k).reduce(
            t.k, c=pw.reducers.count(), s=pw.reducers.sum(t.v), lo=pw.reducers.min(t.w)
        ),
        t.join(other, t.k == other.k).select(t.v, other.label),
        lists.flatten(pw.this.vs),
        pw.Table.concat_reindex(t.select(k=t.k, v=t.v), t.select(k=t.k, v=t.v + 10)),
        ts.windowby(
            ts.at, window=pw.temporal.tumbling(duration=2),
            behavior=pw.temporal.common_behavior(cutoff=10),
        ).reduce(c=pw.reducers.count()),
        pw.iterate(step, iteration_limit=3, tab=ts.select(v=ts.v)),
    ]
    _sink(pw, *tables)
    return tables


def _serving_index(pw, encoder=None):
    """tests/test_analysis.py _serving_indexed_graph."""
    record_op = _mod(pw, "internals.parse_graph").record_op
    t = pw.debug.table_from_rows(pw.schema_from_types(name=str), [("a",), ("b",)])
    idx = t.select(name=t.name)
    record_op(
        idx, "external_index", (t,), index="BruteForceKnn", dimensions=32,
        reserved_space=64, metric="cosine_similarity", encoder=encoder,
    )
    _sink(pw, idx)
    return idx


def _serving_with_encoder(pw):
    return _serving_index(
        pw, {"vocab_size": 512, "hidden": 32, "layers": 1, "mlp_dim": 64, "max_len": 32}
    )


def _marker(pw):
    spec = _mod(pw, "internals.parse_graph").MarkerSpec
    pw.G.markers.append(spec("windowby", {"has_behavior": False}, None))


def _warning(pw):
    """tests/test_analysis.py _graph_with_warning: PWT202."""
    t = pw.debug.table_from_rows(pw.schema_from_types(g=float, v=int), [(0.5, 1), (0.5, 2)])
    res = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
    _sink(pw, res)
    return res


def _no_index(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(name=str), [("a",)])
    _sink(pw, t)


# name: (build, analyze kwargs, env)
CASES = {
    "lintful_mesh": (_lintful, {"workers": 4, "mesh": "dp=3,tp=5"}, {}),
    "lintful": (_lintful, {"workers": 1}, {}),
    "clean": (_clean, {"workers": 4}, {}),
    "empty": (lambda pw: None, {}, {}),
    "serving_index_without_encoder": (_serving_index, {"workers": 1}, {}),
    "serving_index_with_encoder": (_serving_with_encoder, {"workers": 1}, {}),
    "batch_window_over_slo": (
        _serving_index, {"workers": 1, "slo": 10.0}, {"PATHWAY_SERVE_BATCH_WINDOW_MS": "50"}
    ),
    "batch_window_under_slo": (
        _serving_index, {"workers": 1, "slo": 500.0}, {"PATHWAY_SERVE_BATCH_WINDOW_MS": "50"}
    ),
    "slo_from_env": (
        _serving_index, {"workers": 1},
        {"PATHWAY_SERVE_BATCH_WINDOW_MS": "50", "PATHWAY_SLO_P99_MS": "10"},
    ),
    "serving_disarmed": (
        _serving_index, {"workers": 1, "slo": 1.0}, {"PATHWAY_SERVE_BATCH_WINDOW_MS": "0"}
    ),
    "tenant_limits": (_serving_index, {"workers": 1}, {"PATHWAY_SERVE_TENANT_RATE": "5"}),
    "cost_without_index": (_no_index, {"workers": 1}, {}),
    "marker_without_frame": (_marker, {}, {}),
    "warning": (_warning, {"workers": 1}, {}),
}


def _findings(result):
    """(code, severity, message) of each finding, with the device's own
    name (PWT802 names the attached device: the JAX package's CPU device
    in one package, torch's in the other) read as <device>."""
    out = []
    for f in result.findings:
        msg = f.message
        device = (f.details or {}).get("device")
        if device:
            msg = msg.replace(str(device), "<device>")
        out.append((f.code, str(f.severity), msg))
    return out


def _analyze(pw, build, kwargs):
    analyze = _mod(pw, "analysis").analyze
    pw.G.clear()
    try:
        keep = build(pw)
        result = analyze(pw.G, **kwargs)
        del keep
        return result
    finally:
        pw.G.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyze_gives_the_jax_packages_findings(monkeypatch, case):
    build, kwargs, env = CASES[case]
    monkeypatch.setenv("PATHWAY_ASSUME_HBM_BYTES", ASSUMED_HBM)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax_result = _analyze(jpw, build, kwargs)
    port_result = _analyze(tpw, build, kwargs)
    assert _findings(port_result) == _findings(jax_result)
    assert port_result.predictions == jax_result.predictions
    assert getattr(port_result, "capacity", None) == getattr(jax_result, "capacity", None)
    if case.startswith("lintful"):
        codes = {c for c, _, _ in _findings(port_result)}
        assert {"PWT601", "PWT603", "PWT110", "PWT202", "PWT401"} <= codes
        assert port_result.capacity["hbm_capacity_bytes"] == int(ASSUMED_HBM)


def test_tracing_off_with_tenant_limits_lints_in_both(monkeypatch):
    """PWT801: per-tenant limits with query tracing off."""
    monkeypatch.setenv("PATHWAY_SERVE_TENANT_RATE", "5")
    got = {}
    for name, pw in PACKAGES.items():
        monkeypatch.setattr(_mod(pw, "internals.qtrace"), "ENABLED", False)
        got[name] = _findings(_analyze(pw, _serving_index, {"workers": 1}))
    assert got["port"] == got["jax"]
    assert "PWT801" in {c for c, _, _ in got["port"]}


# -- the capacity plan against the port's own allocation -------------------


class _FakeEmbedder:
    """A UDF embedder of fixed width (the index takes the vector impl)."""

    def __init__(self, pw, d):
        def embed(text: str) -> np.ndarray:
            rng = np.random.default_rng(sum(map(ord, text)))
            return rng.standard_normal(d).astype(np.float32)

        self.pw, self.d = pw, d
        self.embed = embed

    def build(self):
        pw, d, embed = self.pw, self.d, self.embed

        class Embedder(pw.UDF):
            def __init__(self):
                super().__init__()
                self.func = embed
                self.max_batch_size = 64

            def get_embedding_dimension(self) -> int:
                return d

        return Embedder()


def _run_store_with_analysis(pw, d, reserved):
    """DocumentStore over a d-wide UDF embedder and BruteForceKnnFactory,
    one retrieve query, under pw.run(analysis="warn"); returns the engine's
    analysis and the live memtrack entries of the index."""
    memtrack = _mod(pw, "internals.memtrack")
    Factory = _mod(pw, "stdlib.indexing.nearest_neighbors").BruteForceKnnFactory
    DocumentStore = _mod(pw, "xpacks.llm.document_store").DocumentStore
    kw = {"device": "cpu"} if pw is tpw else {}
    pw.G.clear()
    gc.collect()
    tracker = memtrack.reset_for_tests()
    try:
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=pw.Json),
            [(f"doc {i}", pw.Json({"path": f"d{i}.txt"})) for i in range(12)],
        )
        factory = Factory(
            dimensions=d, embedder=_FakeEmbedder(pw, d).build(), reserved_space=reserved, **kw
        )
        store = DocumentStore(docs, retriever_factory=factory)
        queries = pw.debug.table_from_rows(
            store.RetrieveQuerySchema, [("doc 3", 2, None, None)]
        )
        answers = []
        pw.io.subscribe(
            store.retrieve_query(queries),
            on_change=lambda key, row, time, is_addition: answers.append(row),
        )
        pw.run(analysis="warn", monitoring_level=pw.MonitoringLevel.NONE)
        engine = _mod(pw, "internals.runner").last_engine()
        assert len(answers) == 1
        return engine.analysis, tracker.entries("knn_index")
    finally:
        pw.G.clear()


@pytest.mark.parametrize("d", [3, 6, 384])
def test_capacity_plan_matches_the_ports_live_index_bytes(d):
    """At d = 3 and 6 the port allocates rows padded to 4 and 8 float32
    columns (16-byte rows for the kernel's TMA loads, ops/knn.py), so its
    index takes 17 and 33 bytes a row where the JAX package's takes 13 and
    25. The port's capacity pass predicts its own allocation: the plan
    equals its live memtrack bytes, PWT699 stays quiet, and the JAX
    package's formula would have drifted past the 10 % tolerance. At
    d = 384 the two packages agree."""
    from pathway_tpu_torch.analysis.capacity import CAPACITY_PARITY_TOLERANCE

    reserved = 100
    plans = {}
    for name, pw in PACKAGES.items():
        analysis, live = _run_store_with_analysis(pw, d, reserved)
        codes = {f["code"] for f in analysis["findings"]}
        assert "PWT601" in codes and "PWT699" not in codes, (name, codes)
        (row,) = analysis["capacity"]["indexes"]
        # the comparison ran: one live index for the one predicted
        assert len(live) == 1, (name, live)
        assert row["index_bytes"] == live[0]["nbytes"], name
        plans[name] = row
    rows = plans["port"]["predicted_rows"]
    assert rows == plans["jax"]["predicted_rows"] == 128
    port_row_bytes = 4 * (-(-d // 4) * 4) + 1
    assert plans["port"]["index_bytes"] == rows * port_row_bytes
    assert plans["jax"]["index_bytes"] == rows * (4 * d + 1)
    drift = abs(plans["jax"]["index_bytes"] - plans["port"]["index_bytes"])
    if d % 4:
        assert drift / plans["port"]["index_bytes"] > CAPACITY_PARITY_TOLERANCE
    else:
        assert drift == 0


def test_predict_index_bytes_is_the_ports_allocation():
    from pathway_tpu_torch.analysis.capacity import predict_index_bytes
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    for d in (2, 3, 6, 32, 384):
        for reserved in (1, 8, 100, 512, 5000):
            knn = DeviceKnnIndex(d, reserved_space=reserved, device="cpu")
            pred = predict_index_bytes(d, reserved)
            assert pred["rows"] == knn.capacity
            assert pred["bytes"] == knn.capacity * (4 * knn._d_pad + 1)


# -- pw.run(analysis=...) --------------------------------------------------


def _run(pw, build, analysis):
    pw.G.clear()
    # no index of an earlier test alive in memtrack: verify_capacity
    # compares the plan with this run's live entries only
    gc.collect()
    _mod(pw, "internals.memtrack").reset_for_tests()
    try:
        build(pw)
        pw.run(analysis=analysis, monitoring_level=pw.MonitoringLevel.NONE)
        return _mod(pw, "internals.runner").last_engine().analysis
    finally:
        pw.G.clear()


def _clean_rows(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(k=str, v=int), [("a", 1)])
    pw.io.subscribe(t.select(k=t.k, v=t.v * 2), on_change=lambda *a, **k: None)


@pytest.mark.parametrize("build", [_warning, _lintful, _clean_rows, _clean], ids=lambda b: b.__name__)
def test_run_strict_raises_where_the_jax_package_does(build):
    outcome = {}
    for name, pw in PACKAGES.items():
        AnalysisError = _mod(pw, "analysis").AnalysisError
        try:
            _run(pw, build, "strict")
            outcome[name] = None
        except AnalysisError as exc:
            outcome[name] = sorted({f.code for f in exc.result.findings})
    assert outcome["port"] == outcome["jax"]
    if build is _warning:
        assert outcome["port"] == ["PWT202"]
    if build is _clean_rows:
        assert outcome["port"] is None


def test_run_warn_attaches_the_jax_packages_codes():
    got = {name: _run(pw, _warning, "warn") for name, pw in PACKAGES.items()}
    codes = {n: [f["code"] for f in a["findings"]] for n, a in got.items()}
    assert codes["port"] == codes["jax"] and "PWT202" in codes["port"]


def test_run_analysis_off_and_invalid():
    assert _run(tpw, _warning, "off") is None
    with pytest.raises(ValueError):
        _run(tpw, _warning, "nonsense")


def test_status_endpoint_carries_the_analysis():
    from pathway_tpu_torch.internals.monitoring import PrometheusServer
    from pathway_tpu_torch.internals.runner import last_engine

    analysis = _run(tpw, _warning, "warn")
    status = PrometheusServer(last_engine()).status_json()
    assert status["analysis"] == analysis
    assert "PWT202" in [f["code"] for f in status["analysis"]["findings"]]


def test_mesh_still_raises_before_the_analyzer():
    tpw.G.clear()
    _clean_rows(tpw)
    try:
        with pytest.raises(NotImplementedError, match="mesh"):
            tpw.run(mesh="dp=2", analysis="warn", monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        tpw.G.clear()
