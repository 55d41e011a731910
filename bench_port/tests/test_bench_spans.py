"""The eight readers of the program's own spans against values worked by
hand: synthetic host spans, query marks and kernel intervals, and None
where the spans are missing (a program older than its host-span ring)."""

from __future__ import annotations

import pytest

from bench_port.harness import spans
from bench_port.harness.spec import metric_reader

T = "dispatcher"  # a thread name


class FakeTrace:
    """A traced window: kernels on a clock 1,000 us ahead of perf_counter's."""

    offset_us = 1000.0

    def __init__(self, t_open: float, t_close: float, kernels):
        self.lo, self.hi = self.to_us(t_open), self.to_us(t_close)
        self.kernels = [(self.to_us(a), self.to_us(b), "k") for a, b in kernels]

    def to_us(self, t: float) -> float:
        return t * 1e6 + self.offset_us


def host(monkeypatch, records, queries=None):
    """Serve `records` ((name, start, end, rows, thread)) as the ring's,
    clipped to the interval asked for, and `queries` as qtrace's."""
    def ring(t0, t1):
        return [r for r in records if r[2] >= t0 and r[1] <= t1]

    monkeypatch.setattr(spans, "host_spans", ring)
    monkeypatch.setattr(spans, "query_spans", lambda t0, t1: queries)


def ingest_ctx(kernels=()):
    return {"trace": FakeTrace(10.0, 20.0, kernels), "docs": 4000}


def test_window_from_the_trace_or_the_context():
    assert spans.window(ingest_ctx()) == pytest.approx((10.0, 20.0))
    assert spans.window({"t_open": 1.0, "t_close": 2.0}) == (1.0, 2.0)
    assert spans.window({}) is None


def test_ingest_span_ms_per_kdoc(monkeypatch):
    host(monkeypatch, [
        ("index.write", 9.9, 10.1, 64, T),   # 0.1 s inside the window
        ("index.write", 12.0, 12.3, 64, T),  # 0.3 s
        ("encode.h2d", 11.0, 11.5, 64, T),   # 0.5 s
        ("encode.h2d", 19.8, 20.4, 64, T),   # 0.2 s inside
        ("pipeline:prep", 10.0, 20.0, 64, "prep"),
    ])
    # 0.4 s over 4,000 chunks: 100 ms per 1,000; 0.7 s: 175
    assert metric_reader("ingest.index_write_ms_per_kdoc")(ingest_ctx()) == pytest.approx(100.0)
    assert metric_reader("ingest.h2d_ms_per_kdoc")(ingest_ctx()) == pytest.approx(175.0)


def test_dispatch_idle_share(monkeypatch):
    # busy [10, 12] and [14, 20]: idle [12, 14]; dispatch spans over [11, 13]
    # and [13.5, 15]: 1.0 + 0.5 s of the 2 s idle lie under a dispatch
    host(monkeypatch, [("pipeline:dispatch", 11.0, 13.0, 8, T),
                       ("pipeline:dispatch", 13.5, 15.0, 8, T),
                       ("index.write", 12.0, 13.9, 8, T)])
    ctx = ingest_ctx([(10.0, 12.0), (14.0, 20.0)])
    assert metric_reader("ingest.dispatch_idle_share")(ctx) == pytest.approx(1.5 / 10.0)


def generate_call(t0: float, thread: str = "engine", steps: int = 3) -> list:
    """One llm.generate of 4 s from t0: tokenize 0.1, prefill 0.5 s of
    host, the card's first token at t0 + 1.1, decode steps of 0.2 s,
    readback to t0 + 3.5, detokenize."""
    recs = [("llm.generate", t0, t0 + 4.0, 16, thread),
            ("llm.tokenize", t0, t0 + 0.1, 16, thread),
            ("decoder.prefill", t0 + 0.1, t0 + 0.6, 16, thread),
            ("decoder.first_token", t0 + 0.1, t0 + 1.1, 16, thread)]
    recs += [("decoder.decode", t0 + 0.6 + 0.2 * i, t0 + 0.8 + 0.2 * i, 16, thread)
             for i in range(steps)]
    recs += [("decoder.readback", t0 + 1.2, t0 + 3.5, 16, thread),
             ("llm.detokenize", t0 + 3.5, t0 + 3.9, 16, thread)]
    return recs


def query(ingress: float, udf: tuple, route: str = "/v2/answer") -> dict:
    return {"route": route, "marks": {
        "ingress": ingress, "search_start": ingress + 0.05, "device_end": ingress + 0.08,
        "udf_start": udf[0], "udf_end": udf[1], "respond": udf[1] + 0.01}}


def rag_ctx(kernels=()):
    return {"t_open": 100.0, "t_close": 110.0, "trace": FakeTrace(100.0, 110.0, kernels)}


def test_rag_decoder_spans(monkeypatch):
    # two calls wholly in the window (one with a fourth step), one past it
    records = generate_call(101.0) + generate_call(105.0, steps=4) + generate_call(108.0)
    host(monkeypatch, records)
    ctx = rag_ctx()
    assert metric_reader("rag.prefill_ms")(ctx) == pytest.approx(1000.0)
    assert metric_reader("rag.decode_host_ms_per_step")(ctx) == pytest.approx(200.0)


def test_rag_decode_idle_share(monkeypatch):
    host(monkeypatch, generate_call(101.0) + generate_call(105.0))
    # decode intervals [102.1, 104.5] and [106.1, 108.5]: 2.4 s each; the
    # card busy [102.1, 103.3] and [106.1, 108.5] - 0.6 s of gaps
    kernels = [(102.1, 103.3), (106.1, 107.0), (107.6, 108.5), (100.0, 101.5)]
    got = metric_reader("rag.decode_idle_share")(rag_ctx(kernels))
    assert got == pytest.approx((1.2 + 0.6) / 4.8)


def test_rag_ttft_and_retrieval(monkeypatch):
    records = generate_call(101.0) + generate_call(105.0, thread="engine")
    queries = [query(100.5, (101.0, 105.0)),   # first token at 102.1: 1.6 s
               query(104.0, (104.9, 109.1)),   # the second call's: 106.1 - 104.0
               query(99.0, (101.0, 105.0)),    # sent before the window
               query(100.6, (101.0, 105.0), route="/v1/retrieve"),
               # sent in the window, searched and answered after its close
               query(109.5, (111.0, 115.0))]
    queries[3]["marks"].pop("udf_start")
    queries[4]["marks"].update(search_start=109.95, device_end=110.5)
    host(monkeypatch, records + generate_call(111.0), queries)
    assert metric_reader("rag.ttft_ms")(rag_ctx()) == pytest.approx(1e3 * (1.6 + 2.1) / 2)
    assert metric_reader("rag.retrieve_ms")(rag_ctx()) == pytest.approx(30.0)


@pytest.mark.parametrize("name", [
    "ingest.index_write_ms_per_kdoc", "ingest.h2d_ms_per_kdoc", "ingest.dispatch_idle_share",
    "rag.ttft_ms", "rag.retrieve_ms", "rag.prefill_ms", "rag.decode_host_ms_per_step",
    "rag.decode_idle_share",
])
def test_none_without_the_programs_spans(monkeypatch, name):
    ctx = rag_ctx([(100.0, 101.0)]) if name.startswith("rag.") else ingest_ctx([(10.0, 11.0)])
    monkeypatch.setattr(spans, "host_spans", lambda t0, t1: None)
    monkeypatch.setattr(spans, "query_spans", lambda t0, t1: None)
    assert metric_reader(name)(ctx) is None
    host(monkeypatch, [], [])  # a ring without the spans this metric reads
    assert metric_reader(name)(ctx) is None


def test_a_program_without_the_ring_reads_as_none(monkeypatch):
    """An older program: its tracing module has no ring, its query tracer
    no finished spans; the readers return None and raise nothing."""
    from pathway_tpu_torch.internals import qtrace, tracing

    monkeypatch.delattr(tracing, "host_spans")
    monkeypatch.delattr(qtrace.QueryTracer, "finished_between")
    assert spans.host_spans(0.0, 1.0) is None
    assert spans.query_spans(0.0, 1.0) is None
    for name in ("ingest.h2d_ms_per_kdoc", "rag.prefill_ms"):
        ctx = rag_ctx() if name.startswith("rag.") else ingest_ctx()
        assert metric_reader(name)(ctx) is None
