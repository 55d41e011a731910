"""rag.decode_graph_share against values worked by hand: synthetic host
spans of generate calls whose decode steps replay a graph or do not, and
None from a program that never captures one."""

from __future__ import annotations

import pytest

from bench_port.harness import spans
from bench_port.harness.spec import metric_reader


def call(t0: float, replays: int, steps: int = 4, thread: str = "engine") -> list:
    """One llm.generate of 4 s from t0 with `steps` decode steps of 0.2 s,
    the first `replays` of them holding a graph replay."""
    recs = [("llm.generate", t0, t0 + 4.0, 16, thread),
            ("decoder.first_token", t0 + 0.1, t0 + 1.1, 16, thread),
            ("decoder.readback", t0 + 1.5, t0 + 3.5, 16, thread)]
    for i in range(steps):
        a = t0 + 0.6 + 0.2 * i
        recs.append(("decoder.decode", a, a + 0.2, 16, thread))
        if i < replays:
            recs.append(("decoder.graph_replay", a + 0.05, a + 0.06, 16, thread))
    return recs


def serve(monkeypatch, records):
    monkeypatch.setattr(spans, "host_spans",
                        lambda t0, t1: [r for r in records if r[2] >= t0 and r[1] <= t1])


CTX = {"t_open": 100.0, "t_close": 110.0}
CAPTURE = [("decoder.graph_capture", 50.0, 50.3, 16, "engine")]  # at set-up


def test_share_of_decode_steps_that_replay(monkeypatch):
    # 4 + 3 of 8 steps in the window's calls; the call past the close is out,
    # and a replay on another thread does not count for a step
    other = [("decoder.graph_replay", 105.7, 105.71, 16, "other")]
    serve(monkeypatch, CAPTURE + call(101.0, 4) + call(105.0, 3) + call(109.2, 0) + other)
    assert metric_reader("rag.decode_graph_share")(CTX) == pytest.approx(7 / 8)


def test_none_from_a_program_without_graphs(monkeypatch):
    serve(monkeypatch, call(101.0, 0) + call(105.0, 0))
    assert metric_reader("rag.decode_graph_share")(CTX) is None
    serve(monkeypatch, CAPTURE)  # no generate call in the window
    assert metric_reader("rag.decode_graph_share")(CTX) is None
    monkeypatch.setattr(spans, "host_spans", lambda t0, t1: None)  # no ring
    assert metric_reader("rag.decode_graph_share")(CTX) is None
