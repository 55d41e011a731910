"""The port's host spans on one clock, on the CPU.

The process-wide host-span ring (internals/tracing.py) and what records
into it: the device pipeline's stages, the chat model's generate call
and the decoder's prefill / decode / readback / first token, ingest's
copies and index writes. The query spans (internals/qtrace.py) on the
same perf_counter clock, with the batched UDF's marks on /v2/answer.
The profiler's Chrome trace with every thread's host spans laid on it,
the epoch trace's pipeline rows, and the webserver's single start.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import qtrace, runner, tracing
from pathway_tpu_torch.internals.device_pipeline import DevicePipeline
from pathway_tpu_torch.internals.tracing import SpanRing
from pathway_tpu_torch.models import transformer as port_tf
from pathway_tpu_torch.models.decoder_lm import ChatModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = [f"doc {i} about stream tables, vector indexes and latency {i * 7}" for i in range(24)]
ENCODER = port_tf.TransformerConfig(
    vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64, dtype="float32",
)


def _since(t0: float) -> list:
    return tracing.spans_between(t0, time.perf_counter())


# -- the ring ----------------------------------------------------------------------


def test_ring_is_bounded_and_safe_to_write_from_several_threads():
    ring = SpanRing(capacity=500)
    stop = threading.Event()
    read_errors = []

    def write(w):
        for i in range(2000):
            t = time.perf_counter()
            ring.record(f"w{w}", t, 1e-6, i)

    def read():
        while not stop.is_set():
            try:
                ring.spans_between(0.0, time.perf_counter())
                ring.owned_by(None)
            except Exception as exc:  # noqa: BLE001 - collected for the assert
                read_errors.append(exc)

    reader = threading.Thread(target=read)
    reader.start()
    writers = [threading.Thread(target=write, args=(w,), name=f"writer-{w}") for w in range(8)]
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    reader.join()
    assert not read_errors
    assert ring.recorded == 16000
    recs = ring.spans_between(0.0, time.perf_counter())
    assert len(recs) == 500
    # each record: name, start, duration, rows, the writer's thread, owner
    assert all(r[4] == f"writer-{r[0][1:]}" and r[5] is None for r in recs)
    assert not ring.holds_since(0.0)
    assert ring.holds_since(time.perf_counter() + 10.0)


def test_spans_between_does_not_consume_and_reads_overlap():
    ring = SpanRing()
    ring.record("a", 10.0, 1.0)  # [10, 11]
    ring.record("b", 11.5, 1.0)  # [11.5, 12.5]
    ring.record("c", 9.0, 5.0)  # [9, 14]
    ring.record("d", 20.0, 1.0)
    first = ring.spans_between(10.5, 12.0)
    assert [r[0] for r in first] == ["a", "b", "c"]
    assert ring.spans_between(10.5, 12.0) == first  # read again: still there
    assert [r[0] for r in ring.spans_between(12.6, 13.0)] == ["c"]
    assert ring.spans_between(15.0, 19.0) == []
    assert ring.holds_since(0.0)


def test_a_span_appended_long_after_its_end_hides_no_older_span():
    """The decoder's first token is appended after the decode steps that
    follow it: a reader still finds the spans appended before it."""
    ring = SpanRing()
    now = time.perf_counter()
    ring.record("decoder.decode", now - 0.5, 0.4)
    ring.record("decoder.first_token", now - 30.0, 2.0)
    assert [r[0] for r in ring.spans_between(now - 1.0, now)] == ["decoder.decode"]
    assert [r[0] for r in ring.spans_between(now - 29.0, now)] == [
        "decoder.decode", "decoder.first_token"]


def test_trace_off_records_nothing(monkeypatch):
    out = subprocess.run(
        [sys.executable, "-c",
         "from pathway_tpu_torch.internals import tracing; print(tracing.HOST_SPANS)"],
        env=dict(os.environ, PATHWAY_TRACE="0"), capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert out.stdout.strip() == "False", out.stderr
    monkeypatch.setattr(tracing, "HOST_SPANS", False)
    n = tracing.host_spans().recorded
    ChatModel("tiny-decoder", device="cpu").generate(["off"], max_new_tokens=3)
    pipe = DevicePipeline(lambda item: (item, {"rows": 1}), lambda payload: None, name="off-test")
    try:
        pipe.submit(1)
        pipe.drain()
    finally:
        pipe.close()
    assert tracing.host_spans().recorded == n
    assert pipe._spans == []


def test_pipeline_spans_view_holds_its_own_records():
    """DevicePipeline._spans: this pipeline's (name, start, duration,
    rows) records in the ring, read under _cond without taking them."""
    pipes = [
        DevicePipeline(lambda item: (item, {"rows": item}), lambda payload: None, name=f"view-{i}")
        for i in range(2)
    ]
    try:
        for i, pipe in enumerate(pipes):
            pipe.submit(3 + i)
            pipe.submit(5 + i)
            pipe.drain()
        for i, pipe in enumerate(pipes):
            with pipe._cond:
                spans = list(pipe._spans)
            assert spans == list(pipe._spans)
            assert all(len(s) == 4 for s in spans)
            names = [s[0] for s in spans]
            assert names.count("pipeline:prep") == 2 and names.count("pipeline:dispatch") == 2
            assert "pipeline:drain" in names
            assert sorted(s[3] for s in spans if s[0] == "pipeline:prep") == [3 + i, 5 + i]
    finally:
        for pipe in pipes:
            pipe.close()


# -- the decoder ----------------------------------------------------------------------


def test_chat_model_generate_records_its_spans_in_order():
    model = ChatModel("tiny-decoder", device="cpu")
    new = 5
    t0 = time.perf_counter()
    model.generate(["a stream of tables", "vector index"], max_new_tokens=new)
    spans = [r for r in _since(t0) if r[4] == threading.current_thread().name]
    (gen,) = [r for r in spans if r[0] == "llm.generate"]
    assert gen[3] == 2
    inside = sorted((r for r in spans if r is not gen), key=lambda r: r[1])
    assert all(gen[1] <= r[1] and r[1] + r[2] <= gen[1] + gen[2] for r in inside)
    steps = [r[0] for r in inside if r[0] != "decoder.first_token"]
    assert steps == (["llm.tokenize", "decoder.prefill"] + ["decoder.decode"] * (new - 1)
                     + ["decoder.readback", "llm.detokenize"])
    (prefill,) = [r for r in inside if r[0] == "decoder.prefill"]
    (first,) = [r for r in inside if r[0] == "decoder.first_token"]
    # on the CPU the first token is ready when the host's prefill ends
    assert first[1] == prefill[1] and first[2] == pytest.approx(prefill[2])
    assert all(r[3] == 2 for r in inside if r[0].startswith("decoder."))


# -- query spans ------------------------------------------------------------------------


def test_qtrace_marks_are_perf_counter_and_export_wall_time():
    tq = qtrace.QueryTracer()
    before = time.perf_counter()
    assert tq.begin("q1", route="/v1/retrieve", key="k1")
    tq.mark_keys(["k1"], "search_start")
    tq.mark_keys(["k1"], "device_end")
    wall_0 = time.time()
    rec = tq.finish("q1")
    wall_1, perf_now = time.time(), time.perf_counter()
    marks = rec["marks"]
    assert before <= marks["ingress"] <= marks["search_start"] <= marks["respond"] <= perf_now
    # exported, a mark agrees with the wall clock read around it to 5 ms
    assert wall_0 - 0.005 <= tq.to_wall(marks["respond"]) <= wall_1 + 0.005
    # the TCP wire carries wall time, and the receiving side takes it back
    tq.attach_worker(1)
    tq.begin("q2", key="k2")
    wall_0 = time.time()
    tq.mark("q2", "enqueued")
    wall_1 = time.time()
    shipped = tq._remote_out[-1]["marks"]
    assert wall_0 - 0.005 <= shipped["enqueued"] <= wall_1 + 0.005
    assert tq.finished_between(before, time.perf_counter()) == [rec]
    assert tq.finished_between(perf_now + 1.0, perf_now + 2.0) == []


def test_udf_marks_split_the_merge_stage():
    tq = qtrace.QueryTracer()
    tq.begin("q", key="k")
    for name in ("enqueued", "picked", "search_start", "device_end"):
        tq.mark_keys(["k"], name)
    tq.mark_keys(["k"], "udf_start", latest=True)
    first_end = time.perf_counter()
    tq.mark_keys(["k"], "udf_end", latest=True)
    tq.mark_keys(["k"], "udf_end", latest=True)
    tq.mark("q", "emitted")
    rec = tq.finish("q")
    assert rec["marks"]["udf_end"] > first_end
    assert list(rec["stages_ms"]) == ["network", "queue", "batch", "device", "merge", "udf",
                                      "post_udf", "emit"]
    assert [s for s, _a, _b in qtrace.stage_intervals(rec)] == [
        s for s in rec["stages_ms"] if rec["stages_ms"][s] > 0
    ]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, route: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A QASummaryRestServer over a DocumentStore and the tiny decoder on
    the CPU: two /v2/answer and one /v1/retrieve request, and the finished
    query spans and host spans of their interval."""
    from pathway_tpu_torch.internals import serving
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    docs_dir = tmp_path_factory.mktemp("docs")
    with open(docs_dir / "docs.jsonl", "w") as f:
        for i, text in enumerate(DOCS):
            f.write(json.dumps({"data": text, "_metadata": {"path": f"d{i}.txt"}}) + "\n")
    pw.G.clear()
    docs = pw.io.jsonlines.read(
        str(docs_dir), schema=pw.schema_from_types(data=str, _metadata=pw.Json), mode="static"
    )
    embedder = SentenceTransformerEmbedder("tracing-test", config=ENCODER, max_len=64, device="cpu")
    factory = pw.indexing.BruteForceKnnFactory(embedder=embedder, reserved_space=64)
    store = pw.xpacks.llm.document_store.DocumentStore(docs, retriever_factory=factory)
    chat = HFPipelineChat(generator=ChatModel("tiny-decoder", device="cpu"), max_new_tokens=4)
    rag = BaseRAGQuestionAnswerer(chat, store, search_topk=3)
    port = _free_port()
    rag.build_server("127.0.0.1", port)
    try:
        rag.run_server(threaded=True)
        deadline = time.time() + 120
        while True:
            try:
                if _post(port, "/v1/statistics", {}).get("file_count") == len(DOCS):
                    break
            except OSError:
                pass
            assert time.time() < deadline, "the QA server did not come up"
            time.sleep(0.1)
        t0 = time.perf_counter()
        answers = [_post(port, "/v2/answer", {"prompt": DOCS[i], "return_context_docs": True})
                   for i in (3, 11)]
        retrieved = _post(port, "/v1/retrieve", {"query": DOCS[5], "k": 2})
        t1 = time.perf_counter()
    finally:
        eng = runner.last_engine()
        if eng is not None:
            eng.terminate_flag.set()
        pw.G.clear()
        serving.reset_for_tests()
    spans = qtrace.tracker().finished_between(t0, t1)
    return {"answers": answers, "retrieved": retrieved, "t0": t0, "t1": t1,
            "queries": [s for s in spans if s["marks"]["ingress"] >= t0],
            "host": tracing.spans_between(t0, t1)}


def test_answer_spans_hold_their_generate_call(served):
    assert all(a["context_docs"] for a in served["answers"])
    answers = [s for s in served["queries"] if s["route"] == "/v2/answer"]
    assert len(answers) == 2
    generates = [r for r in served["host"] if r[0] == "llm.generate"]
    firsts = [r for r in served["host"] if r[0] == "decoder.first_token"]
    for span in answers:
        m = span["marks"]
        assert (m["ingress"] <= m["search_start"] <= m["device_end"] <= m["udf_start"]
                <= m["udf_end"] <= m["respond"])
        inside = [g for g in generates
                  if m["udf_start"] <= g[1] and g[1] + g[2] <= m["udf_end"]]
        assert len(inside) == 1 and inside[0][3] == 1
        g = inside[0]
        assert any(g[1] <= f[1] and f[1] + f[2] <= g[1] + g[2] for f in firsts)
        assert {"merge", "udf", "post_udf"} <= set(span["stages_ms"])
        assert span["stages_ms"]["udf"] >= g[2] * 1e3


def test_retrieve_stage_breakdown_is_unchanged(served):
    assert served["retrieved"][0]["text"] == DOCS[5]
    (span,) = [s for s in served["queries"] if s["route"] == "/v1/retrieve"]
    assert "udf_start" not in span["marks"] and "udf_end" not in span["marks"]
    assert list(span["stages_ms"]) == ["network", "queue", "batch", "device", "merge", "emit"]
    m = span["marks"]
    assert span["stages_ms"]["merge"] == pytest.approx((m["emitted"] - m["device_end"]) * 1e3)


def test_a_dispatch_records_its_copies_then_its_index_write():
    """FusedEmbedSearch.dispatch_batch, packed and classic: the slab's
    host-to-card copies (encode.h2d), then the index write (index.write),
    each with the slab's keys as rows."""
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    encoder = SentenceTransformerEmbedder("tracing-test", config=ENCODER, max_len=64,
                                          device="cpu").encoder
    index = DeviceKnnIndex(ENCODER.hidden, reserved_space=64, device="cpu")
    fused = FusedEmbedSearch(encoder, index, device="cpu")
    t0 = time.perf_counter()
    for pack in (True, False):
        keys = [f"{pack}-{i}" for i in range(len(DOCS))]
        payload, _meta = fused.prepare_batch(keys, DOCS, pack=pack)
        fused.dispatch_batch(payload)
    spans = [r for r in _since(t0) if r[4] == threading.current_thread().name]
    assert [r[0] for r in spans] == ["encode.h2d", "index.write"] * 2
    assert all(r[3] == len(DOCS) for r in spans)
    assert all(a[1] + a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    assert len(index) == 2 * len(DOCS)


# -- the profiler's trace and the epoch trace ---------------------------------------------


def test_profile_capture_places_another_threads_span_by_its_twin(tmp_path):
    from pathway_tpu_torch.internals import profiler
    from torch.profiler import record_function

    twins = []

    def workload():
        if len(twins) == 5:
            time.sleep(0.01)
            return
        # a record_function and, on another thread, a host span over the
        # interval read around it; five of them, so that a scheduling
        # delay between a clock read and its twin's cannot hide the
        # clocks' alignment
        t0 = time.perf_counter()
        with record_function(f"twin{len(twins)}"):
            time.sleep(0.02)
        t1 = time.perf_counter()
        th = threading.Thread(target=tracing.record_span,
                              args=(f"twin{len(twins)}.span", t0, t1 - t0, 7), name="span-writer")
        th.start()
        th.join()
        twins.append(f"twin{len(twins)}")

    res = profiler.capture(0.4, str(tmp_path), workload=workload)
    assert "error" not in res, res
    assert res["host_spans"] >= 5 and len(twins) == 5
    with open(res["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    rows = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    gaps = []
    for name in twins:
        (twin,) = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
        (span,) = [e for e in events if e.get("name") == f"{name}.span"]
        assert rows[(span["pid"], span["tid"])] == "span-writer"
        assert procs[span["pid"]] == "host spans" and span["args"]["rows"] == 7
        # the span holds its twin, the clock reads around it
        mid = lambda e: float(e["ts"]) + float(e["dur"]) / 2  # noqa: E731
        gaps.append(abs(mid(span) - mid(twin)))
    assert min(gaps) < 1000.0, gaps


def test_nesting_lanes_keep_complete_events_nested():
    from pathway_tpu_torch.internals.profiler import _lanes

    # a call, two steps inside it, and a span that outlives the first step
    spans = [(0.0, 10.0), (1.0, 3.0), (2.0, 5.0), (4.0, 6.0)]
    assert _lanes(spans, nest=True) == [0, 0, 1, 0]
    assert _lanes([(0.0, 2.0), (1.0, 3.0), (2.0, 4.0)], nest=False) == [0, 1, 0]


def test_dump_trace_shows_the_pipeline_rows(tmp_path, monkeypatch):
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    monkeypatch.setenv("PATHWAY_TRACE", "1")
    with open(tmp_path / "docs.jsonl", "w") as f:
        for i, text in enumerate(DOCS):
            f.write(json.dumps({"data": text, "_metadata": {"path": f"d{i}.txt"}}) + "\n")
    pw.G.clear()
    try:
        docs = pw.io.jsonlines.read(
            str(tmp_path), schema=pw.schema_from_types(data=str, _metadata=pw.Json), mode="static"
        )
        embedder = SentenceTransformerEmbedder("tracing-test", config=ENCODER, max_len=64,
                                               device="cpu")
        factory = pw.indexing.BruteForceKnnFactory(embedder=embedder, reserved_space=64)
        store = pw.xpacks.llm.document_store.DocumentStore(docs, retriever_factory=factory)
        queries = pw.debug.table_from_rows(
            store.RetrieveQuerySchema, [(DOCS[2], 2, None, None)]
        )
        got = []
        pw.io.subscribe(store.retrieve_query(queries),
                        on_change=lambda key, row, time, is_addition: got.append(row))
        pw.run()
        trace = runner.last_engine().dump_trace()
    finally:
        pw.G.clear()
    assert got
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"pipeline:prep", "pipeline:dispatch"} <= names
    rows = [e for e in trace["traceEvents"] if e.get("name") == "pipeline:dispatch"]
    assert all(e["args"]["node"] == -1 for e in rows)


# -- the webserver -----------------------------------------------------------------------


def test_webserver_waits_for_a_server_thread_still_starting(monkeypatch):
    """A server thread held 11 s, past the 10 s wait: the next route
    waits again and starts no second server on the port."""
    from pathway_tpu_torch.io.http._server import PathwayWebserver

    server = PathwayWebserver("127.0.0.1", _free_port())
    serve = server._serve
    starts, errors = [], []

    async def slow_serve():
        import asyncio

        starts.append(threading.current_thread().name)
        await asyncio.sleep(11.0)
        try:
            await serve()
        except Exception as exc:  # noqa: BLE001 - collected for the assert
            errors.append(exc)
            raise

    monkeypatch.setattr(server, "_serve", slow_serve)

    async def echo(payload, request):
        return {"echo": payload.get("x")}

    server.register_route("/a", ["POST"], echo)
    t0 = time.monotonic()
    server._ensure_started()  # waits its 10 s; the thread still starts
    server.register_route("/b", ["POST"], echo)
    server._ensure_started()  # a second route: waits, starts nothing
    assert time.monotonic() - t0 >= 10.5
    deadline = time.monotonic() + 30
    while not server._started.is_set():
        assert time.monotonic() < deadline, "the server never listened"
        time.sleep(0.05)
    assert starts == [f"webserver:{server.port}"] and not errors
    assert _post(server.port, "/b", {"x": 5}) == {"echo": 5}
    server._loop.call_soon_threadsafe(server._loop.stop)
