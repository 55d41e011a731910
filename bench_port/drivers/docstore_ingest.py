"""DocumentStore ingest of a backlog that never empties.

The path: a watched directory read by `pw.io.jsonlines.read` (streaming,
one engine batch a file) -> `DocumentStore` -> the fused index of
`BruteForceKnnFactory(SentenceTransformerEmbedder)`, with one retrieval
route so the index is built. A writer process keeps a fixed number of
files ahead of what the index holds. The window opens once the index
has taken the warm-up files and a steady stretch after them; the rate is
the index's row count at the window's edges over the window's seconds.

After the window the writer stops, the backlog drains, and sample
queries go through the store's retrieval route. Then the engine stops
and the reference judges, on a sample of the window's chunks drawn from
the seed, the vectors the index holds, and each query's answer against
the index's own rows.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from bench_port.harness import port, weights
from bench_port.harness.core import BenchFailure, err
from bench_port.harness.feed import Feed
from bench_port.harness.textgen import TextGen, chunk_id, subseed
from bench_port.reference import encoder as ref_encoder
from bench_port.reference import search as ref_search


def _counters(impl) -> dict:
    pipe = getattr(impl, "_pipeline", None)
    stats = pipe.stats() if pipe is not None else {}
    return {"rows": len(impl.knn), "real_tokens": stats.get("real_tokens", 0),
            "slab_tokens": stats.get("slab_tokens", 0), "health_actions": port.health_actions()}


def _pipeline_spans(impl) -> list:
    """The DevicePipeline's recent stage spans (prep, dispatch, wait,
    drain) as (name, start, end) on perf_counter, read without taking
    them."""
    pipe = getattr(impl, "_pipeline", None)
    if pipe is None:
        return []
    with pipe._cond:
        spans = list(pipe._spans)
    return [(name, t0, t0 + dur) for name, t0, dur, _rows in spans]


def run(job) -> dict:
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import utilization

    cfg, traffic, run = job.config, job.traffic, job.run
    per_file = int(traffic["chunks_per_file"])
    backlog = int(traffic["backlog_files"])
    feed = Feed(run, job.root, job.seed, traffic, job.workdir)
    feed.want(backlog)
    pw.G.clear()
    store = port.document_store(port.jsonlines_docs(feed.watch, traffic["poll_s"]), cfg,
                                job.seed, job.device)
    queries = port.QuerySubject()
    answers: list = []
    table = pw.io.python.read(queries.subject, schema=store.RetrieveQuerySchema)

    def on_answer(key, row, time, is_addition):  # noqa: A002 - the callback's names
        if is_addition:
            answers.append(row["result"])

    pw.io.subscribe(store.retrieve_query(table), on_change=on_answer)
    engine_thread = run.thread("engine", lambda: pw.run(
        autocommit_duration_ms=traffic["autocommit_ms"], monitoring_level=pw.MonitoringLevel.NONE))
    engine = port.running_engine(run, job.deadline("setup"))
    (impl,) = port.index_impls(engine)
    low_water = [math.inf]
    in_window = [False]
    feeding = threading.Event()
    feeding.set()

    samples: list = []  # (time, rows) each second: the rate's course, for the log

    def keep_ahead():
        while feeding.is_set() and not run.stop.is_set():
            rows = len(impl.knn)
            feed.want(rows // per_file + backlog)
            if in_window[0]:
                low_water[0] = min(low_water[0], feed.chunks_written() - rows)
            now = time.perf_counter()
            if not samples or now - samples[-1][0] >= 1.0:
                samples.append((now, rows))
            time.sleep(0.01)

    feeder = run.thread("feed-control", keep_ahead)
    warm = int(traffic["warmup_files"]) * per_file
    run.wait_until(lambda: len(impl.knn) >= warm, job.deadline("setup"), "the warm-up files")
    time.sleep(float(traffic["settle_s"]))
    run.check()

    trace = job.trace_window()
    seconds = float(traffic["trace_s"]) if trace else float(job.seconds)
    if trace:
        utilization.reset_window()
    before = _counters(impl)
    in_window[0] = True
    if trace:
        trace.open()
    t_open = time.perf_counter()
    run.wait_until(lambda: time.perf_counter() - t_open >= seconds, t_open + seconds + 5.0, "the window")
    if trace:
        trace.close()
    t_close = trace.t_close if trace else time.perf_counter()
    job.t_close = t_close
    host = _pipeline_spans(impl) if trace else []
    after = _counters(impl)
    util = utilization.tracker().snapshot() if trace else None
    in_window[0] = False
    window_s = t_close - t_open
    setup_s = t_open - job.t_start
    if low_water[0] < per_file:
        raise BenchFailure(f"the backlog emptied in the window: {low_water[0]} chunks ahead "
                           f"of the index at its lowest")
    n0, n1 = before["rows"], after["rows"]
    course = [round((b[1] - a[1]) / (b[0] - a[0])) for a, b in zip(samples, samples[1:])
              if t_open <= a[0] and b[0] <= t_close]
    err(f"bench_port: docs/s second by second in the window: {course}; health actions "
        f"{port.health_actions(before['health_actions'])}")

    # drain: the writer stops, every written chunk reaches the index
    feeding.clear()
    feeder.join(timeout=5.0)
    feed.close()
    total = feed.chunks_written()
    drained = run.wait_until(lambda: len(impl.knn) >= total, job.deadline("drain"),
                             "the backlog's drain", give_up=True)
    not_indexed = 0 if drained else total - len(impl.knn)

    # the sample, drawn from the seed among the window's files
    rng = np.random.default_rng(subseed(job.seed, "ingest-sample"))
    files = np.arange(n0 // per_file + 1, max(n0 // per_file + 2, n1 // per_file))
    pick = rng.choice(files, size=min(len(files), int(traffic["sample_files"])), replace=False)
    texts, ids = [], []
    for f in sorted(int(x) for x in pick):
        rows = feed.read_file(f)
        for i in sorted(rng.choice(per_file, size=int(traffic["sample_per_file"]), replace=False)):
            texts.append(rows[i])
            ids.append(f * per_file + int(i))
    gen = TextGen(job.seed, traffic)
    q_texts = texts[: int(traffic["queries"]) // 2] + gen.questions(
        1 << 20, int(traffic["queries"]) - int(traffic["queries"]) // 2, *traffic["question_words"])
    k = int(traffic["k"])
    for q in q_texts:
        n_before = len(answers)
        queries.q.put({"query": q, "k": k, "metadata_filter": None, "filepath_globpattern": None})
        if not run.wait_until(lambda: len(answers) > n_before, job.deadline("drain"),
                              "a query's answer", give_up=True):
            break  # an answer that never came: the rest count as short
    queries.q.put(None)

    port.stop_engine(engine, engine_thread, job.deadline("drain"))
    if job.device != "cpu":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if job.device != "cpu" else 0

    # what the program produced: the index's rows, keyed by chunk
    (node,) = port.index_nodes(engine)
    key_of_id = {}
    for key, row in node.data_rows.items():
        text = next((v for v in row if isinstance(v, str)), None)
        if text is not None:
            key_of_id[chunk_id(text)] = (key, text)
    knn = impl.knn
    buffer = knn.device_buffer.clone()
    valid = knn.device_valid.clone()
    slot_of_key = dict(knn._slot_of_key)
    served = [[(d["text"], float(d["score"])) for d in (a.value if hasattr(a, "value") else a)]
              for a in answers]
    del node, impl, knn, engine, store, answers
    port.release()

    # the reference, after the program's state is gone
    tree = weights.encoder_tree(job.seed, cfg, job.device)
    missing = 0
    slots, ok_texts = [], []
    for n, text in zip(ids, texts):
        got = key_of_id.get(n)
        if got is None or got[1] != text:
            missing += 1
            continue
        slots.append(slot_of_key[got[0]])
        ok_texts.append(text)
    ref = ref_encoder.encode_texts(tree, cfg, ok_texts, job.device)
    stored = buffer[torch.tensor(slots, dtype=torch.int64, device=buffer.device)]
    embed_gap = float((stored - ref).norm(dim=-1).max()) if len(slots) else math.inf
    q_ref = ref_encoder.encode_texts(tree, cfg, q_texts, job.device)
    slot_of_text = {text: slot_of_key[key] for key, text in key_of_id.values()}
    judged = ref_search.judge(buffer, valid, q_ref, served, slot_of_text, k)
    checks = {
        "rows_missing": (missing + judged["unknown"] + not_indexed, 0),
        "answers_short": (judged["short"], 0),
        "embed_gap": (embed_gap, cfg["limits"]["embed_gap"]),
        "search_gap_mean": (judged["gap"], cfg["limits"]["search_gap_mean"]),
        "score_err_mean": (judged["score_err"], cfg["limits"]["score_err_mean"]),
    }
    err(f"bench_port: search over the index, not compared: widest gap {judged['gap_max']!r}, "
        f"largest score error {judged['score_err_max']!r}")
    if job.control:
        # the reference in fp8 in the program's place: its embeddings of the
        # sample, and its queries ranked over the index's rows
        low = ref_encoder.encode_texts(tree, cfg, ok_texts, job.device, mode="fp8")
        q_low = ref_encoder.encode_texts(tree, cfg, q_texts, job.device, mode="fp8")
        low_served = ref_search.ranked(buffer, valid, q_low, k, slot_of_text)
        low_judged = ref_search.judge(buffer, valid, q_ref, low_served, slot_of_text, k)
        job.control_readings = {"embed_gap": float((low - ref).norm(dim=-1).max()),
                                "search_gap_mean": low_judged["gap"],
                                "score_err_mean": low_judged["score_err"],
                                "search_gap_max": low_judged["gap_max"],
                                "score_err_max": low_judged["score_err_max"]}
    lengths = [int(min(w + 2, cfg["max_seq_length"]))
               for f in range(n0 // per_file, n1 // per_file + 1)
               for w in gen.file_lengths(f).tolist()]
    first = n0 - (n0 // per_file) * per_file
    tokens = lengths[first : first + (n1 - n0)]
    return {
        "setup_s": setup_s,
        "end_to_end": {"ingest_docs_per_s": (n1 - n0) / window_s, "setup_s": setup_s},
        "attempted": n1 - n0, "failed": 0,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
        "ctx": {"window_s": window_s, "docs": n1 - n0, "token_counts": tokens, "before": before,
                "after": after, "util": util, "config": cfg, "host": host},
    }
