"""Private-RAG answers under closed-loop clients.

The path: a corpus written into a watched directory -> `DocumentStore`
over `BruteForceKnnFactory(SentenceTransformerEmbedder)` ->
`BaseRAGQuestionAnswerer(HFPipelineChat(generator=...))` behind
`QASummaryRestServer`, whose /v2/answer retrieves the top docs, builds
the prompt and generates greedily. Set-up starts the server, writes the
corpus once it listens, waits until every route's index holds it,
starts the clients, and lets the warm-up
generate calls finish. The window then counts answers: each credited
with the share of its own latency inside the window; the tail over every
answer sent in it. After the window the clients stop sending, the
answers in flight drain, and the server stops.

The reference then judges a sample of the window's answers, drawn from
the seed with the longest prompt among them: the context docs against
its own retrieval over its own embeddings of the corpus, the prompt
against its own, the answer's text against the served token ids, and
each served token's logit against the best of its own f32 forward pass
over the prompt and the served tokens.
"""

from __future__ import annotations

import math
import os
import socket
import time

import numpy as np

from bench_port.harness import port, weights
from bench_port.harness.core import BenchFailure, err
from bench_port.harness.feed import Feed
from bench_port.harness.serving import ClosedLoop, GenerateRecorder
from bench_port.harness.stats import credited_rate, p95_ms
from bench_port.harness.textgen import TextGen, subseed
from bench_port.reference import decoder as ref_decoder
from bench_port.reference import encoder as ref_encoder
from bench_port.reference import prompt as ref_prompt
from bench_port.reference import search as ref_search
from bench_port.reference import tokenizer as ref_tokenizer


def ephemeral_ports() -> tuple:
    """The range from which the kernel gives outgoing connections their
    local port (the Linux default where it cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
        return lo, hi
    except (OSError, ValueError):
        return 32768, 60999


def _free_port(seed: int) -> int:
    """A free port outside the kernel's ephemeral range, so no outgoing
    connection on the machine takes it between this choice and the
    server's listen (which then fails with EADDRINUSE)."""
    lo, hi = ephemeral_ports()
    ports = np.array([p for p in range(10000, 65536) if not lo <= p <= hi])
    if not len(ports):
        ports = np.arange(10000, 65536)
    rng = np.random.default_rng(subseed(seed, "port", os.getpid()))
    for port in rng.permutation(ports).tolist():
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise BenchFailure("no free port for the server")


def listening(host: str, port: int) -> bool:
    try:
        with socket.create_connection((host, port), timeout=0.5):
            return True
    except OSError:
        return False


def prompt_budget(cfg: dict) -> int:
    """Prompt tokens the chat model keeps (the most recent ones)."""
    serving = cfg["serving"]
    return min(serving["max_len"], serving["max_len"] - serving["max_new_tokens"])


def answer_rows(records: list, calls: list, budget: int) -> list:
    """Each answered record joined to the generate call that served it:
    its prompt as the reference builds it, the call, the row of ids."""
    where = {}
    for ci, call in enumerate(calls):
        for pi, p in enumerate(call["prompts"]):
            where[p] = (ci, pi)
    out = []
    for r in records:
        docs = r["reply"].get("context_docs", []) if r["reply"] else []
        prompt = ref_prompt.served_prompt(r["question"], [d["text"] for d in docs])
        ci, pi = where.get(prompt, (None, None))
        tokens = ref_tokenizer.count(prompt)
        out.append({"record": r, "prompt": prompt, "call": ci,
                    "row": None if ci is None else calls[ci]["rows"][pi],
                    "prompt_tokens": min(tokens, budget)})
    return out


def start_in_groups(run, job, recorder, clients, gen, traffic) -> None:
    """Start the clients in `traffic["client_groups"]` equal groups that
    take turns at the chat model. Answers of one generate call return
    together and their clients ask again at once, so a group, once
    formed, keeps together: while one group's call runs, the others'
    questions queue and make the next call. Left to chance, the first
    engine step splits the clients at random (two calls of 1 and 31, or
    12 and 20, in one cell's runs), and the split sets the rate. So a
    pilot question occupies the model, and each group is let go while
    the call before it runs."""
    import threading

    groups = int(traffic["client_groups"])
    size = int(traffic["clients"]) // groups
    pilot = threading.Thread(target=clients.pilot,
                             args=(gen.questions(1 << 21, 1, 8, 8)[0], job.deadline("setup")), daemon=True)
    pilot.start()
    seen = 0
    for g in range(groups):
        run.wait_until(lambda: len(recorder.started) > seen, job.deadline("setup"),
                       "a generate call to start")
        seen = len(recorder.started)
        clients.start(range(g * size, (g + 1) * size))
    pilot.join(timeout=max(0.0, job.deadline("setup") - time.perf_counter()))


def run(job) -> dict:
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    cfg, traffic, run = job.config, job.traffic, job.run
    enc_cfg, serving = cfg["embedder"], cfg["serving"]
    per_file = int(traffic["chunks_per_file"])
    n_files = int(traffic["corpus_chunks"]) // per_file
    corpus = n_files * per_file
    feed = Feed(run, job.root, job.seed, traffic, job.workdir)
    recorder = GenerateRecorder(port.chat_model(cfg, job.seed, job.device))
    pw.G.clear()
    store = port.document_store(port.jsonlines_docs(feed.watch, traffic["poll_s"]), enc_cfg,
                                job.seed, job.device)
    rag = BaseRAGQuestionAnswerer(
        HFPipelineChat(generator=recorder, max_new_tokens=serving["max_new_tokens"],
                       max_batch_size=serving["max_batch_size"]),
        store, search_topk=serving["search_topk"])
    host, http_port = "127.0.0.1", _free_port(job.seed)
    rag.build_server(host, http_port)
    server = rag.run_server(threaded=True)
    engine = port.running_engine(run, job.deadline("setup"))
    # The corpus is written once the server listens. The program's
    # webserver waits 10 s for its thread to listen and then lets the next
    # route start a second server on the same port, which dies with
    # EADDRINUSE and fails the run; an ingest of the corpus beside the
    # server's start held that thread up past 10 s in some runs on an
    # H100 (PERF.md, Open questions).
    run.wait_until(lambda: listening(host, http_port), job.deadline("setup"), "the server to listen")
    err(f"bench_port: the server on {host}:{http_port} listens "
        f"{time.perf_counter() - job.t_start:.1f} s after the start (ephemeral ports %d-%d)" % ephemeral_ports())
    feed.want(n_files)

    def every_index_full():
        return feed.written >= n_files and all(len(i.knn) >= corpus for i in port.index_impls(engine))

    run.wait_until(every_index_full, job.deadline("setup"), "every route's index of the corpus")
    feed.close()

    gen = TextGen(job.seed, traffic)
    lo, hi = traffic["question_words"]
    questions = [gen.questions(c, int(traffic["questions_per_client"]), lo, hi)
                 for c in range(int(traffic["clients"]))]
    clients = ClosedLoop(run, f"http://{host}:{http_port}", questions, float(traffic["request_timeout_s"]))
    start_in_groups(run, job, recorder, clients, gen, traffic)
    warm = recorder.finished() + int(traffic["warmup_calls"])
    run.wait_until(lambda: recorder.finished() >= warm, job.deadline("setup"), "the warm-up generate calls")

    before_actions = port.health_actions()
    trace = job.trace_window()
    if trace:
        trace.open()
    t_open = time.perf_counter()
    if trace:
        first = recorder.finished()
        # whole generate calls that start in the traced window
        want = int(traffic["trace_calls"])

        def traced_calls():
            return sum(1 for c in recorder.calls[first:] if c["t0"] >= t_open) >= want

        run.wait_until(traced_calls, t_open + float(traffic["trace_limit_s"]), "the traced generate calls")
        trace.close()
        t_close = trace.t_close
    else:
        run.wait_until(lambda: time.perf_counter() - t_open >= job.seconds, t_open + job.seconds + 5.0,
                       "the window")
        t_close = time.perf_counter()
    job.t_close = t_close
    clients.stop_sending.set()
    run.wait_until(clients.done, job.deadline("drain"), "the answers in flight", give_up=True)
    records = sorted(clients.snapshot(), key=lambda r: r["t_send"])
    port.stop_engine(engine, server, job.deadline("drain") + 30.0)
    if job.device != "cpu":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if job.device != "cpu" else 0
    calls = list(recorder.calls)
    indexed = [index_rows(node) for node in port.index_nodes(engine)]
    recorder.inner = None
    del recorder, rag, store, engine, server
    port.release()

    budget = prompt_budget(cfg)
    done = [r for r in records if r["reply"] is not None]
    joined = answer_rows(done, calls, budget)
    sent = [r for r in records if t_open <= r["t_send"] < t_close]
    answered = [j for j in joined if t_open <= j["record"]["t_send"] < t_close]
    failed = sum(1 for r in sent if r["reply"] is None)
    if not answered:
        raise BenchFailure(f"{len(sent)} answers sent in the window, {failed} failed")
    # an answer that never came is for `correct`; the tail is of those that did
    p95 = p95_ms([r["t_recv"] - r["t_send"] for r in sent if r["reply"] is not None])
    rate = credited_rate([(r["t_send"], r["t_recv"]) for r in done], t_open, t_close)
    setup_s = t_open - job.t_start

    checks = dict(answers_failed=(failed, 0), **judge(job, cfg, traffic, feed, answered, indexed))
    ctx = {"t_open": t_open, "t_close": t_close, "window_s": t_close - t_open, "calls": calls,
           "answers": joined, "config": cfg, "new_tokens": serving["max_new_tokens"],
           "host": [("generate call", c["t0"], c["t1"]) for c in calls]}
    tokens: dict = {}
    for j in joined:
        tokens.setdefault(j["call"], []).append(j["prompt_tokens"])
    shown = [(len(c["prompts"]), max(tokens.get(i, [0])), round(sum(tokens.get(i, [0])) / len(c["prompts"])),
              round(c["t1"] - c["t0"], 3)) for i, c in enumerate(calls) if t_open <= c["t0"] < t_close]
    err(f"bench_port: generate calls begun in the window (prompts, longest and mean prompt "
        f"tokens, seconds): {shown}; health actions {port.health_actions(before_actions)}")
    return {
        "setup_s": setup_s,
        "end_to_end": {"answers_per_s": rate, "answer_p95_ms": p95, "setup_s": setup_s},
        "attempted": len(sent), "failed": failed,
        "memory_peak_bytes": memory_peak, "checks": checks, "ctx": ctx,
    }


def index_rows(node) -> tuple:
    """One route's index as the program left it: its texts and, in the
    same order, the vectors it holds for them."""
    import torch

    knn = node.index.knn
    texts, slots = [], []
    for key, row in node.data_rows.items():
        text = next((v for v in row if isinstance(v, str)), None)
        if text is not None and key in knn._slot_of_key:
            texts.append(text)
            slots.append(knn._slot_of_key[key])
    at = torch.tensor(slots, dtype=torch.int64, device=knn.device)
    return texts, knn.device_buffer[at].clone()


def judge(job, cfg: dict, traffic: dict, feed, answered: list, indexed: list) -> dict:
    """The reference's reading of a sample of the window's answers, and
    of every route's index of the corpus."""
    import torch

    enc_cfg, serving = cfg["embedder"], cfg["serving"]
    k, new = serving["search_topk"], serving["max_new_tokens"]
    rng = np.random.default_rng(subseed(job.seed, "rag-sample"))
    n = min(len(answered), int(traffic["sample_answers"]))
    pick = list(rng.choice(len(answered), size=n, replace=False)) if n else []
    longest = max(range(len(answered)), key=lambda i: answered[i]["prompt_tokens"], default=None)
    if longest is not None and longest not in pick:
        pick[-1] = longest
    sample = [answered[int(i)] for i in pick]

    per_file = int(traffic["chunks_per_file"])
    texts = [t for f in range(int(traffic["corpus_chunks"]) // per_file) for t in feed.read_file(f)]
    slot_of_text = {t: i for i, t in enumerate(texts)}
    tree = weights.encoder_tree(job.seed, enc_cfg, job.device)
    corpus = ref_encoder.encode_texts(tree, enc_cfg, texts, job.device)
    q_ref = ref_encoder.encode_texts(tree, enc_cfg, [s["record"]["question"] for s in sample], job.device)
    served = [[(d["text"], float(d["score"])) for d in s["record"]["reply"].get("context_docs", [])]
              for s in sample]
    valid = torch.ones(len(texts), dtype=torch.bool, device=corpus.device)
    retrieval = ref_search.judge(corpus, valid, q_ref, served, slot_of_text, k)
    # every route's vectors of the corpus against the reference's (a text
    # the corpus does not hold, or a chunk left out, is a missing row)
    embed_gap, rows_missing = 0.0, 0
    for texts_i, rows_i in indexed:
        known = [(slot_of_text[t], j) for j, t in enumerate(texts_i) if t in slot_of_text]
        rows_missing += len(texts) - len(known)
        if known:
            ref_at = torch.tensor([a for a, _ in known], device=corpus.device)
            got_at = torch.tensor([b for _, b in known], device=rows_i.device)
            embed_gap = max(embed_gap, float((rows_i[got_at].to(corpus.device) - corpus[ref_at])
                                             .norm(dim=-1).max()))
    if not indexed:
        rows_missing = len(texts)
    if job.control:
        corpus_low = ref_encoder.encode_texts(tree, enc_cfg, texts, job.device, mode="fp8")
        q_low = ref_encoder.encode_texts(tree, enc_cfg, [s["record"]["question"] for s in sample],
                                         job.device, mode="fp8")
    del tree

    prompt_mismatch = sum(1 for s in sample if s["row"] is None)
    answer_mismatch = sum(1 for s in sample if s["row"] is not None and (
        len(s["row"]) != new or ref_tokenizer.decode(s["row"]) != s["record"]["reply"].get("response")))
    judged = [s for s in sample if s["row"] is not None and len(s["row"]) == new]
    gap = token_gaps(job, cfg, judged, prompt_budget(cfg)) if judged else math.inf
    if job.control:
        # the reference in fp8 in the program's place: its retrieval over its
        # own fp8 embeddings of the corpus, and its first token at each position
        low = ref_search.judge(corpus, valid, q_ref,
                               ref_search.ranked(corpus_low, valid, q_low, k, slot_of_text),
                               slot_of_text, k)
        job.control_readings = {
            "corpus_embed_gap": float((corpus_low - corpus).norm(dim=-1).max()),
            "context_gap_mean": low["gap"], "context_score_err_mean": low["score_err"],
            "context_gap_max": low["gap_max"], "context_score_err_max": low["score_err_max"],
            "token_gap": token_gaps(job, cfg, judged, prompt_budget(cfg), control=True)}
    del corpus
    lim = cfg["limits"]
    err(f"bench_port: retrieval, not compared: mean gap {retrieval['gap']!r} (widest "
        f"{retrieval['gap_max']!r}), mean score error {retrieval['score_err']!r} (largest "
        f"{retrieval['score_err_max']!r})")
    return {
        "prompt_mismatch": (prompt_mismatch, 0),
        "answer_mismatch": (answer_mismatch, 0),
        "context_short": (retrieval["short"] + retrieval["unknown"], 0),
        "corpus_rows_missing": (rows_missing, 0),
        "corpus_embed_gap": (embed_gap, lim["corpus_embed_gap"]),
        "token_gap": (gap, lim["token_gap"]),
    }


def token_gaps(job, cfg: dict, judged: list, budget: int, control: bool = False) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best, over the judged answers' served tokens. With
    `control`, the gap of the token the control's fp8 forward puts first
    at each of those positions, on the same prompts and served tokens."""
    seqs, rows = [], []
    for s in judged:
        ids = ref_tokenizer.encode(s["prompt"], cfg["vocab_size"])[-budget:]
        seqs.append(ids + s["row"][:-1])
        rows.append(s["row"])
    import torch

    head = weights.decoder_head(job.seed, cfg, job.device)
    layer = lambda i: weights.decoder_layer(job.seed, cfg, i, job.device)  # noqa: E731
    logits = ref_decoder.logits_at(head, layer, cfg, seqs, len(rows[0]))
    if control:
        low = ref_decoder.logits_at(head, layer, cfg, seqs, len(rows[0]), mode="fp8")
        rows = [lg.argmax(dim=-1).tolist() for lg in low]
    gap = 0.0
    for lg, row in zip(logits, rows):
        picked = lg[torch.arange(len(row), device=lg.device), torch.tensor(row, device=lg.device)]
        gap = max(gap, float((lg.max(dim=-1).values - picked).max()))
    return gap
