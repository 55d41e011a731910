"""The RAG serving path through the port against the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through both packages on
the same weights: the JAX models' parameters are carried into the port
with models/convert. The models are small:
  * a cross-encoder of 2 layers at hidden 64 with cls pooling, in f32;
  * the tiny decoder, and the same decoder with a 512-slot cache whose
    prompts pass the flash gate (L > 256: the port's wrapper runs its
    plain version here, the JAX package its Pallas kernel in interpret
    mode);
  * the DocumentStore encoder of tests/test_torch_docstore.py.

Tolerances: cross-encoder, reranker and retrieval scores within 1e-4
absolute (f32 sums of at most a few hundred terms, taken in another
order by XLA and by torch); generated text, prompts, kept documents and
every other part of a result equal. Greedy tokens of the two decoders
are equal already (tests/test_torch_decoder.py), so the answers are too.

The port's models run with `device="cpu"`. Each package keeps its own
parse graph, and each run clears its own; a test that serves over HTTP
terminates its background engine when it ends.
"""

from __future__ import annotations

import functools
import json
import socket
import time
import urllib.error
import urllib.request
from importlib import import_module

import jax
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import runner as jax_runner
from pathway_tpu.models import cross_encoder as jce
from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import decoder_lm as jlm
from pathway_tpu.models import transformer as jtf
from pathway_tpu_torch.internals import runner as port_runner
from pathway_tpu_torch.models import cross_encoder as pce
from pathway_tpu_torch.models import decoder as pdec
from pathway_tpu_torch.models import decoder_lm as plm
from pathway_tpu_torch.models import transformer as ptf
from pathway_tpu_torch.models.convert import (
    cross_encoder_params_from_jax,
    decoder_params_from_jax,
)
from test_torch_docstore import DOCS, _embedders, _norm_json, _write_jsonlines

_shared_embedders = functools.cache(_embedders)

PACKAGES = {"jax": jpw, "port": tpw}
RUNNERS = {"jax": jax_runner, "port": port_runner}
DEVICE_KW = {"jax": {}, "port": {"device": "cpu"}}

_WORDS = "stream table engine incremental vector embed query latency index kernel".split()

CROSS_ENCODER = dict(
    vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64,
    pooling="cls", dtype="float32",
)
# the tiny decoder (models/decoder.py TINY), and the same weights' shapes
# with a cache long enough for prompts over the flash gate
DECODERS = {
    "tiny": dict(
        vocab_size=1024, hidden=64, layers=2, q_heads=4, kv_heads=2, mlp_dim=128,
        max_len=128, dtype="float32",
    ),
    "flash": dict(
        vocab_size=1024, hidden=64, layers=2, q_heads=4, kv_heads=2, mlp_dim=128,
        max_len=512, dtype="float32",
    ),
}


def _words(rng, n: int) -> str:
    return " ".join(rng.choice(_WORDS, size=n))


def _mod(name: str, path: str):
    return import_module(f"{PACKAGES[name].__name__}.{path}")


def _rows(name: str, cap) -> dict:
    return {key.value: tuple(_norm_json(v) for v in row) for key, row in cap.state.rows.items()}


def _run(name, *tables):
    return _mod(name, "internals.runner").run_tables(*tables)


def _terminate(name) -> None:
    eng = RUNNERS[name].last_engine()
    if eng is not None:
        eng.terminate_flag.set()


# -- the cross-encoder ---------------------------------------------------------


@pytest.fixture(scope="module")
def cross_encoders():
    jm = jce.CrossEncoderModel(
        "rag-test-ce", config=jtf.TransformerConfig(**CROSS_ENCODER), seed=5
    )
    params = cross_encoder_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.lm.params), jm.head
    )
    cfg = ptf.TransformerConfig(**CROSS_ENCODER)
    pm = pce.CrossEncoderModel("rag-test-ce", config=cfg, device="cpu")
    pm.lm = ptf.TransformerLM(cfg, params=params["lm"], device="cpu")
    pm.head = params["head"]
    return {"jax": jm, "port": pm}


def _pairs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if case == "one":
        return [(_words(rng, 4), _words(rng, 9))]
    doc_words = {"short": (3, 12), "truncated": (70, 90)}[case]
    return [
        (_words(rng, int(rng.integers(2, 6))), _words(rng, int(rng.integers(*doc_words))))
        for _ in range(12)
    ]


@pytest.mark.parametrize("case", ["short", "truncated", "one"])
def test_cross_encoder_scores_match_jax(cross_encoders, case):
    """Pairs under and over the 64-token window (encode_pair cuts the
    doc), and a batch of one."""
    pairs = _pairs(case)
    want = cross_encoders["jax"].score(pairs)
    got = cross_encoders["port"].score(pairs)
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert cross_encoders["port"].score([]).shape == (0,)


def test_cross_encoder_params_from_jax_checks_the_head(cross_encoders):
    lm = jax.tree_util.tree_map(np.asarray, cross_encoders["jax"].lm.params)
    with pytest.raises(ValueError, match="head"):
        cross_encoder_params_from_jax(lm, np.zeros(CROSS_ENCODER["hidden"] + 1, np.float32))


def test_cross_encoder_default_draws_a_seeded_head():
    """The head comes from seed + 1 on the CPU generator, so one seed
    gives one model on every device."""
    cfg = ptf.TransformerConfig(**CROSS_ENCODER)
    a = pce.CrossEncoderModel("rag-test-seed", config=cfg, seed=3, device="cpu")
    b = pce.CrossEncoderModel("rag-test-seed", config=cfg, seed=3, device="cpu")
    c = pce.CrossEncoderModel("rag-test-seed", config=cfg, seed=4, device="cpu")
    assert a.head.shape == (CROSS_ENCODER["hidden"],) and a.head.dtype == c.head.dtype
    assert float(a.head.abs().max()) < 0.2  # 0.02 x N(0, 1)
    pairs = _pairs("short", seed=1)
    np.testing.assert_array_equal(a.score(pairs), b.score(pairs))
    assert not np.allclose(a.score(pairs), c.score(pairs))


def test_cross_encoder_cached_keys_on_its_arguments():
    """One model per (name, arguments), keyed on the values themselves as
    in the JAX package."""
    cfg = ptf.TransformerConfig(**CROSS_ENCODER)
    a = pce.CrossEncoderModel.cached("rag-test-cached", config=cfg, device="cpu")
    assert pce.CrossEncoderModel.cached("rag-test-cached", device="cpu", config=cfg) is a
    assert pce.CrossEncoderModel.cached("rag-test-cached", config=cfg, seed=4, device="cpu") is not a


def _reranked(name, reranker, rows, k):
    """Scores of (q, doc) rows through the engine, then the k best docs per
    query by rerank_topk_filter."""
    pw = PACKAGES[name]
    rerankers = _mod(name, "xpacks.llm.rerankers")
    pw.G.clear()
    try:
        pairs = pw.debug.table_from_rows(pw.schema_from_types(q=str, doc=str), rows)
        scored = pairs.select(q=pw.this.q, doc=pw.this.doc, s=reranker(pw.this.doc, pw.this.q))
        grouped = scored.groupby(pw.this.q).reduce(
            q=pw.this.q,
            docs=pw.reducers.tuple(pw.this.doc),
            scores=pw.reducers.tuple(pw.this.s),
        )
        kept = grouped.select(
            q=pw.this.q, kept=rerankers.rerank_topk_filter(pw.this.docs, pw.this.scores, k)
        )
        cap_scored, cap_kept = _run(name, scored, kept)
    finally:
        pw.G.clear()
    scores = sorted(_rows(name, cap_scored).values())
    top = {row[0]: row[1] for row in _rows(name, cap_kept).values()}
    return scores, top


def _candidate_rows(seed: int = 2):
    rng = np.random.default_rng(seed)
    queries = [_words(rng, 3) for _ in range(3)]
    return [(q, _words(rng, int(rng.integers(4, 20))) + f" cand{i}")
            for q in queries for i in range(6)]


def _assert_reranked_agree(got, want):
    assert [r[:2] for r in got[0]] == [r[:2] for r in want[0]]
    np.testing.assert_allclose([r[2] for r in got[0]], [r[2] for r in want[0]], atol=1e-4, rtol=0)
    assert got[1].keys() == want[1].keys()
    for q in want[1]:
        (g_docs, g_scores), (w_docs, w_scores) = got[1][q], want[1][q]
        assert list(g_docs) == list(w_docs), q
        np.testing.assert_allclose(g_scores, w_scores, atol=1e-4, rtol=0)


def _patch_cached(monkeypatch, cls, model, seen):
    def cached(_cls, name, **kw):
        seen.append(kw)
        return model

    monkeypatch.setattr(cls, "cached", classmethod(cached))


@pytest.mark.parametrize("k", [2, 4])
def test_cross_encoder_reranker_and_topk_filter_through_the_engine(
    cross_encoders, monkeypatch, k
):
    rows = _candidate_rows()
    out, seen = {}, {"jax": [], "port": []}
    for name, cls in (("jax", jce.CrossEncoderModel), ("port", pce.CrossEncoderModel)):
        _patch_cached(monkeypatch, cls, cross_encoders[name], seen[name])
        reranker = _mod(name, "xpacks.llm.rerankers").CrossEncoderReranker(**DEVICE_KW[name])
        out[name] = _reranked(name, reranker, rows, k)
    assert seen == {"jax": [{}], "port": [{"device": "cpu"}]}
    _assert_reranked_agree(out["port"], out["jax"])
    assert all(len(docs) == k for docs, _ in out["port"][1].values())


def test_encoder_reranker_through_the_engine(monkeypatch):
    from pathway_tpu.models import minilm as jminilm
    from pathway_tpu_torch.models import minilm as pminilm

    embedders = _shared_embedders()
    rows = _candidate_rows(seed=3) + [("identical text", "identical text")]
    out, seen = {}, {"jax": [], "port": []}
    for name, cls in (("jax", jminilm.SentenceEncoder), ("port", pminilm.SentenceEncoder)):
        _patch_cached(monkeypatch, cls, embedders[name].encoder, seen[name])
        reranker = _mod(name, "xpacks.llm.rerankers").EncoderReranker(**DEVICE_KW[name])
        out[name] = _reranked(name, reranker, rows, 3)
    assert seen == {"jax": [{}], "port": [{"device": "cpu"}]}
    _assert_reranked_agree(out["port"], out["jax"])
    (self_pair,) = [r for r in out["port"][0] if r[0] == "identical text"]
    assert abs(self_pair[2] - 1.0) < 1e-4  # unit vectors: a text against itself


# -- HFPipelineChat on the decoder -------------------------------------------------

@functools.cache
def _chats(variant: str) -> dict:
    """ChatModel in both packages over one decoder's weights. The dense
    weights are scaled by 10 so that a greedy reply depends on its prompt:
    at the init's 0.02 the tiny model repeats the prompt's last token, the
    reserved [SEP], and every reply decodes to ''."""
    cfg = DECODERS[variant]
    jm = jlm.ChatModel("rag-test-decoder", config=jdec.DecoderConfig(**cfg), max_len=cfg["max_len"])
    jm.params = jax.tree_util.tree_map(lambda x: x * 10 if x.ndim == 2 else x, jm.params)
    pm = plm.ChatModel(
        "rag-test-decoder", config=pdec.DecoderConfig(**cfg), max_len=cfg["max_len"], device="cpu"
    )
    pm.params = decoder_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    return {"jax": jm, "port": pm}


def _hf_chat(name, generator, max_new_tokens=4):
    return _mod(name, "xpacks.llm.llms").HFPipelineChat(
        generator=generator, max_new_tokens=max_new_tokens
    )


@pytest.mark.parametrize("variant", ["tiny", "flash"])
def test_hf_pipeline_chat_matches_jax(variant):
    """Chat replies through the engine, from plain prompts and from
    prompt_chat_single_qa messages. The "flash" prompts run 280-320
    tokens, over the flash gate."""
    rng = np.random.default_rng(7)
    lo, hi = (5, 40) if variant == "tiny" else (280, 320)
    prompts = [_words(rng, int(rng.integers(lo, hi))) + f" p{i}" for i in range(3)]
    chats = _chats(variant)
    out = {}
    for name, pw in PACKAGES.items():
        llms = _mod(name, "xpacks.llm.llms")
        chat = _hf_chat(name, chats[name])
        pw.G.clear()
        try:
            t = pw.debug.table_from_rows(pw.schema_from_types(prompt=str), [(p,) for p in prompts])
            replies = t.select(
                prompt=pw.this.prompt,
                plain=chat(pw.this.prompt),
                qa=chat(llms.prompt_chat_single_qa(pw.this.prompt)),
            )
            (cap,) = _run(name, replies)
        finally:
            pw.G.clear()
        out[name] = sorted(_rows(name, cap).values())
    assert out["port"] == out["jax"]
    assert all(plain and qa for _, plain, qa in out["port"])
    ids, mask = chats["port"].encode_prompts(["user: " + prompts[0]], 4)
    assert (ids.shape[1] > 256) == (variant == "flash")
    # the UDF's reply is generate() on the messages' "role: content" text
    port = {p: (plain, qa) for p, plain, qa in out["port"]}
    assert port[prompts[0]] == (
        chats["port"].generate([prompts[0]], max_new_tokens=4)[0],
        chats["port"].generate(["user: " + prompts[0]], max_new_tokens=4)[0],
    )


def test_hf_pipeline_chat_places_its_decoder(monkeypatch):
    seen = []
    model = _chats("tiny")["port"]
    _patch_cached(monkeypatch, plm.ChatModel, model, seen)
    chat = tpw.xpacks.llm.llms.HFPipelineChat("rag-test-decoder", device="cpu")
    assert seen == [{"device": "cpu"}] and chat.generator is model
    assert chat.func(["hello there"]) == model.generate(["hello there"], max_new_tokens=32)


# -- question answering over a DocumentStore ------------------------------------------


def _store(name, embedder, docs_dir):
    pw = PACKAGES[name]
    docs = pw.io.jsonlines.read(
        docs_dir, schema=pw.schema_from_types(data=str, _metadata=pw.Json), mode="static"
    )
    factory = _mod(name, "stdlib.indexing.nearest_neighbors").BruteForceKnnFactory(
        embedder=embedder, reserved_space=64
    )
    return _mod(name, "xpacks.llm.document_store").DocumentStore(docs, retriever_factory=factory)


_ANSWER_QUERIES = [
    (DOCS[5], None, None, None, None, True),
    ("vector index latency", None, "contains(path, `odd`)", None, None, True),
    (DOCS[20], None, None, "docs/even/*", "some-model", False),
]


def _scripted_chat(name):
    """A chat that answers only once its prompt's context holds at least
    three documents."""
    UDF = _mod(name, "internals.udfs").UDF

    class Scripted(UDF):
        def __init__(self):
            super().__init__(return_type=str, deterministic=True)

            def chat(messages) -> str:
                prompt = messages[0]["content"] if isinstance(messages, list) else str(messages)
                n = prompt.split("Question:")[0].count(" doc")
                return f"seen {n} docs" if n >= 3 else "No information found."

            self.func = chat

    return Scripted()


def _answers(name, docs_dir, answerer: str, llm: str):
    pw = PACKAGES[name]
    qa = _mod(name, "xpacks.llm.question_answering")
    chat = _hf_chat(name, _chats("tiny")[name]) if llm == "hf" else _scripted_chat(name)
    pw.G.clear()
    try:
        store = _store(name, _shared_embedders()[name], docs_dir)
        if answerer == "base":
            rag = qa.BaseRAGQuestionAnswerer(chat, store, search_topk=3)
        else:
            rag = qa.AdaptiveRAGQuestionAnswerer(
                chat, store, n_starting_documents=1, factor=2, max_iterations=3
            )
        answers = rag.answer_query(pw.debug.table_from_rows(rag.AnswerQuerySchema, _ANSWER_QUERIES))
        summaries = rag.summarize_query(
            pw.debug.table_from_rows(
                rag.SummarizeQuerySchema, [(pw.Json([DOCS[1], DOCS[2]]), None)]
            )
        )
        caps = _run(name, answers, summaries)
    finally:
        pw.G.clear()
    return [_rows(name, cap) for cap in caps]


def _assert_results_agree(got, want):
    """Equal but for the scores, which agree within 1e-4."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            if k in ("score", "dist"):
                np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
            else:
                _assert_results_agree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_results_agree(g, w)
    else:
        assert got == want


@pytest.mark.parametrize(
    "answerer,llm", [("base", "hf"), ("base", "scripted"), ("adaptive", "hf"), ("adaptive", "scripted")]
)
def test_rag_answers_match_jax(tmp_path, answerer, llm):
    _write_jsonlines(tmp_path, DOCS)
    got = _answers("port", str(tmp_path), answerer, llm)
    want = _answers("jax", str(tmp_path), answerer, llm)
    _assert_results_agree(got, want)
    answers = [row[0] for row in got[0].values()]
    assert len(answers) == len(_ANSWER_QUERIES) and all(a["response"] for a in answers)
    if answerer == "base":
        with_docs = [a for a in answers if "context_docs" in a]
        assert len(with_docs) == 2 and all(len(a["context_docs"]) == 3 for a in with_docs)
    if llm == "scripted":
        # the adaptive answerer escalated 1 -> 2 -> 4 documents
        expected = "seen 3 docs" if answerer == "base" else "seen 4 docs"
        assert {a["response"] for a in answers} == {expected}


def test_geometric_rag_strategy_matches_jax():
    questions = ["what is a vector index?", "no answer here"]
    documents = [[f"vector index doc{i}" for i in range(8)], ["unrelated doc"]]
    out = {}
    for name in PACKAGES:
        qa = _mod(name, "xpacks.llm.question_answering")
        out[name] = qa.answer_with_geometric_rag_strategy(
            questions, documents, _scripted_chat(name), n_starting_documents=2, factor=2,
            max_iterations=3,
        )
    assert out["port"] == out["jax"] == ["seen 4 docs", "No information found."]


def test_prompts_match_jax():
    docs = [{"text": DOCS[0], "metadata": {}}, {"text": DOCS[1], "metadata": {}}]
    out = {}
    for name, pw in PACKAGES.items():
        prompts = _mod(name, "xpacks.llm.prompts")
        pw.G.clear()
        try:
            t = pw.debug.table_from_rows(
                pw.schema_from_types(q=str, docs=pw.Json, texts=pw.Json),
                [("what is x?", pw.Json(docs), pw.Json([DOCS[2], DOCS[3]]))],
            )
            res = t.select(
                qa=prompts.prompt_qa(pw.this.q, pw.this.docs),
                short=prompts.prompt_short_qa(pw.this.q, pw.this.docs),
                geometric=prompts.prompt_qa_geometric_rag(pw.this.q, pw.this.docs),
                citing=prompts.prompt_citing_qa(pw.this.q, pw.this.docs),
                summarize=prompts.prompt_summarize(pw.this.texts),
                rerank=prompts.prompt_rerank(pw.this.q, pw.this.q),
            )
            (cap,) = _run(name, res)
        finally:
            pw.G.clear()
        out[name] = list(_rows(name, cap).values())
        assert prompts.parse_score_json('{"score": 4}') == 4.0
        assert prompts.parse_cited_response("a [1] b", docs) == ("a b", [docs[1]])
    assert out["port"] == out["jax"]
    assert DOCS[0] in out["port"][0][0]


# -- the QA REST server -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(fn, *args, **kw):
    """(status, body) of one client call."""
    try:
        return 200, fn(*args, **kw)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _raw(port, path, data: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _serve_rag(name, docs_dir):
    """QASummaryRestServer over the DocumentStore and the tiny decoder,
    driven by the package's RAGClient: statuses and bodies in order."""
    pw = PACKAGES[name]
    qa = _mod(name, "xpacks.llm.question_answering")
    port = _free_port()
    pw.G.clear()
    store = _store(name, _shared_embedders()[name], docs_dir)
    rag = qa.BaseRAGQuestionAnswerer(_hf_chat(name, _chats("tiny")[name]), store, search_topk=3)
    rag.build_server("127.0.0.1", port)
    try:
        rag.run_server(threaded=True)
        client = qa.RAGClient("127.0.0.1", port, timeout=60)
        deadline = time.time() + 60
        while True:  # the routes register once the engine runs
            try:
                stats = client.statistics()
                if stats and stats.get("file_count") == len(DOCS):
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert time.time() < deadline, "the QA server did not come up"
            time.sleep(0.1)
        return [
            (200, stats),
            _call(client.answer, DOCS[5], return_context_docs=True),
            _call(client.answer, "vector index latency", filters="contains(path, `odd`)",
                  return_context_docs=True),
            _call(client.answer, DOCS[9]),
            _call(client.summarize, [DOCS[1], DOCS[2]]),
            _call(client.retrieve, DOCS[7], k=4),
            _call(client.retrieve, "stream join", k=2, filepath_globpattern="docs/odd/*"),
            _call(client.list_documents, "contains(path, `even`)"),
            _call(client.list_documents),
            _call(client._post, "/v1/pw_ai_answer", {"prompt": DOCS[3]}),
            _call(client._post, "/v1/pw_ai_summary", {"text_list": [DOCS[4]]}),
            _raw(port, "/v2/answer", b"{not json"),
            _raw(port, "/v3/nothing", b"{}"),
        ]
    finally:
        _terminate(name)
        pw.G.clear()
        # the serving tier keeps one micro-batcher per route for the life of
        # the process, bound to the route's first connector: a fresh tier
        # keeps a later server on these routes off this terminated engine
        _mod(name, "internals.serving").reset_for_tests()


def test_qa_summary_rest_server_matches_jax(tmp_path):
    _write_jsonlines(tmp_path, DOCS)
    got = _serve_rag("port", str(tmp_path))
    want = _serve_rag("jax", str(tmp_path))
    assert [s for s, _ in got] == [s for s, _ in want] == [200] * 11 + [400, 404]
    _assert_results_agree([b for _, b in got], [b for _, b in want])
    assert len(got[1][1]["context_docs"]) == 3 and got[1][1]["context_docs"][0]["text"] == DOCS[5]
    assert got[5][1][0]["text"] == DOCS[7]
