"""DocumentStore through the port against the JAX package, on the CPU.

The same jsonlines files go through `DocumentStore` in both packages:
fs jsonlines connector -> DocumentStore -> BruteForceKnnFactory ->
retrieve_query / statistics_query / inputs_query. The fused path's
encoder is small (the config of tests/test_torch_knn.py) and its weights
cross over with `params_from_jax`, so both packages embed with the same
weights. Answers must agree: the same query keys, the same retrieved
texts and metadata in the same order, scores within 1e-4 absolute. The
fused path runs with the DevicePipeline on, with it off
(PATHWAY_DEVICE_PIPELINE=0), and with packed query batches
(PATHWAY_SERVE_PACK_QUERIES=1, `FusedEmbedSearch._packed_query_search`).

Then the seven cases of tests/test_matrix_docstore_ported.py (glob and
jmespath filters, the two composed, hybrid, no metadata, inputs listing,
monotone scores), run through each package with the same inputs, and the
serving result cache: with a live serving tier, a query asked again after
the index changed must see the change.

The port's indexes are built with `device="cpu"`; the two packages keep
separate parse graphs, and each run clears its own.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import serving as jax_serving
from pathway_tpu.internals.runner import run_tables as jax_run_tables
from pathway_tpu.models import transformer as jax_tf
from pathway_tpu_torch.internals import serving as port_serving
from pathway_tpu_torch.internals.runner import run_tables as port_run_tables
from pathway_tpu_torch.models import transformer as port_tf
from pathway_tpu_torch.models.convert import params_from_jax

PACKAGES = {"jax": jpw, "port": tpw}
RUN_TABLES = {"jax": jax_run_tables, "port": port_run_tables}
SERVING = {"jax": jax_serving, "port": port_serving}
DEVICE_KW = {"jax": {}, "port": {"device": "cpu"}}

_WORDS = "stream table engine incremental vector embed query latency index kernel".split()


def _docs(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=12)) + f" doc{i}" for i in range(n)]


DOCS = _docs(48)


def _write_jsonlines(directory, docs, n_files: int = 3) -> None:
    per_file = -(-len(docs) // n_files)
    for f in range(n_files):
        with open(os.path.join(directory, f"docs_{f}.jsonl"), "w") as fh:
            for i in range(f * per_file, min(len(docs), (f + 1) * per_file)):
                meta = {"path": f"docs/{'even' if i % 2 == 0 else 'odd'}/d{i}.txt",
                        "modified_at": 100 + i, "seen_at": 200 + i}
                fh.write(json.dumps({"data": docs[i], "_metadata": meta}) + "\n")


def _embedders():
    """SentenceTransformerEmbedder in both packages over one small encoder:
    the JAX one's weights carried into the port's."""
    jc = jax_tf.TransformerConfig(
        vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64,
        dtype="float32",
    )
    pc = port_tf.TransformerConfig(**dataclasses.asdict(jc))
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as PortEmbedder

    jemb = JaxEmbedder("docstore-test", config=jc, max_len=64, seed=3)
    pemb = PortEmbedder("docstore-test", config=pc, max_len=64, device="cpu")
    pemb.encoder.lm = port_tf.TransformerLM(
        pc,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jemb.encoder.lm.params)),
        device="cpu",
    )
    return {"jax": jemb, "port": pemb}


def _norm_json(v):
    return v.value if hasattr(v, "value") else v


def _run_docstore(name, embedder, docs_dir, queries, **factory_kw):
    """retrieve / statistics / inputs answers of one package, by query key."""
    pw = PACKAGES[name]
    from importlib import import_module

    pkg = pw.__name__
    DocumentStore = import_module(f"{pkg}.xpacks.llm.document_store").DocumentStore
    Factory = import_module(f"{pkg}.stdlib.indexing.nearest_neighbors").BruteForceKnnFactory
    pw.G.clear()
    try:
        docs = pw.io.jsonlines.read(
            docs_dir,
            schema=pw.schema_from_types(data=str, _metadata=pw.Json),
            mode="static",
        )
        store = DocumentStore(
            docs,
            retriever_factory=Factory(embedder=embedder, reserved_space=16, **factory_kw),
        )
        retrieve = store.retrieve_query(
            pw.debug.table_from_rows(store.RetrieveQuerySchema, queries)
        )
        stats = store.statistics_query(
            pw.debug.table_from_rows(store.StatisticsQuerySchema, [()])
        )
        inputs = store.inputs_query(
            pw.debug.table_from_rows(
                store.InputsQuerySchema, [(None, None), ("contains(path, `even`)", None)]
            )
        )
        caps = RUN_TABLES[name](retrieve, stats, inputs)
    finally:
        pw.G.clear()
    return [
        {key.value: tuple(_norm_json(v) for v in row) for key, row in cap.state.rows.items()}
        for cap in caps
    ]


def _assert_retrievals_agree(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in want:
        (g,), (w,) = got[key], want[key]
        assert [d["text"] for d in g] == [d["text"] for d in w], key
        assert [d["metadata"] for d in g] == [d["metadata"] for d in w], key
        np.testing.assert_allclose(
            [d["score"] for d in g], [d["score"] for d in w], atol=1e-4, rtol=0
        )
        np.testing.assert_allclose(
            [d["dist"] for d in g], [d["dist"] for d in w], atol=1e-4, rtol=0
        )


_QUERIES = [
    (DOCS[5], 4, None, None),
    (DOCS[30], 3, None, "docs/even/*"),
    ("vector index latency", 5, "contains(path, `odd`)", None),
    (DOCS[47], 1, None, None),
]


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"PATHWAY_DEVICE_PIPELINE": "0"},
        {"PATHWAY_SERVE_PACK_QUERIES": "1"},
    ],
    ids=["pipeline", "no-pipeline", "packed-queries"],
)
def test_docstore_over_the_fused_index_matches_jax(env, tmp_path, monkeypatch):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    _write_jsonlines(tmp_path, DOCS)
    embedders = _embedders()
    got = _run_docstore("port", embedders["port"], str(tmp_path), _QUERIES)
    want = _run_docstore("jax", embedders["jax"], str(tmp_path), _QUERIES)
    _assert_retrievals_agree(got[0], want[0])
    # a doc's own text finds it at rank 1
    by_query = {row[0][0]["text"]: row for row in got[0].values() if row[0]}
    assert DOCS[5] in by_query and DOCS[47] in by_query
    assert got[1] == want[1]  # statistics: file count, last modified / indexed
    assert got[2] == want[2]  # inputs listing, with and without a filter
    (stats,) = got[1].values()
    assert stats[0] == {"file_count": len(DOCS), "last_modified": 100 + len(DOCS) - 1,
                        "last_indexed": 200 + len(DOCS) - 1}


def test_docstore_packed_queries_take_the_packed_search(tmp_path, monkeypatch):
    """The packed-query branch really runs in the port (and agrees with the
    classic branch on the same index)."""
    from pathway_tpu_torch.ops import knn as port_knn

    calls = []
    original = port_knn.FusedEmbedSearch._packed_query_search

    def spy(self, texts, k_eff):
        calls.append(len(texts))
        return original(self, texts, k_eff)

    monkeypatch.setattr(port_knn.FusedEmbedSearch, "_packed_query_search", spy)
    _write_jsonlines(tmp_path, DOCS)
    emb = _embedders()["port"]
    monkeypatch.setenv("PATHWAY_SERVE_PACK_QUERIES", "1")
    packed = _run_docstore("port", emb, str(tmp_path), _QUERIES)
    assert calls and max(calls) > 1
    monkeypatch.setenv("PATHWAY_SERVE_PACK_QUERIES", "0")
    calls.clear()
    classic = _run_docstore("port", emb, str(tmp_path), _QUERIES)
    assert not calls
    _assert_retrievals_agree(packed[0], classic[0])


# -- the docstore matrix of tests/test_matrix_docstore_ported.py -------------


def _fake_embedder(pw):
    """Deterministic 8-dim embedding; batched like the real one."""

    class FakeEmbedder(pw.UDF):
        def __init__(self):
            super().__init__(return_type=np.ndarray, deterministic=True)

            def embed(texts):
                out = []
                for t in texts:
                    rng = np.random.default_rng(abs(hash(t)) % (2**32))
                    v = rng.normal(size=8)
                    out.append(v / np.linalg.norm(v))
                return out

            self.func = embed
            self.max_batch_size = 256

        def get_embedding_dimension(self) -> int:
            return 8

    return FakeEmbedder()


def _knn_factory(name):
    from importlib import import_module

    Factory = import_module(
        f"{PACKAGES[name].__name__}.stdlib.indexing.nearest_neighbors"
    ).BruteForceKnnFactory
    return Factory(
        dimensions=8, embedder=_fake_embedder(PACKAGES[name]), reserved_space=64,
        **DEVICE_KW[name],
    )


def _docs_with_metadata(pw, rows):
    return pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=pw.Json),
        [(text, pw.Json({"path": path})) for text, path in rows],
    )


def _store(name, docs, factory=None):
    from importlib import import_module

    DocumentStore = import_module(
        f"{PACKAGES[name].__name__}.xpacks.llm.document_store"
    ).DocumentStore
    return DocumentStore(docs, retriever_factory=factory or _knn_factory(name))


def _retrieve(name, store, query, k=4, metadata_filter=None, glob=None):
    pw = PACKAGES[name]
    queries = pw.debug.table_from_rows(
        store.RetrieveQuerySchema, [(query, k, metadata_filter, glob)]
    )
    (cap,) = RUN_TABLES[name](store.retrieve_query(queries))
    ((res,),) = cap.state.rows.values()
    return [d["text"] for d in res.value]


_CORPUS = [
    ("apple pie recipe", "docs/food/pie.txt"),
    ("banana bread recipe", "docs/food/bread.txt"),
    ("rocket engine manual", "docs/tech/rocket.txt"),
]


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    pw = PACKAGES[request.param]
    pw.G.clear()
    yield request.param
    pw.G.clear()


@pytest.mark.parametrize(
    "glob,expected_subset",
    [
        ("docs/food/*", {"apple pie recipe", "banana bread recipe"}),
        ("docs/tech/*", {"rocket engine manual"}),
        ("**/*.txt", None),  # everything
        ("docs/nothing/*", set()),
    ],
)
def test_glob_filtering_limits_candidates(pkg, glob, expected_subset):
    store = _store(pkg, _docs_with_metadata(PACKAGES[pkg], _CORPUS))
    got = set(_retrieve(pkg, store, "recipe", k=4, glob=glob))
    if expected_subset is None:
        assert got == {t for t, _p in _CORPUS}
    else:
        assert got == expected_subset


@pytest.mark.parametrize(
    "metadata_filter,expected",
    [
        ("contains(path, `food`)", {"apple pie recipe", "banana bread recipe"}),
        ("path == `docs/tech/rocket.txt`", {"rocket engine manual"}),
    ],
)
def test_metadata_jmespath_filtering(pkg, metadata_filter, expected):
    store = _store(pkg, _docs_with_metadata(PACKAGES[pkg], _CORPUS))
    got = set(_retrieve(pkg, store, "anything", k=4, metadata_filter=metadata_filter))
    assert got == expected


def test_metadata_and_glob_compose(pkg):
    store = _store(pkg, _docs_with_metadata(PACKAGES[pkg], _CORPUS))
    got = _retrieve(
        pkg,
        store,
        "recipe",
        k=4,
        metadata_filter="contains(path, `recipe`) || contains(path, `pie`)",
        glob="docs/food/*",
    )
    assert set(got) <= {"apple pie recipe", "banana bread recipe"}


def test_hybrid_index_glob_filtering(pkg):
    from importlib import import_module

    base = f"{PACKAGES[pkg].__name__}.stdlib.indexing"
    TantivyBM25Factory = import_module(f"{base}.bm25").TantivyBM25Factory
    HybridIndexFactory = import_module(f"{base}.hybrid_index").HybridIndexFactory
    hybrid = HybridIndexFactory([_knn_factory(pkg), TantivyBM25Factory()])
    store = _store(pkg, _docs_with_metadata(PACKAGES[pkg], _CORPUS), factory=hybrid)
    got = set(_retrieve(pkg, store, "recipe", k=4, glob="docs/food/*"))
    assert got == {"apple pie recipe", "banana bread recipe"}


def test_docstore_on_table_without_metadata(pkg):
    pw = PACKAGES[pkg]
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str), [("plain doc",)])
    store = _store(pkg, docs)
    assert _retrieve(pkg, store, "plain", k=1) == ["plain doc"]


def test_docstore_inputs_listing(pkg):
    pw = PACKAGES[pkg]
    store = _store(pkg, _docs_with_metadata(pw, _CORPUS))
    queries = pw.debug.table_from_rows(store.InputsQuerySchema, [(None, None)])
    (cap,) = RUN_TABLES[pkg](store.inputs_query(queries))
    ((res,),) = cap.state.rows.values()
    assert {d["path"] for d in res.value} == {p for _t, p in _CORPUS}


def test_retrieve_scores_are_monotone(pkg):
    pw = PACKAGES[pkg]
    store = _store(pkg, _docs_with_metadata(pw, _CORPUS))
    queries = pw.debug.table_from_rows(
        store.RetrieveQuerySchema, [("apple pie recipe", 3, None, None)]
    )
    (cap,) = RUN_TABLES[pkg](store.retrieve_query(queries))
    ((res,),) = cap.state.rows.values()
    scores = [d["dist"] for d in res.value]
    assert scores == sorted(scores)  # nearest first


# -- the serving result cache --------------------------------------------------

# the same query text at times 4 and 8; between them the index changes at 6
_CACHE_DOCS = {
    # a new doc equal to the query text, which must rank first at time 8
    "add": """
        data                          | __time__ | __diff__
        stream table engine           | 2        | 1
        vector embed query            | 2        | 1
        index kernel latency snapshot | 6        | 1
    """,
    # the doc that ranks first at time 4 is retracted at 6
    "remove": """
        data                          | __time__ | __diff__
        stream table engine           | 2        | 1
        vector embed query            | 2        | 1
        index kernel latency snapshot | 2        | 1
        index kernel latency snapshot | 6        | -1
    """,
}


def _serving_cache_case(pkg, change, embedder, *, cached=True, **factory_kw):
    """Query at time 4, change the index at 6, ask the same query at 8
    with a live serving tier. `cached`: the tier's result cache fronts the
    search (text queries) or is never consulted (vector queries)."""
    pw = PACKAGES[pkg]
    serving = SERVING[pkg]
    from importlib import import_module

    DocumentStore = import_module(f"{pw.__name__}.xpacks.llm.document_store").DocumentStore
    Factory = import_module(
        f"{pw.__name__}.stdlib.indexing.nearest_neighbors"
    ).BruteForceKnnFactory
    tier = serving.reset_for_tests()
    try:
        docs = pw.debug.table_from_markdown(_CACHE_DOCS[change])
        store = DocumentStore(
            docs,
            retriever_factory=Factory(embedder=embedder, reserved_space=16, **factory_kw),
        )
        queries = pw.debug.table_from_markdown(
            """
            query                         | k | metadata_filter | filepath_globpattern | __time__
            index kernel latency snapshot | 3 | None            | None                 | 4
            index kernel latency snapshot | 3 | None            | None                 | 8
            """,
            schema=store.RetrieveQuerySchema,
        )
        answers = []
        pw.io.subscribe(
            store.retrieve_query(queries),
            on_change=lambda key, row, time, is_addition: answers.append(
                (time, [d["text"] for d in row["result"].value])
            ),
        )
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        hits = tier.cache.hits
    finally:
        serving.shutdown()
    assert [t for t, _ in answers] == [4, 8]
    (_, first), (_, second) = answers
    target = "index kernel latency snapshot"
    if change == "add":
        assert target not in first and second[0] == target
        assert len(second) == 3
    else:
        assert first[0] == target and target not in second
        assert len(second) == 2
    if cached:
        # the tier was in front of the index: the second query consulted
        # the cache (and found it invalidated)
        assert tier.cache.misses >= 2 and hits == 0
    else:
        assert tier.cache.misses == 0 and hits == 0


@pytest.mark.parametrize("change", ["add", "remove"])
def test_serving_cache_sees_index_changes(pkg, change):
    """With a live serving tier, ExternalIndexNode puts the result cache in
    front of the fused index. The query at time 8 repeats the text of the
    query at time 4, so it is answered from the cache unless the index
    change at time 6 invalidated the cached entry: ops/knn.py's
    note_index_add / note_index_remove hooks do that."""
    _serving_cache_case(pkg, change, _embedders()[pkg])


@pytest.mark.parametrize("change", ["add", "remove"])
def test_serving_cache_sees_index_changes_over_a_udf_embedder(pkg, change):
    """The same over a pw.udf embedder, the vector impl (_KnnIndexImpl):
    the query reaches the index as a vector, which serving's
    ResultCache.make_key does not cache, so in both packages the answer
    at time 8 sees the change with the cache never consulted. (The
    vector impl's own generation hooks are held by
    tests/test_torch_knn.py's hooks case.)"""
    _serving_cache_case(
        pkg, change, _fake_embedder(PACKAGES[pkg]), cached=False, dimensions=8,
        **DEVICE_KW[pkg],
    )


# -- the vector impl under a degraded device monitor --------------------------


def _degraded_monitor(device_probe):
    monitor = device_probe.DeviceMonitor(probe=lambda timeout_s: (None, "down"))
    monitor.probe_once()
    assert monitor.state == "degraded"
    return monitor


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_card_vector_index_under_a_degraded_monitor_never_searches_on_the_host(monkeypatch):
    """A `_KnnIndexImpl` whose index lies on the card keeps no host mirror,
    and while the monitor holds the card degraded its searches raise
    instead of answering from `_host_search`. The card index is a stand-in
    reporting a CUDA device, so the rule is held without a card."""
    import torch

    from pathway_tpu_torch.internals import device_probe
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn

    searched = []

    class CardIndex:
        device = torch.device("cuda")

        def __init__(self, dimensions, metric, reserved_space, device, mesh=None):
            self.rows = {}

        def __len__(self):
            return len(self.rows)

        def add(self, key, vec):
            self.rows[key] = vec

        def remove(self, key):
            self.rows.pop(key, None)

        def search_keys(self, queries, k):
            searched.append(len(queries))
            return [[(key, 1.0) for key in list(self.rows)[:k]] for _ in queries]

    def host_search(self, queries, fetch):
        raise AssertionError("a card index was searched on the host")

    monkeypatch.setattr(nn, "DeviceKnnIndex", CardIndex)
    monkeypatch.setattr(nn._KnnIndexImpl, "_host_search", host_search)
    impl = nn._KnnIndexImpl(8, "cos", 16, device="cuda")
    assert impl._host_vecs is None
    for i, v in enumerate(_unit_rows(4, 8, 0)):
        impl.add(i, v, None)
    impl.remove(3)
    monkeypatch.setattr(device_probe, "_monitor", _degraded_monitor(device_probe))
    with pytest.raises(nn.DeviceDegradedError):
        impl.search_many([_unit_rows(1, 8, 1)[0]], [2], [None])
    assert searched == []
    # re-promoted: the search goes to the card index again
    device_probe._monitor.probe = lambda timeout_s: (1.0, None)
    device_probe._monitor.probe_once()
    assert impl.search_many([_unit_rows(1, 8, 1)[0]], [2], [None]) == [[(0, 1.0), (1, 1.0)]]
    assert searched == [1]


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_cpu_vector_index_under_a_degraded_monitor_answers_like_jax(monkeypatch, metric):
    """An index placed on the CPU keeps the JAX package's host path: with
    the monitor degraded both packages answer from the numpy brute force,
    and those answers equal the index's own search once re-promoted."""
    from pathway_tpu.internals import device_probe as jax_probe
    from pathway_tpu.stdlib.indexing.nearest_neighbors import _KnnIndexImpl as JaxImpl
    from pathway_tpu_torch.internals import device_probe
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _KnnIndexImpl

    vecs, queries = _unit_rows(40, 8, 2), _unit_rows(5, 8, 3)
    port, ref = _KnnIndexImpl(8, metric, 64, device="cpu"), JaxImpl(8, metric, 64)
    for impl in (port, ref):
        for i, v in enumerate(vecs):
            impl.add(i, v, {"i": i})
        impl.remove(7)
    ks, filters = [4] * len(queries), [None] * len(queries)
    monkeypatch.setattr(device_probe, "_monitor", _degraded_monitor(device_probe))
    monkeypatch.setattr(jax_probe, "_monitor", _degraded_monitor(jax_probe))
    host_port = port.search_many(list(queries), ks, filters)
    host_ref = ref.search_many(list(queries), ks, filters)
    monkeypatch.setattr(device_probe, "_monitor", None)
    searched = port.search_many(list(queries), ks, filters)
    for got, want, direct in zip(host_port, host_ref, searched):
        assert [key for key, _ in got] == [key for key, _ in want] == [key for key, _ in direct]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)
        np.testing.assert_allclose([s for _, s in got], [s for _, s in direct], atol=1e-5)


def test_a_finished_streaming_run_lets_go_of_its_engine_and_index(tmp_path):
    """A streaming run stopped through its terminate flag holds nothing
    after it: its fused index closes its DevicePipeline at the run's end,
    and its fs reader, asleep in a refresh interval of an hour, lets go of
    the run and returns at once. So the engine and the index's device
    memory are collected (memtrack drops the index's registration) while
    the caller still holds the embedder."""
    import gc
    import threading
    import time
    import weakref

    from pathway_tpu_torch.internals import device_pipeline, memtrack
    from pathway_tpu_torch.internals import runner as port_runner
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    embedder = _embedders()["port"]
    _write_jsonlines(str(tmp_path), DOCS)
    memtrack.reset_for_tests()
    pipelines_before = set(device_pipeline._PIPELINES)
    threads_before = set(threading.enumerate())
    counts: list = []
    tpw.G.clear()
    docs = tpw.io.jsonlines.read(
        str(tmp_path), schema=tpw.schema_from_types(data=str, _metadata=tpw.Json),
        mode="streaming", refresh_interval=3600.0,
    )
    store = DocumentStore(
        docs, retriever_factory=BruteForceKnnFactory(embedder=embedder, reserved_space=64)
    )
    queries = tpw.debug.table_from_rows(store.RetrieveQuerySchema, [("doc1", 2, None, None)])
    tpw.io.subscribe(store.retrieve_query(queries), on_change=lambda *a, **k: None)
    tpw.io.subscribe(
        store.chunked_docs.groupby().reduce(c=tpw.reducers.count()),
        on_change=lambda key, row, time, is_addition: counts.append(row["c"]),
    )
    run = threading.Thread(
        target=tpw.run, kwargs={"autocommit_duration_ms": 25}, daemon=True
    )
    run.start()
    try:
        deadline = time.monotonic() + 120
        while not counts or counts[-1] < len(DOCS):
            assert run.is_alive() and time.monotonic() < deadline, counts
            time.sleep(0.01)
        assert len(memtrack.tracker().entries("knn_index")) == 1
        engine = weakref.ref(port_runner.last_engine())
        assert set(device_pipeline._PIPELINES) - pipelines_before, "the ingest took no pipeline"
    finally:
        port_runner.last_engine().terminate_flag.set()
        run.join(timeout=60)
    assert not run.is_alive()
    del docs, store, queries
    tpw.G.clear()
    port_runner._last_engine = None
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads_before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - threads_before, "a thread of the run lives on"
    gc.collect()
    assert engine() is None, "the finished run's engine is still referenced"
    assert set(device_pipeline._PIPELINES) == pipelines_before
    assert memtrack.tracker().entries("knn_index") == []
    memtrack.reset_for_tests()
