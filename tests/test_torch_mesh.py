"""The port's data-plane mesh against the JAX package's, on the CPU.

The JAX package runs on the 8 CPU devices that tests/conftest.py forces;
the port lays its single-controller mesh over `["cpu"] * 8` with
`parallel.mesh.with_mesh`, which `mesh_backend.activate` (and so
`pw.run(mesh=...)`) takes its devices from. The same numpy inputs, made
from a seed, and the same weights (carried across by `params_from_jax`)
go to both packages; the port's kernels take their plain versions here.

Mirrors tests/test_multichip.py's backend half case by case: activation
and degradation, `dp_shard_of`, `pack_batch_dp`, the sharded ingest
against the single-device pipeline, `pw.run(mesh=...)`, /status and the
device_flap drain; then the sharded index (`DeviceKnnIndex(mesh)` slot
assignment after adds with shard hints, removes and a growth;
`sharded_knn_search`), `SentenceEncoder(mesh)` and the tp pooled encode.

Tolerances: slots and rankings equal (a live slot's, where the score is
finite); index scores atol 1e-6 on unit vectors (f32 sums of 16 products
in another order); f32 encodes atol 1e-5; the tiny bf16 encoder of
tests/test_multichip.py within 2e-2, the JAX package's own tolerance for
its tp encoder against the single-device one (bf16 partial products
psummed in another order).
"""

from __future__ import annotations

import contextlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.analysis.mesh import MeshSpec as JMeshSpec
from pathway_tpu.internals import mesh_backend as jmb
from pathway_tpu.models import transformer as jtr
from pathway_tpu.models.minilm import SentenceEncoder as JSentenceEncoder
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.analysis.mesh import MeshSpec
from pathway_tpu_torch.internals import mesh_backend
from pathway_tpu_torch.models import transformer as tr
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.models.minilm import SentenceEncoder
from pathway_tpu_torch.ops import knn
from pathway_tpu_torch.parallel.mesh import get_mesh, with_mesh

N = 8
TINY = dict(vocab_size=512, hidden=32, layers=1, heads=2, mlp_dim=64, max_len=64)


def _cpu_mesh(shape=(4, 2), names=("dp", "tp")):
    return get_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _jmesh(shape=(4, 2), names=("dp", "tp")):
    return JMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


@contextlib.contextmanager
def _env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _activated(spec: str, shape=(4, 2), names=("dp", "tp")):
    """The port's backend for `spec` over a held CPU mesh, and the JAX
    package's over its 8 CPU devices."""
    with with_mesh(_cpu_mesh(shape, names)):
        port = mesh_backend.activate(MeshSpec.parse(spec))
        jax_backend = jmb.activate(JMeshSpec.parse(spec))
        try:
            yield port, jax_backend
        finally:
            mesh_backend.deactivate()
            jmb.deactivate()


def _encoders(name: str, max_len: int = 32, **overrides):
    """The tiny encoder of tests/test_multichip.py in both packages, on the
    JAX encoder's weights."""
    cfg = dict(TINY, **overrides)
    jenc = JSentenceEncoder(name, config=jtr.TransformerConfig(**cfg), max_len=max_len)
    penc = SentenceEncoder(name, config=tr.TransformerConfig(**cfg), max_len=max_len, device="cpu")
    penc.lm = tr.TransformerLM(
        penc.config, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jenc.lm.params)),
        device="cpu",
    )
    return jenc, penc


# -- the backend's activation and degradation rules ---------------------------


def test_backend_activates_on_the_held_mesh():
    with _activated("dp=4,tp=2") as (backend, jbackend):
        assert mesh_backend.active_backend() is backend
        assert (backend.dp, backend.tp) == (jbackend.dp, jbackend.tp) == (4, 2)
        assert backend.can_shard_ingest() and jbackend.can_shard_ingest()
        assert tuple(backend.mesh.axis_names) == ("dp", "tp")
        assert backend.mesh.devices.size == 8
        assert backend.status()["device_count"] == jbackend.status()["device_count"] == 8
    assert mesh_backend.active_backend() is None


def test_backend_inactive_when_too_few_devices(caplog):
    # no held mesh and no CUDA device here: too few devices, as JAX's
    # dp=64 is for its 8
    with caplog.at_level(logging.WARNING):
        assert mesh_backend.activate(MeshSpec.parse("dp=64,tp=2")) is None
        assert jmb.activate(JMeshSpec.parse("dp=64,tp=2")) is None
    assert mesh_backend.active_backend() is None and jmb.active_backend() is None
    port_warnings = [r.getMessage() for r in caplog.records
                     if r.name == "pathway_tpu_torch.internals.mesh_backend"]
    jax_warnings = [r.getMessage() for r in caplog.records
                    if r.name == "pathway_tpu.internals.mesh_backend"]
    # the same warning, but for the devices each package sees (the JAX
    # package its 8, the port no CUDA device)
    assert port_warnings == [w.replace("only 8", "only 0") for w in jax_warnings]
    assert "needs 128 devices but only 0 are attached" in port_warnings[0]


def test_backend_refuses_a_held_mesh_of_other_axes():
    with with_mesh(_cpu_mesh()):
        for spec in ("dp=2,tp=4", "dp=8", "tp=2,dp=4"):
            with pytest.raises(ValueError, match="does not match the held mesh"):
                mesh_backend.activate(MeshSpec.parse(spec))
    assert mesh_backend.active_backend() is None


def test_backend_non_pow2_dp_keeps_single_device_ingest():
    from pathway_tpu.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl as JImpl
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    jenc, penc = _encoders("nonpow2-tiny")
    with _activated("dp=3,tp=2", shape=(3, 2)) as (backend, jbackend):
        assert not backend.can_shard_ingest() and not jbackend.can_shard_ingest()
        assert _FusedKnnIndexImpl(penc, "cos", 32).knn.mesh is None
        assert JImpl(jenc, "cos", 32).knn.mesh is None


def test_dp_shard_of_matches_exchange_rule():
    class _Ptr:
        shard = 7

    with _activated("dp=4,tp=2") as (backend, jbackend):
        keys = list(range(8)) + [_Ptr()]
        assert [backend.dp_shard_of(k) for k in keys] == [jbackend.dp_shard_of(k) for k in keys]
        assert [backend.dp_shard_of(k) for k in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]


def test_pack_batch_dp_and_batch_sharding():
    jenc, penc = _encoders("packdp-tiny")
    keys = list(range(23))
    texts = [f"alpha doc{i} bravo " + "pad " * (i % 5) for i in keys]
    with _activated("dp=4,tp=2") as (backend, jbackend):
        got = mesh_backend.pack_batch_dp(penc.tokenizer, keys, texts, backend, max_len=32,
                                         token_budget=64)
        want = jmb.pack_batch_dp(jenc.tokenizer, keys, texts, jbackend, max_len=32,
                                 token_budget=64)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2:] == want[2:]
        ids, _seg, slots, replica_rows = got
        block = ids.shape[0] // backend.dp
        for k, (row, _s) in zip(keys, slots):
            assert row // block == backend.dp_shard_of(k)
        assert sum(replica_rows) == len(keys)
        # rows over dp, replicated over tp: block d on the device at dp d
        sharding = backend.batch_sharding()
        assert tuple(sharding.spec) == ("dp", None)
        blocks = sharding.shard(ids)
        assert len(blocks) == 4 and all(b.shape == (block, ids.shape[1]) for b in blocks)
        np.testing.assert_array_equal(torch.cat(blocks).numpy(), ids)


# -- the sharded index ---------------------------------------------------------


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_search_equal(got, want):
    """(scores, slots) of the two packages: the same -inf positions, the
    same slots where the score is finite, scores within 1e-6."""
    (gs, gi), (ws, wi) = [tuple(np.asarray(a) for a in pair) for pair in (got, want)]
    live = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), live)
    np.testing.assert_array_equal(gi[live], wi[live])
    np.testing.assert_allclose(gs[live], ws[live], atol=1e-6, rtol=0)


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_sharded_index_slots_and_search_match_jax(metric):
    """Adds with shard hints (from the device and from the host), removes
    and a growth: the same global slot of every key as the JAX package's,
    then the same answers at k below and above a shard's rows."""
    rng = np.random.default_rng(0)
    d = 16
    j = jknn.DeviceKnnIndex(d, metric=metric, reserved_space=16, mesh=_jmesh((4,), ("knn",)))
    p = knn.DeviceKnnIndex(d, metric=metric, reserved_space=16, mesh=_cpu_mesh((4,), ("knn",)))
    assert p.capacity == j.capacity == 16

    def add_batch(keys, shards):
        vecs = _unit(rng, len(keys), d)
        j.add_batch(keys, jnp.asarray(vecs), shards=shards)
        p.add_batch(keys, torch.from_numpy(vecs), shards=shards)

    add_batch(list(range(10)), [k % 4 for k in range(10)])
    for key in (1, 6, 7):
        j.remove(key)
        p.remove(key)
    add_batch(list(range(100, 120)), [3] * 20)  # one shard's overflow, then a growth
    assert p.capacity == j.capacity == 32
    vec = _unit(rng, 1, d)[0]
    j.add("host", vec)
    p.add("host", vec)
    host = _unit(rng, 2, d)  # host vectors: no shard hints
    j.add_batch(["h1", "h2"], host)
    p.add_batch(["h1", "h2"], host)
    j.remove(104)
    p.remove(104)
    assert p._slot_of_key == j._slot_of_key
    assert len(p) == len(j) == 29
    np.testing.assert_allclose(p.device_buffer.numpy(), np.asarray(j.device_buffer), atol=1e-6)
    np.testing.assert_array_equal(p.device_valid.numpy(), np.asarray(j.device_valid))
    queries = _unit(rng, 5, d)
    for k in (3, 12, 40):  # a shard holds 8 rows
        ps, pi, _ = p.search(queries, k)
        js, ji, _ = j.search(queries, k)
        _assert_search_equal((ps, pi), (js, ji))
        assert p.search_keys(queries, k) == [
            [(key, pytest.approx(s, abs=1e-6)) for key, s in row] for row in j.search_keys(queries, k)
        ]


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
@pytest.mark.parametrize("k", [5, 150])
def test_sharded_knn_search_matches_jax(metric, k):
    """`sharded_knn_search` over 4 shards of 256 rows: k = 5 takes the
    kernel's plain version on each shard, k = 150 the dense top-k (above
    the kernel's 128); the merge equals JAX's, dead slots included."""
    rng = np.random.default_rng(1)
    index = _unit(rng, 1024, 24)
    valid = rng.random(1024) > 0.1
    queries = _unit(rng, 8, 24)
    want = jknn.sharded_knn_search(_jmesh((4,), ("knn",)), jnp.asarray(index), jnp.asarray(valid),
                                   jnp.asarray(queries), k, metric="ip" if metric == "cos" else metric)
    got = knn.sharded_knn_search(_cpu_mesh((4,), ("knn",)), torch.from_numpy(index),
                                 torch.from_numpy(valid), queries, k, metric=metric)
    assert got[0].shape == (8, k)
    _assert_search_equal(got, want)
    # and the unsharded search of the same rows
    dense = knn._search(torch.from_numpy(index), torch.from_numpy(valid), torch.from_numpy(queries),
                        k, metric)
    _assert_search_equal(got, dense)


def test_sharded_index_checks_its_mesh_and_device():
    with pytest.raises(ValueError, match="a power of two is required"):
        knn.DeviceKnnIndex(8, mesh=_cpu_mesh((3,), ("knn",)))
    with pytest.raises(ValueError, match="contradicts the mesh"):
        knn.DeviceKnnIndex(8, mesh=get_mesh((2,), ("knn",), devices=["meta"] * 2), device="cpu")
    idx = knn.DeviceKnnIndex(8, reserved_space=2, mesh=_cpu_mesh((8,), ("knn",)))
    assert idx.capacity == 16 and len(idx._blocks) == 8 and idx.device == torch.device("cpu")


# -- the encoder over the mesh ----------------------------------------------------


def test_sentence_encoder_dp_mesh_matches_jax():
    jenc, penc = _encoders("mesh-enc-tiny", dtype="float32")
    texts = [f"doc {i} " + "word " * (i % 9) for i in range(16)]
    jm = JSentenceEncoder("mesh-enc-tiny", config=jenc.config, max_len=32, mesh=_jmesh((8,), ("dp",)))
    jm.lm = jenc.lm
    pm = SentenceEncoder("mesh-enc-tiny", config=penc.config, max_len=32,
                         mesh=_cpu_mesh((8,), ("dp",)))
    pm.lm = penc.lm
    assert pm.device == torch.device("cpu")
    got = pm.encode(texts)
    np.testing.assert_allclose(got, jm.encode(texts), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, penc.encode(texts), atol=1e-6, rtol=0)
    # a batch the dp axis does not divide encodes unsharded
    np.testing.assert_allclose(pm.encode(texts[:3]), jm.encode(texts[:3]), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="not a power of two"):
        SentenceEncoder("x", config=penc.config, mesh=_cpu_mesh((3,), ("dp",)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_tp_encode_matches_jax_mesh_params(dtype, packed):
    """`TransformerLM.mesh_params` + the tp pooled encode, classic and
    packed, against the JAX package's encode with its mesh_params."""
    cfg = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64, dtype=dtype)
    jc, pc = jtr.TransformerConfig(**cfg), tr.TransformerConfig(**cfg)
    params = jtr.init_params(jax.random.PRNGKey(4), jc)
    jlm = jtr.TransformerLM(jc, params=params)
    plm = tr.TransformerLM(pc, params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                           device="cpu")
    pmesh, jmesh = _cpu_mesh(), _jmesh()
    mesh_params = plm.mesh_params(pmesh)
    assert plm.mesh_params(pmesh) is mesh_params and len(mesh_params) == 4
    assert all(len(row) == 2 for row in mesh_params)
    from pathway_tpu.models.tokenizer import encode_batch as jencode_batch
    from pathway_tpu.models.tokenizer import HashTokenizer, pack_batch

    tok = HashTokenizer(vocab_size=512)
    texts = [f"stream {i} " + "table " * (i % 7) for i in range(12)]
    if packed:
        ids, seg, slots = pack_batch(tok, texts, max_len=32, token_budget=64)
        want = np.asarray(jlm.encode_packed(ids, seg, 8, params=jlm.mesh_params(jmesh)))
        got = plm.encode_packed(ids, seg, 8, params=mesh_params[0]).numpy()
        unsharded = plm.encode_packed(ids, seg, 8).numpy()
    else:
        ids, mask = jencode_batch(tok, texts, max_len=32)
        want = np.asarray(jlm(ids, mask, params=jlm.mesh_params(jmesh)))
        got = plm(ids, mask, params=mesh_params[0]).numpy()
        unsharded = plm(ids, mask).numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, unsharded, atol=tol, rtol=0)


# -- the framework path ------------------------------------------------------


def test_mesh_backend_ingest_parity_vs_single_device_and_jax():
    """A dp=4,tp=2 backend runs the whole ingest path sharded (dp-grouped
    packed slabs through the async pipeline, tp-sharded encoder, shard-
    routed index slots, per-shard search + merge) and returns the same
    ranking as the single-device pipeline and as the JAX package's
    sharded run; scores within 2e-2."""
    from pathway_tpu.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl as JImpl
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    texts = [f"alpha doc number {i} bravo charlie token{i % 7}" for i in range(40)]
    keys = list(range(len(texts)))
    queries = [texts[3], texts[17], "token3 alpha"]
    jenc, penc = _encoders("mesh-parity-tiny", max_len=16)

    def run(impl):
        impl.add_many(keys, texts, [None] * len(keys))
        impl.drain()
        return impl.search_many(queries, [3] * len(queries), [None] * len(queries))

    with _env(PATHWAY_DEVICE_PIPELINE="1"):
        ref_rows = run(_FusedKnnIndexImpl(penc, "cos", 64))
        with _activated("dp=4,tp=2") as (backend, jbackend):
            impl = _FusedKnnIndexImpl(penc, "cos", 64)
            assert impl.knn.mesh is backend.mesh
            rows = run(impl)
            assert impl._pipeline is not None and impl._pipeline.replicas == backend.dp
            assert impl._pipeline.stats()["rows"] == len(keys)
            per_replica = impl._pipeline.replica_stats()
            assert sum(r["rows"] for r in per_replica) == len(keys)
            jimpl = JImpl(jenc, "cos", 64)
            jrows = run(jimpl)
            assert impl.knn._slot_of_key == jimpl.knn._slot_of_key
            assert [r["rows"] for r in per_replica] == [
                r["rows"] for r in jimpl._pipeline.replica_stats()
            ]
    for want in (ref_rows, jrows):
        assert [[k for k, _ in r] for r in rows] == [[k for k, _ in r] for r in want]
        np.testing.assert_allclose(
            np.array([[s for _, s in r] for r in rows]),
            np.array([[s for _, s in r] for r in want]),
            atol=2e-2, rtol=0,
        )


def _retrievals_under_run(pw, embedder, docs, **run_kw):
    """DocumentStore over `docs` in one package, each doc's own text asked
    back at k = 3 through `pw.run(**run_kw)`: {query: [(text, dist)]}, and
    the mesh backend each answer saw."""
    from importlib import import_module

    DocumentStore = import_module(f"{pw.__name__}.xpacks.llm.document_store").DocumentStore
    Factory = import_module(f"{pw.__name__}.stdlib.indexing.nearest_neighbors").BruteForceKnnFactory
    backend_of = import_module(f"{pw.__name__}.internals.mesh_backend").active_backend
    answers, backends = {}, []

    def on_change(key, row, time, is_addition):
        hits = [(d["text"], d["dist"]) for d in row["result"].value]
        answers[hits[0][0]] = hits
        backends.append(backend_of())

    pw.G.clear()
    try:
        table = pw.debug.table_from_rows(pw.schema_from_types(data=str), [(d,) for d in docs])
        store = DocumentStore(table, retriever_factory=Factory(embedder=embedder, reserved_space=16))
        queries = pw.debug.table_from_rows(store.RetrieveQuerySchema,
                                           [(d, 3, None, None) for d in docs[::5]])
        pw.io.subscribe(store.retrieve_query(queries), on_change=on_change)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, **run_kw)
    finally:
        pw.G.clear()
    return answers, backends


def test_pw_run_tp_only_mesh_ingest_matches_jax(caplog):
    """pw.run(mesh="tp=2"): the backend takes the mesh's one axis as its dp
    axis, as the JAX package's does, so ingest packs two replica blocks,
    each encoded with the encoder's tp shards; every answer equals the JAX
    package's run of the same spec (scores within 2e-2, the tp encoder's
    tolerance) and each doc is found at rank 1. The dp-packed dispatch
    itself must run: no pipeline fallback replays the batches classic."""
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    cfg = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64, dtype="float32")
    jemb = JEmbedder("tp-run-tiny", config=jtr.TransformerConfig(**cfg), max_len=32, seed=3)
    pemb = SentenceTransformerEmbedder("tp-run-tiny", config=tr.TransformerConfig(**cfg), max_len=32,
                                       device="cpu")
    pemb.encoder.lm = tr.TransformerLM(
        pemb.encoder.config,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jemb.encoder.lm.params)),
        device="cpu",
    )
    rng = np.random.default_rng(5)
    words = "stream table engine incremental vector embed query latency index kernel".split()
    docs = [" ".join(rng.choice(words, size=10)) + f" doc{i}" for i in range(24)]
    with caplog.at_level(logging.WARNING), _env(PATHWAY_DEVICE_PIPELINE="1"), with_mesh(
        _cpu_mesh((2,), ("tp",))
    ):
        got, backends = _retrievals_under_run(tpw, pemb, docs, mesh="tp=2")
    assert not [r for r in caplog.records if r.name.startswith("pathway_tpu_torch")
                and "device pipeline disabled" in r.getMessage()]
    want, jbackends = _retrievals_under_run(jpw, jemb, docs, mesh="tp=2")
    assert backends and all(b is not None for b in backends + jbackends)
    assert {(b.dp_axis, b.dp, b.tp) for b in backends} == {("tp", 2, 2)}
    assert {(b.dp_axis, b.dp, b.tp) for b in jbackends} == {("tp", 2, 2)}
    assert mesh_backend.active_backend() is None
    assert sorted(got) == sorted(want) == sorted(docs[::5])
    for query in want:
        assert [t for t, _ in got[query]] == [t for t, _ in want[query]]
        np.testing.assert_allclose([s for _, s in got[query]], [s for _, s in want[query]],
                                   atol=2e-2, rtol=0)


def test_pw_run_mesh_activates_backend_for_the_run():
    """pw.run(mesh=...) arms the backend for exactly the run, on the held
    mesh, while engine.mesh stays the lint-facing spec dict."""
    from pathway_tpu_torch.internals.runner import last_engine

    tpw.G.clear()
    seen = []
    try:
        t = tpw.debug.table_from_rows(tpw.schema_from_types(k=str), [("a",)])
        tpw.io.subscribe(
            t.select(k=t.k),
            on_change=lambda key, row, time, is_addition: seen.append(
                (row, mesh_backend.active_backend())
            ),
        )
        with with_mesh(_cpu_mesh()):
            tpw.run(mesh="dp=4,tp=2", monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        tpw.G.clear()
    assert [row for row, _ in seen] == [{"k": "a"}]
    backend = seen[0][1]
    assert backend is not None and (backend.dp, backend.tp) == (4, 2)
    assert last_engine().mesh == {"dp": 4, "tp": 2}
    assert mesh_backend.active_backend() is None


def test_status_mesh_key_live_and_lint_only():
    from pathway_tpu_torch.internals.monitoring import PrometheusServer
    from pathway_tpu_torch.internals.runner import last_engine

    tpw.G.clear()
    try:
        t = tpw.debug.table_from_rows(tpw.schema_from_types(k=str), [("a",)])
        tpw.io.subscribe(t, on_change=lambda *a, **k: None)
        with with_mesh(_cpu_mesh()):
            tpw.run(mesh="dp=4,tp=2", monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        tpw.G.clear()
    engine = last_engine()
    status = PrometheusServer(engine).status_json()
    assert status["mesh"] == {"active": False, "axes": {"dp": 4, "tp": 2}}
    with _activated("dp=4,tp=2") as (backend, jbackend):
        backend.note_replica_degraded(2)
        live = PrometheusServer(engine).status_json()["mesh"]
        assert live["active"] is True and live["axes"] == {"dp": 4, "tp": 2}
        assert live["device_count"] == 8 and live["sharded_ingest"] is True
        assert live["degraded_replicas"] == [2] and len(live["replicas"]) == 4
        for r, gauges in enumerate(live["replicas"]):
            assert gauges["replica"] == r
            assert set(gauges) >= {"rows", "in_flight", "occupancy"}
        assert set(live) == set(jbackend.status())


def test_degraded_mesh_device_flap_drains_and_falls_back():
    """A device_flap while the dp=4 backend is mid-ingest drains the
    in-flight window and routes new ingest through the synchronous path:
    every doc lands exactly once and stays searchable, then the mesh
    ingest resumes."""
    from pathway_tpu_torch.internals import device_probe, faults
    from pathway_tpu_torch.internals.device_probe import DeviceMonitor
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    _jenc, penc = _encoders("mesh-flap-tiny")
    texts = [f"alpha doc{i} bravo charlie" for i in range(24)]
    monitor = DeviceMonitor(interval_s=1.0, probe=lambda _t: (0.5, None))
    old = device_probe._monitor
    device_probe._monitor = monitor
    faults.install("device_flap@probes=1")
    try:
        with _activated("dp=4,tp=2") as (backend, _j), _env(
            PATHWAY_DEVICE_PIPELINE="1", PATHWAY_INGEST_CHUNK="8"
        ):
            impl = _FusedKnnIndexImpl(penc, "cos", 64)
            assert impl.knn.mesh is backend.mesh
            impl.add_many(range(12), texts[:12], [None] * 12)
            pipe = impl._pipeline
            assert pipe is not None
            assert monitor.probe_once()["state"] == "degraded"
            assert device_probe.device_degraded()
            backend.note_replica_degraded(1)
            impl.add_many(range(12, 24), texts[12:], [None] * 12)
            stats = pipe.stats()
            assert stats["dispatched"] == stats["submitted"] and stats["in_flight"] == 0
            assert not impl._pipeline_broken
            assert len(impl.knn) == 24
            rows = impl.search_many([texts[0], texts[23]], [1, 1], [None, None])
            assert rows[0][0][0] == 0 and rows[1][0][0] == 23
            assert monitor.probe_once()["state"] == "healthy"
            backend.note_replicas_healthy()
            assert impl._use_pipeline() and backend.status()["degraded_replicas"] == []
    finally:
        device_probe._monitor = old
        faults.clear()


def test_vector_index_adopts_the_backend_and_refuses_a_contradicting_device():
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _KnnIndexImpl

    with _activated("dp=4,tp=2") as (backend, _j):
        impl = _KnnIndexImpl(8, "cos", 16)
        assert impl.knn.mesh is backend.mesh and impl._host_vecs == {}
        with pytest.raises(ValueError, match="contradicts the mesh"):
            _KnnIndexImpl(8, "cos", 16, device="meta")
    rng = np.random.default_rng(2)
    vecs = _unit(rng, 12, 8)
    for key, vec in enumerate(vecs):
        impl.add(key, vec, None)
    rows = impl.search_many(list(vecs[:3]), [2] * 3, [None] * 3)
    assert [r[0][0] for r in rows] == [0, 1, 2]


def test_fused_index_under_a_factory_mesh_keeps_classic_ingest():
    """A factory-attached mesh without a backend: the classic dispatch,
    unsharded encoder, sharded index (the multichip retrieval check's
    configuration), as in the JAX package."""
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    _jenc, penc = _encoders("factory-mesh-tiny")
    impl = _FusedKnnIndexImpl(penc, "cos", 16, mesh=_cpu_mesh((4,), ("knn",)))
    assert impl.fused.backend is None and not impl._use_pipeline()
    payload, _meta = impl.fused.prepare_batch([1, 2], ["a b", "c d"])
    assert payload[0] == "classic"
