"""The port's DeviceKnnIndex and FusedEmbedSearch against the JAX objects.

Same vectors / texts and the same encoder weights (bridged with
models/convert.py) go through both packages on the CPU; results must give
the same keys, with scores within atol 1e-4. On the CPU the port's search
takes the kernel branch with the knn_topk wrapper's plain version; the JAX
package's CPU search is its dense path.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pathway_tpu.models import transformer as jax_tf
from pathway_tpu.models.minilm import SentenceEncoder as JaxSentenceEncoder
from pathway_tpu.ops import knn as jax_knn
from pathway_tpu_torch.models import transformer as port_tf
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.models.minilm import SentenceEncoder
from pathway_tpu_torch.ops import knn as port_knn
from pathway_tpu_torch.ops.kernels.knn_topk import grid as knn_grid

D = 16


def _assert_rows_match(got, want, atol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [k for k, _ in g] == [k for k, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=atol, rtol=0)


def _pair(metric, reserved=8):
    return (
        jax_knn.DeviceKnnIndex(D, metric=metric, reserved_space=reserved),
        port_knn.DeviceKnnIndex(D, metric=metric, reserved_space=reserved, device="cpu"),
    )


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_index_add_remove_grow_search_matches_jax(metric):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((40, D)).astype(np.float32)
    j, p = _pair(metric)
    for i in range(20):  # one by one, growing past the reserved 8 slots
        j.add(i, data[i])
        p.add(i, data[i])
    j.add_batch(range(20, 40), data[20:])
    p.add_batch(range(20, 40), data[20:])
    for key in (3, 17, 25):
        j.remove(key)
        p.remove(key)
    fresh = rng.standard_normal(D).astype(np.float32)
    j.add(3, fresh)  # re-add into a freed slot
    p.add(3, fresh)
    assert p.capacity == j.capacity == 64 and len(p) == len(j) == 38
    queries = data[:5] + 0.05 * rng.standard_normal((5, D)).astype(np.float32)
    for k in (1, 4, 40):
        _assert_rows_match(p.search_keys(queries, k), j.search_keys(queries, k))
    # single query, 1-D
    _assert_rows_match(p.search_keys(queries[0], 3), j.search_keys(queries[0], 3))


@pytest.mark.parametrize("d", [2, 3, 6])
@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_index_at_any_dimensions_matches_jax(metric, d):
    """The buffer keeps its rows padded to 4 columns for the kernel; the
    accessors and the scores are those of the true d."""
    rng = np.random.default_rng(d)
    data = rng.standard_normal((30, d)).astype(np.float32)
    j = jax_knn.DeviceKnnIndex(d, metric=metric, reserved_space=8)
    p = port_knn.DeviceKnnIndex(d, metric=metric, reserved_space=8, device="cpu")
    for idx in (j, p):
        for i in range(10):
            idx.add(i, data[i])
        idx.add_batch(range(10, 30), data[10:])
        idx.remove(4)
    p.add_batch([30, 31], torch.from_numpy(data[:2] * 2.0))
    j.add_batch([30, 31], data[:2] * 2.0)
    assert tuple(p.device_buffer.shape) == (p.capacity, d)
    np.testing.assert_allclose(
        p.device_buffer.numpy(), np.asarray(j.device_buffer), atol=1e-6
    )
    queries = data[:4] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    got_s, _, _ = p.search(queries, 3)
    want_s, _, _ = j.search(queries, 3)
    np.testing.assert_allclose(np.sort(got_s, 1), np.sort(np.asarray(want_s), 1), atol=1e-4)


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_index_search_raw_contract(metric):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((10, D)).astype(np.float32)
    j, p = _pair(metric, reserved=16)
    j.add_batch(range(10), data)
    p.add_batch(range(10), data)
    js, ji, jmap = j.search(data[:3], 12)  # k > live rows: dead slots show as -inf
    ps, pi, pmap = p.search(data[:3], 12)
    assert ps.shape == js.shape == (3, 12) and ps.dtype == np.float32
    assert pmap == jmap
    live = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ps), live)
    np.testing.assert_allclose(np.sort(ps[live]), np.sort(js[live]), atol=1e-4)
    empty_s, empty_i, _ = port_knn.DeviceKnnIndex(D, device="cpu").search(data[:2], 3)
    assert empty_s.shape == (2, 0) and empty_i.shape == (2, 0)


def test_index_add_batch_from_tensor_and_dense_k_above_kernel_limit():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((200, D)).astype(np.float32)
    j, p = _pair("cos", reserved=64)
    j.add_batch(range(200), jnp.asarray(data))  # device arrays on both sides
    p.add_batch(range(200), torch.from_numpy(data))
    assert p.capacity == 256
    _assert_rows_match(p.search_keys(data[:4], 150), j.search_keys(data[:4], 150))
    np.testing.assert_allclose(
        p.device_buffer.numpy(), np.asarray(j.device_buffer), atol=1e-6
    )
    np.testing.assert_array_equal(p.device_valid.numpy(), np.asarray(j.device_valid))


def test_index_rejects_wrong_dimension_and_metric():
    p = port_knn.DeviceKnnIndex(D, device="cpu")
    with pytest.raises(ValueError):
        p.add("x", np.zeros(D + 1))
    with pytest.raises(ValueError):
        port_knn.DeviceKnnIndex(D, metric="hamming", device="cpu")


def _encoders():
    jc = jax_tf.TransformerConfig(
        vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64,
        dtype="float32",
    )
    pc = port_tf.TransformerConfig(**dataclasses.asdict(jc))
    jenc = JaxSentenceEncoder("fused-test", config=jc, max_len=64, seed=3)
    penc = SentenceEncoder("fused-test", config=pc, max_len=64, device="cpu")
    penc.lm = port_tf.TransformerLM(
        pc, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jenc.lm.params)),
        device="cpu",
    )
    return jenc, penc


DOCS = [f"document {i} about " + " ".join(["stream", "table", "vector", "query"][: 1 + i % 4]) for i in range(24)]


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_fused_embed_and_add_and_search_texts_match_jax(metric):
    jenc, penc = _encoders()
    jf = jax_knn.FusedEmbedSearch(jenc, jax_knn.DeviceKnnIndex(64, metric=metric, reserved_space=16))
    pf = port_knn.FusedEmbedSearch(
        penc, port_knn.DeviceKnnIndex(64, metric=metric, reserved_space=16, device="cpu"),
        device="cpu",
    )
    assert pf.search_texts(["nothing yet"], 3) == [[]]
    jf.embed_and_add(range(24), DOCS)
    pf.embed_and_add(range(24), DOCS)
    queries = [DOCS[5], DOCS[17], "something else entirely"]
    got = pf.search_texts(queries, 4)
    _assert_rows_match(got, jf.search_texts(queries, 4))
    assert got[0][0][0] == 5 and got[1][0][0] == 17
    # the kernel-backed index search agrees with the fused dense search
    _assert_rows_match(pf.index.search_keys(penc.encode(queries), 4), got)


def test_fused_packed_prepare_dispatch_matches_jax():
    jenc, penc = _encoders()
    jf = jax_knn.FusedEmbedSearch(jenc, jax_knn.DeviceKnnIndex(64, reserved_space=16))
    pf = port_knn.FusedEmbedSearch(
        penc, port_knn.DeviceKnnIndex(64, reserved_space=16, device="cpu"), device="cpu"
    )
    keys = [f"k{i}" for i in range(24)]
    jpayload, jmeta = jf.prepare_batch(keys, DOCS)
    ppayload, pmeta = pf.prepare_batch(keys, DOCS)
    assert ppayload[0] == jpayload[0] == "packed"
    assert pmeta == jmeta
    emb_j = np.asarray(jf.dispatch_batch(jpayload))
    emb_p = pf.dispatch_batch(ppayload)
    assert emb_p.shape == (24, 64)
    np.testing.assert_allclose(emb_p.numpy(), emb_j, atol=1e-4, rtol=0)
    queries = [DOCS[2], DOCS[11]]
    _assert_rows_match(pf.search_texts(queries, 5), jf.search_texts(queries, 5))
    # classic prepare when packing is off
    payload, meta = pf.prepare_batch(keys, DOCS, pack=False)
    assert payload[0] == "classic" and meta["rows"] == 24


def test_fused_prepare_of_docs_past_the_flash_gate_takes_the_classic_path():
    """On the card, a batch holding a doc longer than the flash gate takes
    the classic path, whose masked attention takes the flash kernel:
    packed slabs would attend densely ([rows, heads, L, L] scores, which
    exhausted the card's memory at 4,096 chunks of 300-450 tokens). The
    texts are tokenized once, and the classic payload is encode_batch's.
    On the CPU, where no flash runs, the port packs as the JAX package
    does. prepare_batch is host work: an index on the CPU stands in for
    the card's by its device. The embeddings of every payload agree with
    the JAX package's."""
    from pathway_tpu_torch.models.tokenizer import encode_batch
    from pathway_tpu_torch.models.transformer import FLASH_MIN_LEN

    cfg = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=512,
               dtype="float32")
    jc = jax_tf.TransformerConfig(**cfg)
    pc = port_tf.TransformerConfig(**cfg)
    jenc = JaxSentenceEncoder("fused-long-test", config=jc, max_len=512, seed=3)
    penc = SentenceEncoder("fused-long-test", config=pc, max_len=512, device="cpu")
    penc.lm = port_tf.TransformerLM(
        pc, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jenc.lm.params)),
        device="cpu",
    )
    jf = jax_knn.FusedEmbedSearch(jenc, jax_knn.DeviceKnnIndex(64, reserved_space=16))
    pf = port_knn.FusedEmbedSearch(
        penc, port_knn.DeviceKnnIndex(64, reserved_space=16, device="cpu"), device="cpu"
    )
    words = ["stream", "table", "vector", "query", "index", "kernel"]
    docs = [" ".join(words[(i + j) % 6] for j in range(20 + 140 * i)) + f" doc{i}" for i in range(4)]
    keys = [f"k{i}" for i in range(4)]
    jpayload, _ = jf.prepare_batch(keys, docs)
    assert jpayload[0] == "packed" and jpayload[2].shape[1] > FLASH_MIN_LEN
    emb_j = np.asarray(jf.dispatch_batch(jpayload))
    on_cpu, _ = pf.prepare_batch(keys, docs)
    assert on_cpu[0] == "packed"
    np.testing.assert_array_equal(on_cpu[2], jpayload[2])

    encodes = []
    tokenizer = penc.tokenizer
    plain_encode = tokenizer.encode
    tokenizer.encode = lambda text, max_len=None: encodes.append(text) or plain_encode(text, max_len)
    pf.device = torch.device("cuda")
    try:
        on_card, meta = pf.prepare_batch(keys, docs)
        short = pf.prepare_batch(keys, [d[:200] for d in docs])[0]
    finally:
        pf.device = torch.device("cpu")
        tokenizer.encode = plain_encode
    assert on_card[0] == "classic" and meta["rows"] == 4
    assert len(encodes) == 2 * len(docs)  # once a text, for either path
    ids, mask = encode_batch(tokenizer, docs, max_len=512)
    np.testing.assert_array_equal(on_card[2], ids)
    np.testing.assert_array_equal(on_card[3], mask)
    assert meta["real_tokens"] == int(mask.sum())
    # docs within the gate still pack on the card
    assert short[0] == "packed"
    for payload in (on_cpu, on_card):
        emb_p = pf.dispatch_batch(payload)
        np.testing.assert_allclose(emb_p.numpy(), emb_j, atol=1e-4, rtol=0)


def test_fused_rejects_encoder_and_index_on_two_devices():
    _, penc = _encoders()
    index = port_knn.DeviceKnnIndex(64, device="meta")
    with pytest.raises(ValueError, match="encoder on"):
        port_knn.FusedEmbedSearch(penc, index, device="cpu")


@pytest.mark.parametrize(
    "n, slots, want",
    [
        (1 << 20, 132, (63, 131)),  # the main path's index, one block per SM
        (1 << 20, 114, (72, 114)),  # a card with fewer SMs
        (70001, 132, (5, 110)),  # ragged last tile
        (1000, 132, (1, 8)),  # fewer tiles than SMs
        (5, 132, (1, 1)),
    ],
)
def test_knn_kernel_grid_covers_every_tile_once(n, slots, want):
    tiles_per_block, blocks = knn_grid(n, slots)
    assert (tiles_per_block, blocks) == want
    ntiles = -(-n // 128)
    assert blocks <= slots
    assert (blocks - 1) * tiles_per_block < ntiles <= blocks * tiles_per_block  # none empty


def test_hooks_match_jax_memtrack_serving_qtrace():
    """The port's index and fused search call memtrack, serving and qtrace
    where the JAX package does: the same registered bytes (index rows at
    capacity, encoder params) and ingest forecast, one result-cache
    generation bump per add / add_batch and one cluster bump per remove,
    and one qtrace device window per search_texts."""
    from pathway_tpu.internals import memtrack as jax_memtrack
    from pathway_tpu.internals import qtrace as jax_qtrace
    from pathway_tpu.internals import serving as jax_serving
    from pathway_tpu_torch.internals import memtrack as port_memtrack
    from pathway_tpu_torch.internals import qtrace as port_qtrace
    from pathway_tpu_torch.internals import serving as port_serving

    jenc, penc = _encoders()
    trackers, tiers, windows = [], [], []
    for memtrack, serving, qtrace in (
        (jax_memtrack, jax_serving, jax_qtrace),
        (port_memtrack, port_serving, port_qtrace),
    ):
        trackers.append(memtrack.reset_for_tests())
        tiers.append(serving.reset_for_tests())
        windows.append(len(qtrace.tracker()._device_window))
    try:
        jf = jax_knn.FusedEmbedSearch(jenc, jax_knn.DeviceKnnIndex(64, reserved_space=8))
        pf = port_knn.FusedEmbedSearch(
            penc, port_knn.DeviceKnnIndex(64, reserved_space=8, device="cpu"), device="cpu"
        )
        for f in (jf, pf):
            f.embed_and_add(range(12), DOCS[:12])  # add_batch, grows 8 -> 16
            f.index.add("extra", np.ones(64, dtype=np.float32))
            f.index.remove(3)
            f.search_texts(DOCS[:2], 3)
        snaps = [t.snapshot()["components"] for t in trackers]
        for comp in ("knn_index", "encoder_params"):
            assert snaps[1][comp]["bytes"] == snaps[0][comp]["bytes"], comp
        assert snaps[1]["knn_index"]["bytes"] == 16 * (4 * 64 + 1)
        notes = [[(docs, nbytes) for _t, docs, nbytes in t._deltas] for t in trackers]
        assert notes[1] == notes[0] == [(12, 12 * (4 * 64 + 1)), (1, 4 * 64 + 1)]
        gens = [(t.cache.gen_global, list(t.cache.cluster_gens)) for t in tiers]
        assert gens[1] == gens[0] and gens[1][0] == 2
        grew = [len(q.tracker()._device_window) - w for q, w in zip((jax_qtrace, port_qtrace), windows)]
        assert grew == [1, 1]
    finally:
        jax_serving.shutdown()
        port_serving.shutdown()
        jax_memtrack.reset_for_tests()
        port_memtrack.reset_for_tests()
