"""The port's CUDA kernels and entry points on the card, at edge shapes.

These tests need an NVIDIA card and nvcc; on a machine without CUDA they
skip. They import neither JAX nor the JAX package: the card's machine has
no JAX, and the CPU tests (tests/test_torch_*.py) already hold the plain
versions against the JAX package. Here each kernel is held against its
plain version on the same CUDA tensors, at shapes the main path does not
reach (ragged N and D, several query groups, k = N, fewer live slots than
k, duplicated rows, every slot dead, Lq != Lk, every head dim, and head
dims and index widths that only padding makes fit). Run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports JAX.)

Tolerances: knn scores atol 1e-4 plus rtol 1e-5 (f32 sums in another
order than cuBLAS; unnormalised l2sq scores reach |s| ~ 300);
flash atol 1e-4 in f32 and 2e-2 in bf16 (about one bf16 ulp at |o| in
[2, 4)), on rows with at least one live key; fully masked rows only need
to be finite. Encoder: f32 atol 1e-4, bf16 per-row cosine >= 0.999.
Decoder (head dims 128 and 256): f32 logits atol 1e-4 and the same greedy
tokens, bf16 per-position logit cosine >= 0.999.
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import decoder as dec
from pathway_tpu_torch.models.minilm import SentenceEncoder
from pathway_tpu_torch.models.transformer import TransformerConfig
from pathway_tpu_torch.ops import kernels
from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention
from pathway_tpu_torch.ops.kernels.knn_topk import reference_knn_topk
from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _knn_case(n, d, qn, dead, metric, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    if metric == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) >= dead
    return x, valid, q


@pytest.mark.parametrize(
    "n, d, qn, k, metric, dead",
    [
        (1000, 24, 3, 1, "ip", 0.1),  # ragged last tile, D not a multiple of 32
        (4096, 384, 100, 6, "cos", 0.01),  # two query groups of 64
        (128, 32, 8, 128, "l2sq", 0.0),  # k = N
        (70000, 384, 64, 128, "l2sq", 0.01),
        (333, 16, 1, 40, "ip", 0.95),  # fewer live slots than k
        (1000, 20, 5, 6, "ip", 0.1),  # D % 8 == 4: the last tf32 k-step half zeros
        (50000, 384, 1, 1, "cos", 0.01),  # Q = 1, k = 1
        (50000, 384, 16, 24, "l2sq", 0.0),  # unnormalised, |s| ~ 400
        (70001, 64, 64, 128, "ip", 0.01),  # N % 128 != 0 at k = 128, Q = 64
    ],
)
def test_knn_topk_kernel_matches_plain(card, n, d, qn, k, metric, dead):
    x, valid, q = _knn_case(n, d, qn, dead, metric, seed=n + qn)
    xt, vt, qt = (torch.from_numpy(a).to(card) for a in (x, valid, q))
    before = kernels.knn_topk.launches
    ks, ki = kernels.knn_topk(xt, vt, qt, k, metric=metric)
    torch.cuda.synchronize()
    assert kernels.knn_topk.launches == before + 1
    ps, pi = reference_knn_topk(xt, vt, qt, k, metric=metric)
    assert ks.shape == ki.shape == (qn, k)
    assert ks.dtype == torch.float32 and ki.dtype == torch.int32
    ks, ki, ps, pi = (t.cpu().numpy() for t in (ks, ki, ps, pi))
    live = ps > -1e29
    np.testing.assert_array_equal(ks > -1e29, live)
    np.testing.assert_allclose(np.sort(ks[live]), np.sort(ps[live]), atol=1e-4, rtol=1e-5)
    # ties order by slot in the kernel, so compare the live slots as sets,
    # allowing a swap only where the plain k-th score is a near-tie
    for r in range(qn):
        a, b = set(ki[r][live[r]].tolist()), set(pi[r][live[r]].tolist())
        if a != b:
            kth = ps[r][live[r]].min()
            swapped = [s for s, i in zip(ks[r], ki[r]) if i in a - b]
            assert all(abs(s - kth) <= 1e-5 * max(1.0, abs(kth)) for s in swapped), r
    assert valid[ki[live]].all()
    # dead slots fill in only when fewer than k slots are live
    assert (~live).any() == (valid.sum() < k)


def test_knn_topk_kernel_ties_go_to_the_lower_slot(card):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((700, 48)).astype(np.float32)
    x = np.concatenate([base, base, base])  # slots i, i + 700, i + 1400 alike
    q = base[rng.choice(700, 9, replace=False)]
    q += 0.3 * rng.standard_normal(q.shape).astype(np.float32)
    xt, qt = torch.from_numpy(x).to(card), torch.from_numpy(q).to(card)
    vt = torch.ones((len(x),), dtype=torch.bool, device=card)
    ks, ki = kernels.knn_topk(xt, vt, qt, 16, metric="ip")
    ps, _ = reference_knn_topk(xt, vt, qt, 16, metric="ip")
    ks, ki, ps = (t.cpu().numpy() for t in (ks, ki, ps))
    np.testing.assert_allclose(ks, ps, atol=1e-4, rtol=1e-5)
    for r in range(len(q)):
        for a in range(15):  # score descending, then slot ascending
            assert ks[r, a] > ks[r, a + 1] or (ks[r, a] == ks[r, a + 1] and ki[r, a] < ki[r, a + 1])
        got = set(ki[r].tolist())
        for slot in got:  # a copy is taken only after every lower copy
            assert all(slot % 700 + 700 * c in got for c in range(slot // 700)), (r, slot)


@pytest.mark.parametrize("metric", ["ip", "l2sq"])
def test_knn_topk_kernel_every_slot_dead(card, metric):
    x, _, q = _knn_case(3000, 40, 4, 0.0, metric, seed=3)
    xt, qt = torch.from_numpy(x).to(card), torch.from_numpy(q).to(card)
    vt = torch.zeros((len(x),), dtype=torch.bool, device=card)
    ks, ki = kernels.knn_topk(xt, vt, qt, 10, metric=metric)
    ps, _ = reference_knn_topk(xt, vt, qt, 10, metric=metric)
    # s - 1e30 rounds to -1e30 in f32, so every slot ties and the lowest win
    assert (ks.cpu() == ps.cpu()).all() and (ps.cpu() == np.float32(-1e30)).all()
    assert (ki.cpu() == torch.arange(10, dtype=torch.int32)).all()


def test_knn_topk_kernel_rejects_what_it_does_not_take(card):
    x = torch.zeros((256, 32), device=card)
    v = torch.ones((256,), dtype=torch.bool, device=card)
    q = torch.zeros((4, 32), device=card)
    with pytest.raises(TypeError):
        kernels.knn_topk(x.double(), v, q.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.knn_topk(torch.zeros((32, 256), device=card).T, v, q, 3)
    with pytest.raises(ValueError, match="k"):
        kernels.knn_topk(x, v, q, 129)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.knn_topk(x[:, :30].contiguous(), v, q[:, :30].contiguous(), 3)
    with pytest.raises(ValueError, match="aligned"):
        kernels.knn_topk(torch.zeros(256 * 32 + 1, device=card)[1:].view(256, 32), v, q, 3)


def _flash_case(b, h, lq, lk, d, dtype, seed, card):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (
        torch.randn((b, h, n, d), device=card, generator=g).to(dtype) for n in (lq, lk, lk)
    )
    lens = torch.randint(1, lk + 1, (b,), device=card, generator=g)
    mask = (torch.arange(lk, device=card)[None, :] < lens[:, None]).to(torch.int32)
    if b > 1:
        mask[-1] = 0  # a fully masked batch row, as encode_batch's pad rows
    return q, k, v, mask


@pytest.mark.parametrize(
    "b, h, lq, lk, d, dtype, causal",
    [
        (2, 3, 77, 77, 16, torch.float32, False),
        (2, 3, 77, 77, 64, torch.float32, True),
        (1, 2, 40, 130, 32, torch.float32, False),  # Lq != Lk
        (3, 2, 300, 300, 32, torch.bfloat16, False),
        (2, 12, 512, 512, 32, torch.bfloat16, True),
        (4, 12, 512, 512, 32, torch.bfloat16, False),  # the encoder's shape
        (2, 3, 77, 77, 16, torch.bfloat16, False),  # 32-byte swizzle
        (2, 3, 77, 77, 64, torch.bfloat16, True),  # 128-byte swizzle
        (1, 2, 40, 130, 32, torch.bfloat16, False),  # Lq != Lk, rows past Lq
        (2, 3, 300, 300, 32, torch.bfloat16, True),  # Lq not a multiple of 128
        (64, 12, 64, 64, 32, torch.bfloat16, False),  # the ingest shape
        # head dim 128 (the decoder's prefill): two 64-column parts a tile
        (2, 4, 200, 200, 128, torch.bfloat16, True),
        (2, 4, 200, 200, 128, torch.bfloat16, False),
        (2, 2, 1000, 1000, 128, torch.bfloat16, True),
        (2, 2, 1, 77, 128, torch.bfloat16, False),  # Lq = 1, Lk % 64 != 0
        (2, 2, 1, 1000, 128, torch.bfloat16, True),  # one row, one causal key
        (2, 3, 130, 301, 128, torch.bfloat16, False),  # Lq != Lk
        (2, 4, 200, 200, 128, torch.float32, True),
        (2, 2, 1000, 1000, 128, torch.float32, False),
        (2, 2, 1, 77, 128, torch.float32, False),
        (2, 3, 130, 301, 128, torch.float32, True),
        (1, 2, 300, 300, 128, torch.float32, False),  # one batch row, every key live
        # head dims without a kernel instance: zero-padded to the next one
        (2, 3, 77, 77, 24, torch.bfloat16, False),
        (2, 3, 300, 300, 24, torch.float32, True),
        (2, 4, 200, 200, 48, torch.bfloat16, True),
        (2, 3, 77, 77, 48, torch.float32, False),
        (2, 4, 300, 300, 80, torch.bfloat16, False),
        (2, 2, 130, 301, 80, torch.float32, True),
        # the ping-pong instances at 128: rows only in the first warpgroup
        (1, 2, 40, 130, 128, torch.bfloat16, True),
        (2, 2, 65, 65, 128, torch.bfloat16, True),  # one row in the second
        # head dim 256: bf16 on the tensor cores (four 64-column parts, a
        # two-stage ring), f32 one warp per query row; 160 / 200 padded
        (2, 4, 300, 300, 256, torch.bfloat16, True),
        (2, 4, 300, 300, 256, torch.bfloat16, False),
        (2, 2, 1, 77, 256, torch.bfloat16, False),  # Lq = 1
        (2, 2, 1, 1000, 256, torch.bfloat16, True),  # one row, one causal key
        (2, 2, 1000, 1000, 256, torch.bfloat16, True),
        (2, 2, 1000, 1000, 256, torch.bfloat16, False),
        (2, 3, 130, 301, 256, torch.bfloat16, True),  # Lq != Lk
        (2, 3, 130, 301, 256, torch.bfloat16, False),
        (2, 3, 77, 77, 256, torch.bfloat16, True),  # a single partial tile
        (2, 2, 64, 64, 256, torch.bfloat16, True),  # no row in the second warpgroup
        (1, 4, 2048, 2048, 256, torch.bfloat16, True),  # the ring wraps 16 times
        (1, 2, 128, 4096, 256, torch.bfloat16, False),  # and 32 times
        (2, 4, 300, 300, 256, torch.float32, True),
        (2, 2, 130, 301, 256, torch.float32, False),
        (2, 2, 1, 77, 256, torch.float32, True),
        (2, 4, 200, 200, 160, torch.bfloat16, True),
        (2, 3, 77, 77, 160, torch.bfloat16, False),
        (2, 3, 130, 301, 160, torch.float32, False),
        (2, 4, 200, 200, 200, torch.bfloat16, False),
        (2, 3, 300, 300, 200, torch.bfloat16, True),
        (2, 2, 200, 200, 200, torch.float32, True),
    ],
)
def test_flash_kernel_matches_plain(card, b, h, lq, lk, d, dtype, causal):
    q, k, v, mask = _flash_case(b, h, lq, lk, d, dtype, seed=lq + d, card=card)
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    ref = reference_attention(q, k, v, mask, d ** -0.5, causal)
    live = mask.sum(dim=1) > 0
    err = (out.float()[live] - ref.float()[live]).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize(
    "b, h, l, d",
    [(8, 32, 1000, 128), (8, 4, 1000, 256)],  # the decoder prefill's heads; heads of 256
)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_ragged_rows_down_to_one_live_key(card, b, h, l, d, causal):
    """Batch rows of 1, 2, 63, 64, 65, 127, 999 and all live keys: a
    tile's mask addends, a partial last tile and rows whose only live key
    is the first, with and without the causal mask. Rows of one or two
    live keys output v itself, up to |o| ~ 5, where one bf16 ulp is 2^-5,
    so the bound is 2e-2 of max(1, |o|): the table's 2e-2 below |o| = 1,
    and about one ulp above."""
    g = torch.Generator(device=card).manual_seed(d + int(causal))
    q, k, v = (torch.randn((b, h, l, d), device=card, generator=g).bfloat16() for _ in range(3))
    lens = torch.tensor([1, 2, 63, 64, 65, 127, l - 1, l], device=card)[:b]
    mask = (torch.arange(l, device=card)[None, :] < lens[:, None]).to(torch.int32)
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    ref = reference_attention(q, k, v, mask, d ** -0.5, causal).float()
    err = ((out.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    assert err <= 2e-2, err


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 8, 257), device=card)  # above the largest instance
    with pytest.raises(ValueError, match="head dim"):
        kernels.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), device=card)
    with pytest.raises(TypeError):
        kernels.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)


def _small_config(dtype):
    return TransformerConfig(
        vocab_size=512, hidden=64, layers=2, heads=2, mlp_dim=128, max_len=512, dtype=dtype
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_on_card_matches_cpu_and_takes_flash_past_256(card, dtype):
    docs = [" ".join(f"w{(i * 7 + j) % 97}" for j in range(300 + 20 * i)) for i in range(5)]
    docs += ["a short one", ""]
    gpu = SentenceEncoder("cuda-test", config=_small_config(dtype), max_len=512, device=card)
    cpu = SentenceEncoder("cuda-test", config=_small_config(dtype), max_len=512, device="cpu")
    before = kernels.flash_attention.launches
    got = gpu.encode(docs)
    assert kernels.flash_attention.launches == before + 2  # one per layer at L = 512
    want = cpu.encode(docs)
    assert got.shape == want.shape == (len(docs), 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        cos = (got * want).sum(-1) / (
            np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1) + 1e-12
        )
        assert cos.min() >= 0.999
    dense = gpu.lm(*_ids(gpu, docs), use_flash=False)[: len(docs)].cpu().numpy()
    np.testing.assert_allclose(got, dense, atol=2e-2 if dtype == "bfloat16" else 1e-4, rtol=0)


def _ids(encoder, docs):
    from pathway_tpu_torch.models.tokenizer import encode_batch

    return encode_batch(encoder.tokenizer, docs, max_len=encoder.max_len)


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_index_on_card_matches_cpu(card, metric):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((300, 32)).astype(np.float32)
    got_idx = DeviceKnnIndex(32, metric=metric, reserved_space=64, device=card)
    want_idx = DeviceKnnIndex(32, metric=metric, reserved_space=64, device="cpu")
    for idx, vecs in ((got_idx, torch.from_numpy(data[100:]).to(card)), (want_idx, data[100:])):
        for i in range(100):
            idx.add(i, data[i])
        idx.add_batch(range(100, 300), vecs)
        for key in (4, 150, 299):
            idx.remove(key)
    assert got_idx.capacity == want_idx.capacity == 512
    before = kernels.knn_topk.launches
    queries = data[:7] + 0.01 * rng.standard_normal((7, 32)).astype(np.float32)
    got = got_idx.search_keys(queries, 5)
    assert kernels.knn_topk.launches == before + 1
    want = want_idx.search_keys(queries, 5)
    for g, w in zip(got, want):
        assert [key for key, _ in g] == [key for key, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4, rtol=0)


def test_vector_impl_on_card_refuses_the_host_path_when_degraded(card, monkeypatch):
    """The framework's vector impl on the card keeps no host mirror; a
    degraded monitor makes its search raise, and once re-promoted the
    search launches knn_topk."""
    from pathway_tpu_torch.internals import device_probe
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        DeviceDegradedError,
        _KnnIndexImpl,
    )

    data = np.random.default_rng(9).standard_normal((50, 16)).astype(np.float32)
    impl = _KnnIndexImpl(16, "cos", 64, device=card)
    assert impl._host_vecs is None and impl.knn.device.type == "cuda"
    for i, v in enumerate(data):
        impl.add(i, v, None)
    monitor = device_probe.DeviceMonitor(probe=lambda timeout_s: (None, "down"))
    monitor.probe_once()
    monkeypatch.setattr(device_probe, "_monitor", monitor)
    before = kernels.knn_topk.launches
    with pytest.raises(DeviceDegradedError):
        impl.search_many([data[3]], [3], [None])
    assert kernels.knn_topk.launches == before
    monitor.probe = lambda timeout_s: (1.0, None)
    monitor.probe_once()
    (row,) = impl.search_many([data[3]], [3], [None])
    assert row[0][0] == 3 and kernels.knn_topk.launches == before + 1


@pytest.mark.parametrize("d", [2, 3, 6])
@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_index_on_card_takes_any_dimensions(card, metric, d):
    # the buffer is padded to 4 columns for the kernel; the framework's own
    # index tests build dimensions=2
    rng = np.random.default_rng(d)
    data = rng.standard_normal((200, d)).astype(np.float32)
    got_idx = DeviceKnnIndex(d, metric=metric, reserved_space=16, device=card)
    want_idx = DeviceKnnIndex(d, metric=metric, reserved_space=16, device="cpu")
    for idx, vecs in ((got_idx, torch.from_numpy(data[50:]).to(card)), (want_idx, data[50:])):
        for i in range(50):
            idx.add(i, data[i])
        idx.add_batch(range(50, 200), vecs)
        idx.remove(7)
    assert got_idx.device_buffer.shape == (256, d)
    # the two add paths assign slots in different orders: compare by key
    keys = [k for k in range(200) if k != 7]
    got_rows, want_rows = (
        idx.device_buffer[[idx._slot_of_key[k] for k in keys]] for idx in (got_idx, want_idx)
    )
    np.testing.assert_allclose(got_rows.cpu().numpy(), want_rows.numpy(), atol=1e-6)
    before = kernels.knn_topk.launches
    queries = data[:5] + 0.01 * rng.standard_normal((5, d)).astype(np.float32)
    got = got_idx.search(queries, 4)
    assert kernels.knn_topk.launches == before + 1
    want = want_idx.search(queries, 4)
    np.testing.assert_allclose(
        np.sort(got[0], axis=1), np.sort(want[0], axis=1), atol=1e-4, rtol=1e-5
    )


def test_encoder_at_head_dim_48_takes_flash(card):
    # a checkpoint's head dim need not have a kernel instance: 96 / 2 = 48
    config = TransformerConfig(
        vocab_size=512, hidden=96, layers=1, heads=2, mlp_dim=128, max_len=512, dtype="float32"
    )
    docs = [" ".join(f"w{(i * 5 + j) % 89}" for j in range(400)) for i in range(3)]
    gpu = SentenceEncoder("hd48", config=config, max_len=512, device=card)
    cpu = SentenceEncoder("hd48", config=config, max_len=512, device="cpu")
    before = kernels.flash_attention.launches
    got = gpu.encode(docs)
    assert kernels.flash_attention.launches == before + 1
    np.testing.assert_allclose(got, cpu.encode(docs), atol=1e-4, rtol=0)


def test_fused_embed_search_on_card_matches_cpu(card):
    docs = [f"document {i} " + " ".join(f"t{(i * 3 + j) % 41}" for j in range(i % 9 + 3)) for i in range(40)]
    runs = []
    for dev in (card, "cpu"):
        enc = SentenceEncoder("fused-cuda-test", config=_small_config("float32"), max_len=64, device=dev)
        fused = FusedEmbedSearch(enc, DeviceKnnIndex(64, reserved_space=16, device=dev), device=dev)
        payload, meta = fused.prepare_batch(range(20), docs[:20])
        assert payload[0] == "packed" and meta["rows"] == 20
        fused.dispatch_batch(payload)
        fused.embed_and_add(range(20, 40), docs[20:])
        runs.append(fused.search_texts([docs[3], docs[33]], 4))
    got, want = runs
    assert got[0][0][0] == 3 and got[1][0][0] == 33
    for g, w in zip(got, want):
        assert [key for key, _ in g] == [key for key, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4, rtol=0)


@pytest.mark.parametrize("pack", [True, False])
def test_dispatch_batch_enqueues_without_waiting_for_the_card(card, pack):
    """The DevicePipeline's dispatch stage only queues work: no copy in it
    synchronises the card's stream (a pageable upload would, and the
    dispatch would then wait for the batch before it). torch's sync debug
    mode raises on any such synchronisation."""
    docs = [f"document {i} " + " ".join(f"t{(i * 5 + j) % 37}" for j in range(i % 7 + 3)) for i in range(48)]
    enc = SentenceEncoder("sync-test", config=_small_config("float32"), max_len=64, device=card)
    fused = FusedEmbedSearch(enc, DeviceKnnIndex(64, reserved_space=64, device=card), device=card)
    fused.dispatch_batch(fused.prepare_batch(range(16), docs[:16], pack=pack)[0])  # warm-up
    payload, _ = fused.prepare_batch(range(16, 48), docs[16:], pack=pack)
    assert payload[0] == ("packed" if pack else "classic")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emb = fused.dispatch_batch(payload)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert emb.shape == (32, 64) and len(fused.index) == 48
    (row,) = fused.search_texts([docs[30]], 1)
    assert row[0][0] == 30


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_on_card_matches_cpu_and_prefills_through_flash(card, dtype):
    _decoder_on_card_matches_cpu(card, dtype, hidden=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_at_head_dim_256_on_card_prefills_through_flash(card, dtype):
    """Heads of 256 (hidden 512, 2 q heads): the prefill reaches the
    D = 256 instance, flash_fwd_bf16<256> in bf16."""
    _decoder_on_card_matches_cpu(card, dtype, hidden=512)


def _decoder_on_card_matches_cpu(card, dtype, hidden):
    config = dec.DecoderConfig(
        vocab_size=512, hidden=hidden, layers=2, q_heads=2, kv_heads=1,
        mlp_dim=512, max_len=512, dtype=dtype,
    )
    cpu_params = dec.init_decoder_params(torch.Generator().manual_seed(0), config)
    gpu_params = {
        "embed": cpu_params["embed"].to(card), "ln_f": cpu_params["ln_f"].to(card),
        "layers": [{k: t.to(card) for k, t in layer.items()} for layer in cpu_params["layers"]],
    }
    rng = np.random.default_rng(0)
    ids = np.zeros((3, 300), dtype=np.int32)
    mask = np.zeros_like(ids)
    for r, n in enumerate((300, 280, 150)):
        ids[r, :n] = rng.integers(1, 512, size=n)
        mask[r, :n] = 1
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    before = kernels.flash_attention.launches
    got, _ = dec.decoder_forward(gpu_params, config, ti.to(card), tm.to(card))
    assert kernels.flash_attention.launches == before + 2  # one per layer at L = 300
    want, _ = dec.decoder_forward(cpu_params, config, ti, tm)
    live = tm.bool()
    got, want = got.cpu()[live], want[live]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    else:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert cos.min().item() >= 0.999
    before = kernels.flash_attention.launches
    toks = dec.generate_tokens(gpu_params, config, ids, mask, max_new_tokens=6)
    assert kernels.flash_attention.launches == before + 2  # the prefill's
    assert toks.shape == (3, 6) and (toks >= 0).all() and (toks < 512).all()
    if dtype == "float32":
        np.testing.assert_array_equal(
            toks, dec.generate_tokens(cpu_params, config, ids, mask, max_new_tokens=6)
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_on_card_matches_cpu(card, dtype):
    """The same seeded weights score the same pairs on the card and the
    CPU: f32 atol 1e-4, bf16 atol 1e-3 (scores of order 0.03 from the
    head's 0.02 scale; chip_smoke.py holds the full-width model to the
    same bound)."""
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

    config = TransformerConfig(
        vocab_size=512, hidden=64, layers=2, heads=2, mlp_dim=128, max_len=256,
        pooling="cls", dtype=dtype,
    )
    pairs = [(f"query {i}", " ".join(f"w{(i * 5 + j) % 89}" for j in range(10 + 30 * i)))
             for i in range(8)]
    gpu = CrossEncoderModel("cuda-test-ce", config=config, device=card)
    cpu = CrossEncoderModel("cuda-test-ce", config=config, device="cpu")
    assert gpu.head.device.type == "cuda"
    before = kernels.flash_attention.launches
    got = gpu.score(pairs)
    assert kernels.flash_attention.launches == before  # L <= 256: dense
    np.testing.assert_allclose(
        got, cpu.score(pairs), atol=1e-4 if dtype == "float32" else 1e-3, rtol=0
    )


def test_hf_pipeline_chat_on_card_matches_cpu(card):
    """HFPipelineChat places its decoder on the card; prompts over 256
    tokens prefill through flash, and f32 greedy replies equal the CPU's."""
    from pathway_tpu_torch.models.decoder_lm import ChatModel
    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat

    config = dec.DecoderConfig(
        vocab_size=512, hidden=256, layers=2, q_heads=2, kv_heads=1,
        mlp_dim=512, max_len=512, dtype="float32",
    )
    prompts = [" ".join(f"w{(i * 3 + j) % 71}" for j in range(290 + 7 * i)) for i in range(3)]
    gpu = ChatModel("cuda-test-chat", config=config, max_len=512, device=card)
    cpu = ChatModel("cuda-test-chat", config=config, max_len=512, device="cpu")
    chat = HFPipelineChat(generator=gpu, max_new_tokens=6)
    before = kernels.flash_attention.launches
    got = chat.func(prompts)
    assert kernels.flash_attention.launches == before + 2  # the prefill's, one per layer
    assert got == cpu.generate(prompts, max_new_tokens=6)


@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_on_card_match_cpu(card, d, dtype, causal):
    """Flash is differentiable on the card as on the CPU: its output has a
    grad_fn, and the gradients of q, k and v (the kernel's forward, the
    plain version recomputed for the backward) match the CPU path's within
    a share of max(1, |grad|): f32 1e-4, bf16 3e-2 (the backward's products
    round to bf16 on both sides). The backward launches no kernel; under
    no_grad the call launches once and records nothing."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(d + causal)
    q, k, v, g = (torch.randn((2, 3, 200, d), generator=gen) for _ in range(4))
    mask = torch.ones((2, 200), dtype=torch.int32)
    mask[1, 77:] = 0
    grads = {}
    for where in ("cuda", "cpu"):
        ts = [t.to(where, dt).requires_grad_() for t in (q, k, v)]
        before = kernels.flash_attention.launches
        out = kernels.flash_attention(*ts, mask.to(where), causal=causal)
        assert out.grad_fn is not None
        (out.float() * g.to(where)).sum().backward()
        if where == "cuda":
            assert kernels.flash_attention.launches == before + 1
        grads[where] = [t.grad.float().cpu() for t in ts]
    tol = 1e-4 if dtype == "float32" else 3e-2
    for name, got, want in zip("qkv", grads["cuda"], grads["cpu"]):
        err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
        assert err <= tol, f"d{name}: {err}"
    x = q.to(card, dt).requires_grad_()
    before = kernels.flash_attention.launches
    with torch.no_grad():
        out = kernels.flash_attention(x, x, x, mask.to(card), causal=causal)
    assert out.grad_fn is None and kernels.flash_attention.launches == before + 1
