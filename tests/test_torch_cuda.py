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
tokens, bf16 per-position logit cosine >= 0.999. The data-plane mesh on
["cuda:0"] * n against the same mesh over ["cpu"] * n: the sharded index's
slots equal, its scores as knn's, at least 99 % of the live slots equal
(near-ties); tensor-parallel decode's greedy tokens equal. Decode graphs:
the replayed greedy tokens equal the eager loop's.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import decoder as dec
from pathway_tpu_torch.models.minilm import SentenceEncoder
from pathway_tpu_torch.models.transformer import TransformerConfig
from pathway_tpu_torch.ops import kernels
from pathway_tpu_torch.ops.kernels.flash_attention import padded_head_dim, reference_attention
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
        # two-stage ring), f32 in three tf32 passes (one consumer
        # warpgroup, a one-stage ring); 160 / 200 padded
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
        # the f32 instances (three tf32 passes) over long key runs: the
        # ring wraps 32 to 128 times; one query row against 4096 keys
        (1, 2, 4096, 4096, 32, torch.float32, False),
        (1, 2, 4096, 4096, 32, torch.float32, True),
        (1, 2, 4096, 4096, 256, torch.float32, False),
        (1, 2, 4096, 4096, 256, torch.float32, True),
        (2, 2, 1, 4096, 128, torch.float32, False),
    ],
)
def test_flash_kernel_matches_plain(card, b, h, lq, lk, d, dtype, causal):
    q, k, v, mask = _flash_case(b, h, lq, lk, d, dtype, seed=lq + d, card=card)
    before = kernels.flash_attention.launches
    instance = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}<{padded_head_dim(d)}>"
    before_instance = kernels.flash_attention.launches_by_instance.get(instance, 0)
    out = kernels.flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert kernels.flash_attention.launches_by_instance[instance] == before_instance + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    ref = reference_attention(q, k, v, mask, d ** -0.5, causal)
    live = mask.sum(dim=1) > 0
    err = (out.float()[live] - ref.float()[live]).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize(
    "b, h, l, d, dtype",
    [
        (8, 32, 1000, 128, torch.bfloat16),  # the decoder prefill's heads
        (8, 4, 1000, 256, torch.bfloat16),  # heads of 256
        (8, 12, 1000, 32, torch.float32),  # an f32 encoder's heads
        (8, 4, 1000, 256, torch.float32),
    ],
)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_ragged_rows_down_to_one_live_key(card, b, h, l, d, dtype, causal):
    """Batch rows of 1, 2, 63, 64, 65, 127, 999 and all live keys: a
    tile's mask addends, a partial last tile and rows whose only live key
    is the first, with and without the causal mask. Rows of one or two
    live keys output v itself, up to |o| ~ 5, where one bf16 ulp is 2^-5,
    so the bf16 bound is 2e-2 of max(1, |o|): the table's 2e-2 below |o| =
    1, and about one ulp above. f32 keeps the table's 1e-4 on every row
    (each has a live key)."""
    g = torch.Generator(device=card).manual_seed(d + int(causal))
    q, k, v = (torch.randn((b, h, l, d), device=card, generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([1, 2, 63, 64, 65, 127, l - 1, l], device=card)[:b]
    mask = (torch.arange(l, device=card)[None, :] < lens[:, None]).to(torch.int32)
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    ref = reference_attention(q, k, v, mask, d ** -0.5, causal).float()
    if dtype == torch.float32:
        err = (out - ref).abs().max().item()
        assert err <= 1e-4, err
    else:
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


def test_packed_prepare_of_long_docs_takes_flash_on_card(card):
    """On the card, docs past the flash gate take the classic path (masked
    flash) in place of dense segment attention over wide slabs, and embed
    as the CPU's packed path does."""
    docs = [" ".join(f"w{(i * 7 + j) % 97}" for j in range(300 + 40 * i)) for i in range(6)]
    embs = []
    for dev in (card, "cpu"):
        enc = SentenceEncoder("long-pack-test", config=_small_config("float32"), max_len=512,
                              device=dev)
        fused = FusedEmbedSearch(enc, DeviceKnnIndex(64, reserved_space=16, device=dev), device=dev)
        payload, _ = fused.prepare_batch(range(6), docs)
        assert payload[0] == ("classic" if dev == card else "packed")
        before = kernels.flash_attention.launches
        embs.append(fused.dispatch_batch(payload).float().cpu().numpy())
        if dev == card:
            torch.cuda.synchronize()
            assert kernels.flash_attention.launches == before + 2  # one per layer
    np.testing.assert_allclose(embs[0], embs[1], atol=1e-4, rtol=0)


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


def test_decode_graphs_replay_what_the_eager_loop_decodes(card):
    """Mistral-7B widths, 4 layers, bf16: a greedy decode of prompts of
    up to 500 tokens across the bucket boundary at slot 512, as captured
    graphs replayed, gives the eager loop's tokens; one capture per
    (batch, bucket) touched and one replay per decode step (the host-span
    ring), and a second call captures nothing new."""
    from pathway_tpu_torch.internals import tracing

    config = dataclasses.replace(dec.MISTRAL_7B_DECODER, layers=4, max_len=2048)
    params = dec.init_decoder_params(torch.Generator(device=card).manual_seed(0), config)
    rng = np.random.default_rng(0)
    lengths = (500, 480, 311, 497)
    ids = np.zeros((len(lengths), max(lengths)), dtype=np.int32)
    mask = np.zeros_like(ids)
    for r, n in enumerate(lengths):
        ids[r, :n] = rng.integers(1, config.vocab_size, size=n)
        mask[r, :n] = 1
    new, l = 24, ids.shape[1]
    buckets = {dec.decode_bucket(l + t + 1, config.max_len) for t in range(new - 1)}
    assert buckets == {512, 1024}
    want = dec.generate_tokens(params, config, ids, mask, max_new_tokens=new)
    graphs = dec.DecodeGraphs(params, config)
    thread = threading.current_thread().name
    for call in range(2):
        t0 = time.perf_counter()
        got = dec.generate_tokens(params, config, ids, mask, max_new_tokens=new, graphs=graphs)
        np.testing.assert_array_equal(got, want)
        names = [r[0] for r in tracing.spans_between(t0, time.perf_counter()) if r[4] == thread]
        assert names.count("decoder.graph_capture") == (len(buckets) if call == 0 else 0)
        assert names.count("decoder.graph_replay") == names.count("decoder.decode") == new - 1
    assert sorted(graphs.graphs) == [(len(lengths), b) for b in sorted(buckets)]


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


# -- training and the model-parallel core on the card ------------------------------

# f32, heads of 32, and sequences over the flash gate (L > 256), so every
# attention on the card takes the kernel (f32<32>)
_PAR_CFG = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=512,
                causal=True, pooling="none", dtype="float32")


def _par_batch(rows, length, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, _PAR_CFG["vocab_size"], (rows, length), generator=gen)
    mask = torch.ones((rows, length), dtype=torch.int32)
    mask[-1, length - 37:] = 0
    return ids, mask, torch.roll(ids, -1, dims=1)


def _tree_to(tree, device):
    from pathway_tpu_torch.models.transformer import _leaves, _rebuild

    return _rebuild(tree, (p.to(device) for p in _leaves(tree)))


def _leaf_err(got, want) -> float:
    from pathway_tpu_torch.models.transformer import _leaves

    return max(
        (a.float().cpu() - b.float().cpu()).abs().max().item() / max(b.abs().max().item(), 1e-30)
        for a, b in zip(_leaves(got), _leaves(want), strict=True)
    )


def test_train_step_on_card_matches_cpu(card):
    """One step's loss and gradients on the card (flash forward, recomputed
    plain backward) against the CPU path's, f32: each gradient leaf within
    1e-3 of its largest |g|, the loss within 1e-5 relative; 2 flash
    launches (one a layer)."""
    from pathway_tpu_torch.models.training import loss_and_grads
    from pathway_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig(**_PAR_CFG)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    ids, mask, labels = _par_batch(4, 320)
    want_loss, want = loss_and_grads(params, cfg, ids, mask, labels)
    before = kernels.flash_attention.launches
    loss, got = loss_and_grads(_tree_to(params, card), cfg, ids, mask, labels)
    assert kernels.flash_attention.launches == before + cfg.layers
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert _leaf_err(got, want) <= 1e-3


def test_sharded_train_step_on_card_matches_cpu(card):
    """make_sharded_train_step over a (dp = 2, tp = 2) mesh laid on the one
    card against the same mesh over the CPU, f32: the loss within 1e-5
    relative, each gathered new param within 1e-6 of its leaf's largest;
    2 x 2 x 2 flash launches."""
    from pathway_tpu_torch.models import training
    from pathway_tpu_torch.models.transformer import init_params, tp_gather
    from pathway_tpu_torch.parallel import get_mesh

    cfg = TransformerConfig(**_PAR_CFG)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    batch = _par_batch(4, 320)
    out = {}
    for where in ("cpu", "cuda:0"):
        mesh = get_mesh((2, 2), ("dp", "tp"), devices=[where] * 4)
        step, place_params, place_batch = training.make_sharded_train_step(mesh, cfg, 1e-3)
        before = kernels.flash_attention.launches
        new, loss = step(place_params(params), *place_batch(*batch))
        if where != "cpu":
            assert kernels.flash_attention.launches == before + 2 * 2 * cfg.layers
            assert loss.device.type == "cuda"
        out[where] = (tp_gather(new, cfg, mesh), float(loss))
    assert abs(out["cuda:0"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1])
    assert _leaf_err(out["cuda:0"][0], out["cpu"][0]) <= 1e-6


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sequence_parallel_forward_on_card_matches_cpu(card, attn):
    """sequence_parallel_forward over an sp = 4 mesh laid on the one card
    against the same mesh over the CPU, f32 logits atol 1e-4; Ulysses
    attends through flash (one launch a layer a position), ring never."""
    from pathway_tpu_torch.models.long_context import sequence_parallel_forward
    from pathway_tpu_torch.models.transformer import init_params
    from pathway_tpu_torch.parallel import get_mesh

    cfg = TransformerConfig(**_PAR_CFG)
    params = init_params(torch.Generator().manual_seed(1), cfg)
    ids, mask, _ = _par_batch(2, 512)
    out = {}
    for where in ("cpu", "cuda:0"):
        mesh = get_mesh((4,), ("sp",), devices=[where] * 4)
        before = kernels.flash_attention.launches
        with torch.no_grad():
            out[where] = sequence_parallel_forward(
                _tree_to(params, where), cfg, ids, mask, mesh, attn=attn
            ).cpu()
        if where != "cpu":
            want = 4 * cfg.layers if attn == "ulysses" else 0
            assert kernels.flash_attention.launches == before + want
    np.testing.assert_allclose(out["cuda:0"].numpy(), out["cpu"].numpy(), atol=1e-4, rtol=0)


# -- the data-plane mesh on ["cuda:0"] * n against ["cpu"] * n --------------------


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_sharded_index_on_card_matches_cpu(card, n_dev, metric):
    """DeviceKnnIndex over a ("knn",) mesh: adds with shard hints, removes
    and a growth on both meshes, then searches at k below and above a
    shard's rows: the same slots, knn_topk launched once a shard."""
    from pathway_tpu_torch.ops.kernels import knn_topk
    from pathway_tpu_torch.parallel.mesh import get_mesh

    rng = np.random.default_rng(n_dev)
    d = 40
    indexes = [
        DeviceKnnIndex(d, metric=metric, reserved_space=64,
                       mesh=get_mesh((n_dev,), ("knn",), devices=[dev] * n_dev))
        for dev in ("cuda:0", "cpu")
    ]
    for step in range(3):
        keys = list(range(step * 50, step * 50 + 50))
        vecs = rng.standard_normal((50, d)).astype(np.float32)
        for idx in indexes:
            idx.add_batch(keys, torch.from_numpy(vecs), shards=[k % n_dev for k in keys])
            for key in keys[::7]:
                idx.remove(key)
    on_card, on_cpu = indexes
    assert on_card._slot_of_key == on_cpu._slot_of_key and on_card.capacity == 256
    q = rng.standard_normal((9, d)).astype(np.float32)
    for k in (5, 100):  # a shard holds 256 / n_dev rows
        knn_topk.launches = 0
        cs, ci, _ = on_card.search(q, k)
        assert knn_topk.launches == n_dev
        ps, pi, _ = on_cpu.search(q, k)
        live = np.isfinite(ps)
        np.testing.assert_array_equal(np.isfinite(cs), live)
        np.testing.assert_allclose(cs[live], ps[live], atol=1e-4, rtol=1e-5)
        assert (ci[live] == pi[live]).mean() > 0.99  # near-ties may swap


def test_tp_decode_on_card_matches_cpu(card):
    """The small hd-128 decoder tensor-parallel over tp = 2 on the card
    against the same on the CPU: prefill through flash on each position,
    the same greedy tokens, logits within the f32 tolerance."""
    from pathway_tpu_torch.ops.kernels import flash_attention
    from pathway_tpu_torch.parallel.mesh import get_mesh

    cfg = dec.DecoderConfig(vocab_size=512, hidden=512, layers=2, q_heads=4, kv_heads=2,
                            mlp_dim=1024, max_len=512, dtype="float32")
    params = dec.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, size=(2, 300)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 260:] = 0
    toks = {}
    for dev in ("cuda:0", "cpu"):
        mesh = get_mesh((2,), ("tp",), devices=[dev] * 2)
        shards = dec.decoder_tp_split(params, cfg, mesh)  # each shard copied to its device
        flash_attention.launches = 0
        toks[dev] = dec.generate_tokens(shards, cfg, ids, mask, max_new_tokens=4)
        if dev == "cuda:0":
            assert flash_attention.launches == 2 * cfg.layers
    np.testing.assert_array_equal(toks["cuda:0"], toks["cpu"])
