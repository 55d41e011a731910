"""The port's CUDA kernels and entry points on the card, at edge shapes.

These tests need an NVIDIA card and nvcc; on a machine without CUDA they
skip. They import neither JAX nor the JAX package: the card's machine has
no JAX, and the CPU tests (tests/test_torch_*.py) already hold the plain
versions against the JAX package. Here each kernel is held against its
plain version on the same CUDA tensors, at shapes the main path does not
reach (ragged N and D, several query groups, k = N, fewer live slots than
k, Lq != Lk, every head dim). Run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports JAX.)

Tolerances: knn scores atol 1e-4 plus rtol 1e-5 (f32 sums in another
order than cuBLAS; unnormalised l2sq scores reach |s| ~ 300);
flash atol 1e-4 in f32 and 2e-2 in bf16 (about one bf16 ulp at |o| in
[2, 4)), on rows with at least one live key; fully masked rows only need
to be finite. Encoder: f32 atol 1e-4, bf16 per-row cosine >= 0.999.
"""

import numpy as np
import pytest
import torch

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


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 8, 48), device=card)
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
