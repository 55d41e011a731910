"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathway_tpu.ops.kernels import flash_attention as jax_flash
from pathway_tpu.ops.kernels import knn_topk as jax_knn
from pathway_tpu_torch.ops import kernels as port
from pathway_tpu_torch.ops.kernels import _build
from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention
from pathway_tpu_torch.ops.kernels.knn_topk import reference_knn_topk


def _knn_inputs(metric, seed=2, n=300, d=24, qn=5):
    rng = np.random.default_rng(seed)
    index = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(qn, d)).astype(np.float32)
    if metric == "cos":
        index /= np.linalg.norm(index, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    valid = np.ones((n,), dtype=bool)
    valid[50:60] = False
    valid[rng.integers(0, n, size=20)] = False
    return index, valid, queries


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_knn_topk_plain_matches_jax_kernel(metric, k):
    index, valid, queries = _knn_inputs(metric)
    js, ji = jax_knn(
        jnp.asarray(index), jnp.asarray(valid.astype(np.int32)), jnp.asarray(queries),
        k, metric=metric, block_n=128,
    )
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = port.knn_topk(
        torch.from_numpy(index), torch.from_numpy(valid), torch.from_numpy(queries),
        k, metric=metric,
    )
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (queries.shape[0], k)
    ts, ti = ts.numpy(), ti.numpy()
    for row in range(queries.shape[0]):
        assert set(ti[row]) == set(ji[row])
        # atol covers l2sq scores near 0, which are differences of O(d) terms
        np.testing.assert_allclose(
            np.sort(ts[row]), np.sort(js[row]), rtol=1e-5, atol=1e-5
        )
    assert valid[ti].all()


def test_knn_topk_dead_slots_fill_when_too_few_live():
    """With fewer than k live slots the rest of the top-k are dead slots at
    ~-1e30, as in the JAX kernel (the index maps them to -inf)."""
    index, _, queries = _knn_inputs("ip", n=16, d=8, qn=2)
    valid = np.zeros((16,), dtype=bool)
    valid[[3, 7]] = True
    ts, ti = port.knn_topk(
        torch.from_numpy(index), torch.from_numpy(valid), torch.from_numpy(queries), 4,
        metric="ip",
    )
    ts, ti = ts.numpy(), ti.numpy()
    for row in range(2):
        assert set(ti[row, :2]) == {3, 7}
        assert (ts[row, 2:] < -1e29).all()


def _flash_inputs(dtype, seed=0, b=3, h=2, lq=40, lk=40, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    mask = np.ones((b, lk), dtype=np.int32)
    mask[1, lk // 2:] = 0  # ragged
    mask[2, :] = 0  # fully masked batch row, as encode_batch's pad rows
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel(causal):
    q, k, v, mask = _flash_inputs(np.float32)
    ref = np.asarray(
        jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            causal=causal, block_q=16, block_k=16,
        )
    )
    out = port.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), causal=causal,
    ).numpy()
    assert out.shape == q.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    live = mask.sum(axis=1) > 0  # rows with at least one live key
    np.testing.assert_allclose(out[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "d, lq, lk", [(32, 130, 301), (128, 130, 301), (256, 130, 301), (256, 1, 77)]
)
def test_flash_plain_matches_jax_kernel_at_each_instance(d, lq, lk, causal):
    """At the head dims of the card's instances (32, 128 and 256) and the
    card tests' ragged shapes (Lq != Lk, neither a multiple of a tile; Lq
    = 1 over a single partial tile of 77 keys): batch rows with every key
    live, with one live key and with half the keys live."""
    rng = np.random.default_rng(d + lq)
    q, k, v = (rng.normal(size=(3, 2, n, d)).astype(np.float32) for n in (lq, lk, lk))
    mask = np.ones((3, lk), dtype=np.int32)
    mask[1, 1:] = 0
    mask[2, lk // 2:] = 0
    ref = np.asarray(
        jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            causal=causal, block_q=64, block_k=64,
        )
    )
    out = port.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), causal=causal,
    ).numpy()
    assert out.shape == q.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_reference_all_rows(causal):
    """The plain version is the JAX `_reference_attention`, fully masked
    rows included (they average v over the keys)."""
    from pathway_tpu.ops.kernels.flash_attention import _reference_attention

    q, k, v, mask = _flash_inputs(np.float32, seed=3, lq=24, lk=32)
    ref = np.asarray(
        _reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            0.25, causal,
        )
    )
    out = reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), 0.25, causal,
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "d, d_pad", [(24, 32), (48, 64), (80, 128), (8, 16), (160, 256), (200, 256)]
)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_head_dim_padding_leaves_the_plain_result(d, d_pad, causal):
    """What the wrapper does on the card for a head dim without a kernel
    instance: zero columns to the next instance, 1/sqrt(true D), then the
    first D columns. Here through the plain version, against it at the
    true D and against the JAX kernel (which pads to 128 itself)."""
    from pathway_tpu_torch.ops.kernels.flash_attention import pad_head_dim, padded_head_dim

    q, k, v, mask = (torch.from_numpy(a) for a in _flash_inputs(np.float32, seed=d, d=d))
    assert padded_head_dim(d) == d_pad
    padded = [pad_head_dim(t, d_pad) for t in (q, k, v)]
    assert all(t.shape[-1] == d_pad and t.is_contiguous() for t in padded)
    got = reference_attention(*padded, mask, d ** -0.5, causal)[..., :d]
    want = reference_attention(q, k, v, mask, d ** -0.5, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    ref = np.asarray(
        jax_flash(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            jnp.asarray(mask.numpy()), causal=causal, block_q=16, block_k=16,
        )
    )
    live = mask.numpy().sum(axis=1) > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=1e-4, rtol=0)


def test_flash_head_dim_above_the_largest_instance_has_no_kernel():
    from pathway_tpu_torch.ops.kernels.flash_attention import padded_head_dim

    assert padded_head_dim(128) == 128
    assert padded_head_dim(256) == 256
    with pytest.raises(ValueError, match="head dim"):
        padded_head_dim(257)


@pytest.mark.parametrize("d", [129, 160, 200, 255, 256])
def test_flash_head_dims_129_to_256_pad_to_the_256_instance(d):
    from pathway_tpu_torch.ops.kernels.flash_attention import padded_head_dim

    assert padded_head_dim(d) == 256


def test_flash_bf16_plain_keeps_dtype():
    q, k, v, mask = _flash_inputs(np.float32, seed=5)
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out = port.flash_attention(*t, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref = reference_attention(
        *(x.float() for x in t), torch.from_numpy(mask), 0.25, False
    )
    live = torch.from_numpy(mask.sum(axis=1) > 0)
    assert (out.float()[live] - ref[live]).abs().max().item() < 2e-2


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device without
    CUDA raises instead of falling back."""
    x = torch.empty((16, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.knn_topk(x, torch.empty((16,), dtype=torch.bool, device="meta"), x[:2], 2)
    q = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_attention(q, q, q, torch.empty((1, 8), device="meta"))


def test_knn_rejects_bad_metric_and_counts_no_cpu_launch():
    index, valid, queries = _knn_inputs("ip")
    before = port.knn_topk.launches
    with pytest.raises(ValueError, match="metric"):
        port.knn_topk(torch.from_numpy(index), torch.from_numpy(valid),
                      torch.from_numpy(queries), 3, metric="hamming")
    reference_knn_topk(torch.from_numpy(index), torch.from_numpy(valid),
                       torch.from_numpy(queries), 3, metric="ip")
    port.knn_topk(torch.from_numpy(index), torch.from_numpy(valid),
                  torch.from_numpy(queries), 3, metric="ip")
    assert port.knn_topk.launches == before  # the plain version is no launch


def test_build_compiles_every_source_for_sm90a():
    sources = [os.path.basename(p) for p in _build._sources()]
    assert {"knn_topk.cu", "flash_attention.cu"} <= set(sources)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build._digest(_build._sources()) == _build._digest(_build._sources())
