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


# the backward of both packages recomputes the same f32 reference and
# differentiates it, so their gradients differ by f32 rounding only
FLASH_GRAD_ATOL = 1e-4


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 160])
def test_flash_gradients_match_jax_grad(d, causal):
    """Gradients of q, k and v through the port's flash_attention on the
    CPU against `jax.grad` of the JAX package's (its custom_vjp, the Pallas
    forward in interpret mode at block 16), on a ragged mask with a fully
    masked batch row, at atol FLASH_GRAD_ATOL."""
    import jax

    q, k, v, mask = _flash_inputs(np.float32, seed=11 + d, lq=40, lk=48, d=d)
    w = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, jnp.asarray(mask), causal=causal, block_q=16, block_k=16)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FLASH_GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_backward_is_the_plain_versions(monkeypatch, dtype):
    """The card's autograd wiring, on the CPU: `_FlashAttention` with its
    launch replaced by the plain version gives the plain version's own
    gradients (its backward recomputes it), and none for the mask."""
    import importlib

    fa = importlib.import_module("pathway_tpu_torch.ops.kernels.flash_attention")
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, m, s, c: reference_attention(q, k, v, m, s, c))
    q, k, v, mask = _flash_inputs(np.float32, seed=4, lq=24, lk=32, d=16)
    mask = torch.from_numpy(mask)
    w = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    grads = []
    for apply in (fa._FlashAttention.apply, reference_attention):
        t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
        (apply(*t, mask, 0.25, True).float() * w).sum().backward()
        grads.append([x.grad for x in t])
    for got, want in zip(*grads):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- the card's f32 numerics (flash_fwd_tf32x3), emulated on the CPU ----------

LOG2E = 1.4426950408889634
NEG_INF_LOG2 = np.float32(-1e30 * LOG2E)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 as `cvt.rna.tf32.f32` rounds it: 10 mantissa
    bits, ties away from zero (half an ulp added to the magnitude, the 13
    low bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read an f32 operand of a tf32 product: the 13
    low bits ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the kernel's wgmma passes compute it: each operand split
    into x_hi = rna(x) and x_lo = x - x_hi, which the tensor cores read
    truncated to tf32, then a_hi b_hi + a_lo b_hi + a_hi b_lo (a_lo b_lo
    dropped); one pass is a_hi b_hi alone."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    out = ah @ bh
    if passes == 3:
        out = out + _tf32_trunc(a - ah) @ bh + ah @ _tf32_trunc(b - bh)
    return out


def _flash_tf32x3(q, k, v, mask, causal, bn, passes=3):
    """The kernel's arithmetic in PyTorch: kv tiles of `bn` keys, scores in
    log2 units (s * scale * log2(e) plus the mask addend, causally hidden
    keys at -1e30 log2(e)), an online softmax with 2^x, and S = q k^T and P
    v each through `_mm_3xtf32`."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale_log2 = np.float32(d ** -0.5 * LOG2E)
    m = torch.full((b, h, lq), float("-inf"))
    l = torch.zeros((b, h, lq))
    acc = torch.zeros((b, h, lq, d))
    rows = torch.arange(lq)[:, None]
    for k0 in range(0, lk, bn):
        kt, vt = k[:, :, k0 : k0 + bn], v[:, :, k0 : k0 + bn]
        keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
        madd = (1.0 - mask[:, k0 : k0 + bn].float()) * NEG_INF_LOG2
        s = _mm_3xtf32(q, kt.transpose(-1, -2), passes) * scale_log2 + madd[:, None, None, :]
        if causal:
            s = torch.where(keys > rows, torch.tensor(NEG_INF_LOG2), s)
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm_3xtf32(p, vt, passes)
        m = mx
    return acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]


def test_tf32_rna_rounds_ties_away_from_zero_and_trunc_drops_the_low_bits():
    one = 1.0 + 2.0 ** -10  # a tf32 value: 10 mantissa bits
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11,
                      3.0e-39, 0.0], dtype=torch.float32)
    got = _tf32_rna(x).tolist()
    assert got[:4] == [one, -one, 1.0, 1.0 + 2.0 ** -9]
    assert got[5] == 0.0 and abs(got[4] - 3.0e-39) <= 2.0 ** -136  # subnormals keep 10 bits
    hi = _tf32_rna(x[:4])
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert _tf32_trunc(x[:4]).tolist() == [1.0, -1.0, 1.0, one]


@pytest.mark.parametrize(
    "b, h, l, d, causal, bn", [(2, 3, 300, 32, False, 64), (1, 2, 512, 256, True, 32)]
)
def test_flash_tf32x3_numerics_match_jax_kernel(b, h, l, d, causal, bn):
    """The split the card's f32 kernel runs (tf32 hi by cvt.rna's rule, lo
    the rest as the tensor cores read it, three passes for q k^T and for P
    v, the online softmax over its kv tiles in log2 units) meets the f32
    tolerance of 1e-4 against the JAX package's
    flash_attention on the same numpy inputs, on rows with a live key; one
    tf32 pass does not."""
    rng = np.random.default_rng(d + l)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), dtype=np.int32)
    if b > 1:
        mask[1, 1:] = 0  # one live key: the row is v's first key
    ref = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                  causal=causal, block_q=64, block_k=64)
    )
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    out = _flash_tf32x3(*args, causal=causal, bn=bn).numpy()
    assert out.shape == q.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    one_pass = _flash_tf32x3(*args, causal=causal, bn=bn, passes=1).numpy()
    assert np.abs(one_pass - ref).max() > 1e-4
