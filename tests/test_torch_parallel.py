"""The port's mesh, collectives and sequence parallelism against the JAX
package's.

Ring and Ulysses attention at sp = 8 take the port's list of chunks over
`get_mesh((8,), ("sp",), devices=["cpu"] * 8)`; the JAX functions run
under `shard_map` over the 8 CPU devices that tests/conftest.py emulates.
The same inputs, made by numpy from a seed, go to both, and to the port's
`reference_attention` over the whole sequence. Tolerances: attention
1e-5 (rtol and atol; f32 online softmax against dense f32 softmax, as in
tests/test_sequence_parallel.py), the full sequence-parallel forward
2e-4 (two f32 layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from pathway_tpu.models import long_context as jlong
from pathway_tpu.models import transformer as jtr
from pathway_tpu.parallel.ring_attention import ring_attention as jring_attention
from pathway_tpu.parallel.ring_attention import ulysses_attention as julysses_attention
from pathway_tpu_torch.models import long_context
from pathway_tpu_torch.models import transformer as tr
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention
from pathway_tpu_torch.parallel import collectives, mesh as pmesh
from pathway_tpu_torch.parallel import ring_attention, ulysses_attention

try:
    from jax import shard_map  # jax >= 0.8
    _REP_KWARGS = {"check_vma": False}
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
    _REP_KWARGS = {"check_rep": False}

SP = 8


def _jmesh():
    return JMesh(np.array(jax.devices()[:SP]), ("sp",))


def _mesh():
    return pmesh.get_mesh((SP,), ("sp",), devices=["cpu"] * SP)


def _chunks(x, axis):
    return list(torch.from_numpy(x).chunk(SP, dim=axis))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_attention_matches_jax_and_reference(causal, strategy):
    rng = np.random.default_rng(0)
    b, h, l, d = 2, 8, 8 * SP, 16
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), dtype=np.int32)
    mask[1, l - 5:] = 0

    jfn = jring_attention if strategy == "ring" else julysses_attention
    kwargs = {} if strategy == "ring" else {"use_flash": False}
    sharded = shard_map(
        lambda q, k, v, m: jfn(q, k, v, m, causal=causal, **kwargs),
        mesh=_jmesh(),
        in_specs=(JP(None, None, "sp", None),) * 3 + (JP(None, "sp"),),
        out_specs=JP(None, None, "sp", None),
        **_REP_KWARGS,
    )
    want = np.asarray(jax.jit(sharded)(q, k, v, mask))

    fn = ring_attention if strategy == "ring" else ulysses_attention
    out = fn(_chunks(q, 2), _chunks(k, 2), _chunks(v, 2), _chunks(mask, 1), causal=causal)
    assert len(out) == SP and out[0].shape == (b, h, l // SP, d)
    got = torch.cat(out, dim=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = reference_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), 1.0 / np.sqrt(d), causal)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


def test_ulysses_refuses_heads_not_divisible_by_sp():
    x = [torch.zeros(1, 6, 2, 4)] * SP
    with pytest.raises(ValueError, match="heads 6 not divisible by sp axis 8"):
        ulysses_attention(x, x, x, [torch.ones(1, 2)] * SP)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("pooling", ["none", "mean"])
def test_sequence_parallel_forward_matches_jax(pooling, attn):
    kw = dict(vocab_size=256, hidden=32, layers=2, heads=8, mlp_dim=64, max_len=8 * SP,
              causal=(pooling == "none"), pooling=pooling, dtype="float32")
    jcfg, tcfg = jtr.TransformerConfig(**kw), tr.TransformerConfig(**kw)
    jparams = jax.tree_util.tree_map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    b, l = 2, 8 * SP
    ids = rng.integers(0, kw["vocab_size"], size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), dtype=np.int32)
    mask[0, l - 3:] = 0

    want = np.asarray(jlong.sequence_parallel_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), _jmesh(), attn=attn
    ))
    params = params_from_jax(jparams)
    got = long_context.sequence_parallel_forward(params, tcfg, ids, mask, _mesh(), attn=attn)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    unsharded = tr.forward(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), use_flash=False)
    np.testing.assert_allclose(got.numpy(), unsharded.numpy(), rtol=2e-4, atol=2e-4)


def test_sequence_parallel_forward_checks_its_arguments():
    cfg = tr.TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, mlp_dim=32,
                               max_len=16, causal=True, pooling="none", dtype="float32")
    params = tr.init_params(torch.Generator().manual_seed(0), cfg)
    ids = np.zeros((1, 12), dtype=np.int32)
    with pytest.raises(ValueError, match="sequence length 12 not divisible by sp=8"):
        long_context.sequence_parallel_forward(params, cfg, ids, ids + 1, _mesh())
    with pytest.raises(ValueError, match="attn must be 'ring' or 'ulysses'"):
        long_context.sequence_parallel_forward(params, cfg, ids, ids + 1, _mesh(), attn="tree")


# -- the mesh -------------------------------------------------------------------


def test_get_mesh_shapes_and_axes():
    mesh = pmesh.get_mesh((4, 2), ("dp", "tp"), devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.axis_names == ("dp", "tp")
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.device(dp=3, tp=1) == torch.device("cpu")
    assert len(mesh.axis_devices("dp")) == 4
    flat = pmesh.get_mesh(devices=["cpu"] * 8)
    assert flat.shape == {"dp": 8, "tp": 1}
    with pytest.raises(ValueError, match="no axis"):
        mesh.device(sp=0)
    with pytest.raises(ValueError, match="needs 1 axis names"):
        pmesh.Mesh(np.array(["cpu"] * 4, dtype=object), ("dp", "tp"))


def test_with_mesh_sets_and_restores_the_default(monkeypatch):
    monkeypatch.setattr(pmesh, "_active_mesh", None)
    outer = pmesh.get_mesh((2,), ("sp",), devices=["cpu"] * 2)
    inner = pmesh.get_mesh((4,), ("sp",), devices=["cpu"] * 4)
    with pmesh.with_mesh(outer):
        assert pmesh.default_mesh() is outer
        with pmesh.with_mesh(inner):
            assert pmesh.default_mesh() is inner
        assert pmesh.default_mesh() is outer
    assert pmesh._active_mesh is None


def test_get_mesh_needs_cuda_unless_devices_are_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pmesh, "_active_mesh", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.get_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.default_mesh()
    assert pmesh.get_mesh((2,), ("sp",), devices=["cpu", "cpu"]).shape == {"sp": 2}


def test_partition_spec_is_a_tuple():
    spec = pmesh.P(None, "tp")
    assert spec == (None, "tp") and isinstance(spec, tuple) and repr(spec) == "P(None, 'tp')"


# -- the collectives against their numpy definitions ----------------------------


def _shards(n=4, shape=(2, 6), seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    return arrays, [torch.from_numpy(a) for a in arrays]


def test_psum():
    arrays, xs = _shards()
    out = collectives.psum(xs)
    assert len(out) == 4 and all(o is out[0] for o in out)  # one device: one tensor
    np.testing.assert_allclose(out[0].numpy(), np.sum(arrays, axis=0), rtol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_all_gather(axis):
    arrays, xs = _shards()
    out = collectives.all_gather(xs, axis=axis)
    np.testing.assert_array_equal(out[2].numpy(), np.concatenate(arrays, axis=axis))


def test_ppermute():
    arrays, xs = _shards()
    out = collectives.ppermute(xs, [(0, 1), (1, 2), (2, 0)])  # position 3 receives nothing
    for dst, src in ((1, 0), (2, 1), (0, 2)):
        np.testing.assert_array_equal(out[dst].numpy(), arrays[src])
    np.testing.assert_array_equal(out[3].numpy(), np.zeros_like(arrays[3]))


@pytest.mark.parametrize("split_axis,concat_axis", [(1, 0), (0, 1)])
def test_all_to_all(split_axis, concat_axis):
    arrays, xs = _shards(shape=(4, 8))
    out = collectives.all_to_all(xs, split_axis=split_axis, concat_axis=concat_axis)
    for j in range(4):
        want = np.concatenate([np.split(a, 4, axis=split_axis)[j] for a in arrays], axis=concat_axis)
        np.testing.assert_array_equal(out[j].numpy(), want)
    with pytest.raises(ValueError, match="does not split into 4 blocks"):
        collectives.all_to_all(_shards(shape=(3, 3))[1], split_axis=0, concat_axis=1)


def test_axis_index():
    assert collectives.axis_index(_shards(n=3)[1]) == [0, 1, 2]


def test_collectives_carry_gradients_back_to_every_shard():
    _arrays, xs = _shards()
    xs = [x.requires_grad_() for x in xs]
    w = torch.arange(48, dtype=torch.float32).reshape(2, 24)
    summed = collectives.psum(xs)
    gathered = collectives.all_gather(xs, axis=1)
    (summed[1].sum() + (gathered[3] * w).sum()).backward()
    for i, x in enumerate(xs):
        np.testing.assert_array_equal(x.grad.numpy(), 1.0 + w[:, 6 * i:6 * (i + 1)].numpy())
