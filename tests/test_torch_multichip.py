"""The port's multichip checks and tensor-parallel decode against the JAX
package's, on the CPU.

`pathway_tpu_torch.parallel.multichip_checks.run_all(8, devices=["cpu"] *
8)` runs the JAX package's four checks on the port's single-controller
mesh; the JAX package's run on the 8 CPU devices tests/conftest.py
forces. Both draw their weights inside the checks; here the port's
initialisers are replaced by the JAX package's weights for the same seed
(carried across by `params_from_jax` / `decoder_params_from_jax`), so the
two packages run the same models on the same inputs.

Tolerances. The train and sp-ring checks' models are bf16 (the
TransformerConfig default), so their numbers take the repo's bf16
tolerances: the train step's loss rel. err 2e-3, as
tests/test_torch_training.py holds the bf16 step (3.7e-5 here); the sp
ring logits atol 2e-2 with row cosine >= 0.999, as
tests/test_torch_encoder.py holds bf16 outputs (4.3e-3 here). tp decode,
on the check's tiny f32 decoder: the generated tokens equal, the
logits atol 1e-4. Retrieval `==`. `decoder_sharding_rules` equal to the
JAX package's spec for spec.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import long_context as jlong
from pathway_tpu.models import transformer as jtr
from pathway_tpu.parallel import multichip_checks as jchecks
from pathway_tpu.parallel.mesh import get_mesh as jget_mesh
from pathway_tpu_torch.models import decoder as dec
from pathway_tpu_torch.models import long_context
from pathway_tpu_torch.models import minilm
from pathway_tpu_torch.models import transformer as tr
from pathway_tpu_torch.models.convert import decoder_params_from_jax, params_from_jax
from pathway_tpu_torch.parallel import multichip_checks
from pathway_tpu_torch.parallel.mesh import get_mesh

N = 8
CPUS = ["cpu"] * N
BF16_LOSS_REL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's initialisers, for the duration of a test, give the JAX
    package's weights for the same seed and config."""

    def init_params(generator, config):
        jcfg = jtr.TransformerConfig(**dataclasses.asdict(config))
        return params_from_jax(_np(jtr.init_params(jax.random.PRNGKey(generator.initial_seed()), jcfg)))

    def init_decoder_params(generator, config, device=None):
        jcfg = jdec.DecoderConfig(**dataclasses.asdict(config))
        tree = decoder_params_from_jax(
            _np(jdec.init_decoder_params(jax.random.PRNGKey(generator.initial_seed()), jcfg))
        )
        return tr._tree_to(tree, device or "cpu")

    monkeypatch.setattr(tr, "init_params", init_params)
    monkeypatch.setattr(dec, "init_decoder_params", init_decoder_params)
    monkeypatch.setattr(minilm, "_model_cache", {})


@pytest.fixture
def recorded(monkeypatch):
    """What sequence_parallel_forward and generate_tokens return inside the
    checks, by package."""
    seen = {}

    def record(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[key] = out
            return out

        monkeypatch.setattr(module, name, wrapper)

    record(jlong, "sequence_parallel_forward", "jax_sp")
    record(long_context, "sequence_parallel_forward", "port_sp")
    record(jdec, "generate_tokens", "jax_tokens")
    record(dec, "generate_tokens", "port_tokens")
    return seen


def test_sharded_train_step_matches_jax(jax_weights):
    want = jchecks.check_sharded_train_step(N)
    got = multichip_checks.check_sharded_train_step(N, devices=CPUS)
    assert abs(got - want) <= BF16_LOSS_REL * abs(want), (got, want)


def test_sp_ring_logits_match_jax(jax_weights, recorded):
    assert multichip_checks.check_sp_ring(N, devices=CPUS) == jchecks.check_sp_ring(N) == (2, 64, 512)
    got, want = recorded["port_sp"].float().numpy(), np.asarray(recorded["jax_sp"], np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999


def test_tp_decode_matches_jax(jax_weights, recorded):
    assert multichip_checks.check_tp_decode(N, devices=CPUS) == jchecks.check_tp_decode(N) == (N, 4)
    np.testing.assert_array_equal(recorded["port_tokens"], np.asarray(recorded["jax_tokens"]))


def test_sharded_retrieval_parity_matches_jax(jax_weights):
    got, n_docs = multichip_checks.check_sharded_retrieval_parity(N, devices=CPUS)
    want, jn_docs = jchecks.check_sharded_retrieval_parity(N)
    assert n_docs == jn_docs == 3 * N
    assert got == want and len(got) == 2


def test_run_all_reports_as_jax(jax_weights):
    got = multichip_checks.run_all(N, devices=CPUS)
    want = jchecks.run_all(N)
    loss, jloss = got.pop("loss"), want.pop("loss")
    assert abs(loss - jloss) <= BF16_LOSS_REL * abs(jloss)
    assert got == want


def test_checks_need_cuda_devices_unless_given():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this process has CUDA devices")
    with pytest.raises(RuntimeError, match="2 CUDA devices needed"):
        multichip_checks.check_tp_decode(2)


# -- tensor-parallel decode ----------------------------------------------------

CFG = dict(vocab_size=256, hidden=64, layers=2, q_heads=8, kv_heads=4, mlp_dim=128, max_len=64,
           dtype="float32")


def _decoders(seed=2, **overrides):
    cfg = dict(CFG, **overrides)
    jcfg, pcfg = jdec.DecoderConfig(**cfg), dec.DecoderConfig(**cfg)
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, pcfg, jparams, decoder_params_from_jax(_np(jparams))


def test_decoder_sharding_rules_match_jax():
    jcfg, pcfg, _j, _p = _decoders()
    for shape in ((4, 2), (8, 1)):
        want = jdec.decoder_sharding_rules(jcfg, jget_mesh(shape, ("dp", "tp")))
        got = dec.decoder_sharding_rules(pcfg, get_mesh(shape, ("dp", "tp"), devices=CPUS))
        assert jax.tree_util.tree_structure(got, is_leaf=lambda x: isinstance(x, tuple)) == \
            jax.tree_util.tree_structure(want, is_leaf=lambda x: isinstance(x, tuple))
        flat = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        jflat = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))
        assert [tuple(s) for s in flat] == [tuple(s) for s in jflat]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_split_takes_whole_heads_and_copies_nothing(tp):
    _jcfg, pcfg, _j, params = _decoders()
    shards = dec.decoder_tp_split(params, pcfg, get_mesh((tp,), ("tp",), devices=["cpu"] * tp))
    hd = pcfg.head_dim
    for t, tree in enumerate(shards):
        layer, full = tree["layers"][0], params["layers"][0]
        assert layer["wq"].shape == (64, pcfg.q_heads // tp * hd)
        assert layer["wk"].shape == (64, pcfg.kv_heads // tp * hd)
        q_cols = slice(t * pcfg.q_heads // tp * hd, (t + 1) * pcfg.q_heads // tp * hd)
        assert torch.equal(layer["wq"], full["wq"][:, q_cols])
        assert layer["wo"].untyped_storage().data_ptr() == full["wo"].untyped_storage().data_ptr()
        assert tree["embed"].shape == (256 // tp, 64)
    with pytest.raises(ValueError, match="must divide by the tp axis"):
        dec.decoder_tp_split(params, pcfg, get_mesh((8,), ("tp",), devices=CPUS))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefill_and_steps_match_jax_and_unsharded(tp):
    """A cached prefill and two decode steps over tp positions: the
    gathered logits against the unsharded port's and the JAX package's
    prefill (atol 1e-4)."""
    jcfg, pcfg, jparams, params = _decoders()
    shards = dec.decoder_tp_split(params, pcfg, get_mesh((tp,), ("tp",), devices=["cpu"] * tp))
    rng = np.random.default_rng(0)
    b, l = 3, 10
    ids = torch.from_numpy(rng.integers(0, 256, size=(b, l)))
    mask = torch.ones((b, l), dtype=torch.int64)
    mask[1, 7:] = 0
    want_jax = np.asarray(jdec.decoder_forward(jparams, jcfg, ids.numpy(), mask.numpy())[0])
    positions = mask.cumsum(1) - 1
    kv_valid = torch.zeros((b, pcfg.max_len), dtype=torch.int32)
    kv_valid[:, :l] = mask
    kv_valid_one = kv_valid.clone()
    caches = [dec.init_kv_cache(pcfg, b, "cpu", tp=tp) for _ in range(tp)]
    cache_one = dec.init_kv_cache(pcfg, b, "cpu")
    assert caches[0][0]["k"].shape == (b, pcfg.kv_heads // tp, pcfg.max_len, pcfg.head_dim)
    with torch.no_grad():
        got, _ = dec.decoder_forward(shards, pcfg, ids, mask, positions=positions, kv_cache=caches,
                                     kv_valid=kv_valid)
        want, _ = dec.decoder_forward(params, pcfg, ids, mask, positions=positions,
                                      kv_cache=cache_one, kv_valid=kv_valid_one)
        assert len(got) == tp and got[0].shape == (b, l, 256 // tp)
        live = mask.bool().numpy()
        np.testing.assert_allclose(torch.cat(got, -1).numpy()[live], want.numpy()[live], atol=1e-4)
        np.testing.assert_allclose(torch.cat(got, -1).numpy()[live], want_jax[live], atol=1e-4)
        tok = torch.cat(got, -1)[torch.arange(b), mask.sum(1) - 1].argmax(-1)
        for t in range(2):
            for v in (kv_valid, kv_valid_one):
                v[:, l + t] = 1
            step = dict(positions=(mask.sum(1) + t)[:, None], slot_offset=l + t)
            got, _ = dec.decoder_forward(shards, pcfg, tok[:, None], torch.ones((b, 1)),
                                         kv_cache=caches, kv_valid=kv_valid, **step)
            want, _ = dec.decoder_forward(params, pcfg, tok[:, None], torch.ones((b, 1)),
                                          kv_cache=cache_one, kv_valid=kv_valid_one, **step)
            np.testing.assert_allclose(torch.cat(got, -1).numpy(), want.numpy(), atol=1e-4)
            tok = want[:, 0].argmax(-1)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tp_generate_matches_unsharded_and_jax(temperature):
    jcfg, pcfg, jparams, params = _decoders()
    shards = dec.decoder_tp_split(params, pcfg, get_mesh((2,), ("tp",), devices=["cpu"] * 2))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, size=(4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 9:] = 0
    got = dec.generate_tokens(shards, pcfg, ids, mask, max_new_tokens=6, temperature=temperature,
                              seed=5)
    want = dec.generate_tokens(params, pcfg, ids, mask, max_new_tokens=6, temperature=temperature,
                               seed=5)
    np.testing.assert_array_equal(got, want)
    if temperature == 0.0:
        np.testing.assert_array_equal(
            got, np.asarray(jdec.generate_tokens(jparams, jcfg, ids, mask, max_new_tokens=6))
        )


def test_tp_greedy_pick_takes_the_lowest_index_of_equal_scores():
    """Every vocab row the same, so every logit ties: the pick is token 0,
    the lowest global index, as an argmax over the whole vocabulary
    gives, and not the first index of a later slice."""
    _jcfg, pcfg, _j, params = _decoders()
    params = dict(params, embed=params["embed"][:1].expand(256, 64).clone())
    shards = dec.decoder_tp_split(params, pcfg, get_mesh((2,), ("tp",), devices=["cpu"] * 2))
    ids = np.array([[3, 1, 4, 1]], dtype=np.int32)
    got = dec.generate_tokens(shards, pcfg, ids, np.ones_like(ids), max_new_tokens=3)
    want = dec.generate_tokens(params, pcfg, ids, np.ones_like(ids), max_new_tokens=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros((1, 3), dtype=np.int32))


def test_tp_bf16_prefill_sums_the_row_shards_in_f32():
    """In bf16 each tp position's wo and down products are f32 partials,
    rounded once after their psum as the unsharded product is: the tp
    prefill's logits stay within row cosine 0.9999 of the unsharded
    decoder's, and the greedy tokens equal."""
    _jcfg, pcfg, _j, params = _decoders(dtype="bfloat16")
    params = dec.init_decoder_params(torch.Generator().manual_seed(7), pcfg)
    shards = dec.decoder_tp_split(params, pcfg, get_mesh((2,), ("tp",), devices=["cpu"] * 2))
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, size=(3, 16)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        got, _ = dec.decoder_forward(shards, pcfg, ids, mask)
        want, _ = dec.decoder_forward(params, pcfg, ids, mask)
    got = torch.cat(got, -1)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= 0.9999
    np.testing.assert_array_equal(
        dec.generate_tokens(shards, pcfg, ids.numpy(), mask.numpy(), max_new_tokens=4),
        dec.generate_tokens(params, pcfg, ids.numpy(), mask.numpy(), max_new_tokens=4),
    )
