"""The port's training step, unsharded and over a (dp, tp) mesh, against
the JAX package's.

Both packages get the same weights (the JAX tree carried over with
`params_from_jax`) and the same batch, made by numpy from a seed, on the
tiny config of the JAX package's multichip check (vocab 512, hidden 64, 2
layers, 4 heads, causal, pooling none), in f32 and in bf16. The port's
sharded step runs over `get_mesh((4, 2), devices=["cpu"] * 8)`; the JAX
package's over the 8 CPU devices that tests/conftest.py emulates.

Tolerances (max |difference| over a leaf, against the reference leaf's
max |value|): f32 1e-5 for the loss, the gradients and the new params (f32
rounding of sums taken in another order by XLA and by torch). bf16: the
loss 2e-3 relative; the gradients 0.1 of their leaf's largest (bf16
keeps 8 bits; a bias gradient sums 512 tokens' terms, each rounded at
other points by the two packages, with much cancellation: 5.5 % at
worst here); the new params 1e-5 of their leaf's largest plus lr times
0.1 of the largest gradient of the tree (0.12 here), 2e-5 absolute,
since a bias starts at zero and its new value is -lr * g.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from pathway_tpu.models import training as jtraining
from pathway_tpu.models import transformer as jtr
from pathway_tpu.parallel.mesh import get_mesh as jget_mesh
from pathway_tpu_torch.models import training
from pathway_tpu_torch.models import transformer as tr
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.models.transformer import _leaves
from pathway_tpu_torch.parallel.mesh import P, get_mesh

# the JAX package's multichip training check's model
CFG = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32,
           causal=True, pooling="none")
DP, TP = 4, 2
LR = 1e-3
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.1}
PARAM_TOL = 1e-5
PARAM_ATOL = {"float32": 0.0, "bfloat16": 2e-5}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    jcfg = jtr.TransformerConfig(**CFG, dtype=dtype)
    tcfg = tr.TransformerConfig(**CFG, dtype=dtype)
    jparams = jax.tree_util.tree_map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))
    return dtype, jcfg, tcfg, jparams


def _batch(rows=DP * 4, length=32, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(rows, length)).astype(np.int32)
    lens = rng.integers(length // 2, length + 1, size=rows)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask, np.roll(ids, -1, axis=1)


def _flat(tree, path=""):
    """{path: f32 array} of a tree of tensors or arrays, dict keys sorted
    (JAX's leaf order)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    if torch.is_tensor(tree):
        tree = tree.detach().float().numpy()
    return {path: np.asarray(tree, dtype=np.float32)}


def _close(port_tree, ref_tree, tol, what, atol=0.0):
    """Every leaf within tol of the reference leaf's max |value|, plus atol."""
    port, ref = _flat(port_tree), _flat(ref_tree)
    assert port.keys() == ref.keys(), what
    for path, b in ref.items():
        a = port[path]
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err <= tol * float(np.abs(b).max()) + atol, f"{what}: {path} off by {err}"


def test_loss_fn_matches_jax(model):
    dtype, jcfg, tcfg, jparams = model
    ids, mask, labels = _batch()
    want = float(jtraining.loss_fn(jparams, jcfg, ids, mask, labels))
    got = float(training.loss_fn(params_from_jax(jparams), tcfg, ids, mask, labels))
    assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (got, want)


def test_gradients_match_jax_grad(model):
    dtype, jcfg, tcfg, jparams = model
    ids, mask, labels = _batch()
    want = jax.grad(lambda p: jtraining.loss_fn(p, jcfg, ids, mask, labels))(jparams)
    _, got = training.loss_and_grads(params_from_jax(jparams), tcfg, ids, mask, labels)
    _close(got, jax.tree_util.tree_map(np.asarray, want), GRAD_TOL[dtype], "gradients")


def _jax_step(jcfg, jparams, ids, mask, labels):
    new, loss = jax.jit(jtraining.make_train_step(jcfg, LR))(jparams, ids, mask, labels)
    return jax.tree_util.tree_map(np.asarray, new), float(loss)


@pytest.mark.parametrize("jax_flash", [False, True], ids=["jax_dense", "jax_flash"])
def test_train_step_matches_jax(model, jax_flash, monkeypatch):
    """One SGD step's loss and new params; with `jax_flash` the JAX side
    runs its Pallas flash kernel (interpret mode on the CPU) and its
    custom_vjp, the port its plain path."""
    dtype, jcfg, tcfg, jparams = model
    if jax_flash:
        flash_forward = jtr.forward

        def forward(*args, **kwargs):
            return flash_forward(*args, **dict(kwargs, use_flash=True))

        monkeypatch.setattr(jtraining, "forward", forward)
    ids, mask, labels = _batch()
    want_params, want_loss = _jax_step(jcfg, jparams, ids, mask, labels)
    params = params_from_jax(jparams)
    new, loss = training.make_train_step(tcfg, LR)(params, ids, mask, labels)
    assert new is params
    assert abs(float(loss) - want_loss) <= LOSS_TOL[dtype] * abs(want_loss)
    _close(new, want_params, PARAM_TOL, "new params", PARAM_ATOL[dtype])


def _port_sharded(tcfg, jparams, batch):
    mesh = get_mesh((DP, TP), ("dp", "tp"), devices=["cpu"] * 8)
    step, place_params, place_batch = training.make_sharded_train_step(mesh, tcfg, LR)
    shards = place_params(params_from_jax(jparams))
    new, loss = step(shards, *place_batch(*batch))
    return mesh, new, loss


def test_sharded_train_step_matches_jax_and_unsharded(model):
    dtype, jcfg, tcfg, jparams = model
    batch = _batch()
    jmesh = jget_mesh((DP, TP), ("dp", "tp"))
    jstep, jplace_params, jplace_batch = jtraining.make_sharded_train_step(jmesh, jcfg, LR)
    with jmesh:
        jnew, jloss = jstep(jplace_params(jparams), *jplace_batch(*batch))
    want_params = jax.tree_util.tree_map(np.asarray, jnew)

    mesh, new, loss = _port_sharded(tcfg, jparams, batch)
    assert loss.device == mesh.devices.flat[0]
    gathered = tr.tp_gather(new, tcfg, mesh)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL[dtype] * abs(float(jloss))
    _close(gathered, want_params, PARAM_TOL, "sharded new params vs JAX's", PARAM_ATOL[dtype])

    unsharded, uloss = training.make_train_step(tcfg, LR)(params_from_jax(jparams), *batch)
    assert abs(float(loss) - float(uloss)) <= LOSS_TOL[dtype] * abs(float(uloss))
    _close(gathered, unsharded, PARAM_TOL, "sharded new params vs the unsharded step's",
           PARAM_ATOL[dtype])


def test_sharded_gradients_sum_over_shards(model):
    """Each gathered gradient equals the unsharded gradient: a replicated
    leaf's is the sum of every dp row's and tp shard's contributions,
    accumulated in its one master."""
    dtype, _jcfg, tcfg, jparams = model
    ids, mask, labels = _batch()
    mesh = get_mesh((DP, TP), ("dp", "tp"), devices=["cpu"] * 8)
    _step, place_params, place_batch = training.make_sharded_train_step(mesh, tcfg, LR)
    shards = place_params(params_from_jax(jparams))
    loss, grads = training.sharded_loss_and_grads(
        mesh, tcfg, shards, *place_batch(ids, mask, labels)
    )
    want_loss, want = training.loss_and_grads(params_from_jax(jparams), tcfg, ids, mask, labels)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL[dtype] * abs(float(want_loss))
    _close(tr.tp_gather(grads, tcfg, mesh), want, GRAD_TOL[dtype], "sharded gradients")
    # replicated leaves: one master, one gradient, shared by both tp trees
    for key in ("pos_embed",):
        assert shards[0][key] is shards[1][key] and grads[0][key] is grads[1][key]
    assert grads[0]["layers"][0]["out_b"] is grads[1]["layers"][0]["out_b"]
    assert grads[0]["embed"].shape == (CFG["vocab_size"] // TP, CFG["hidden"])


def test_place_params_copies_and_splits_by_rule():
    tcfg = tr.TransformerConfig(**CFG, dtype="float32")
    params = tr.init_params(torch.Generator().manual_seed(0), tcfg)
    before = copy.deepcopy(params)
    mesh = get_mesh((DP, TP), ("dp", "tp"), devices=["cpu"] * 8)
    step, place_params, place_batch = training.make_sharded_train_step(mesh, tcfg, LR)
    shards = place_params(params)
    step(shards, *place_batch(*_batch()))
    for a, b in zip(_leaves(params), _leaves(before)):
        assert torch.equal(a, b)
    h = CFG["hidden"]
    layer = shards[1]["layers"][0]
    assert layer["qkv"].shape == (h, 3 * h // TP) and layer["out"].shape == (h // TP, h)
    # the qkv shard holds the same columns of q, k and v: whole heads of each
    full = params["layers"][0]["qkv"]
    np.testing.assert_array_equal(
        tr.tp_split(params, tcfg, mesh)[1]["layers"][0]["qkv"],
        torch.cat([full[:, h // 2:h], full[:, h + h // 2:2 * h], full[:, 2 * h + h // 2:]], 1),
    )


def _specs(rules):
    """The specs of a rules tree as tuples, dict keys sorted (JAX's order)."""
    if isinstance(rules, dict):
        return [s for key in sorted(rules) for s in _specs(rules[key])]
    if isinstance(rules, list):
        return [s for r in rules for s in _specs(r)]
    return [tuple(rules)]


def test_sharding_rules_match_jax():
    mesh = get_mesh((DP, TP), ("dp", "tp"), devices=["cpu"] * 8)
    got = tr.param_sharding_rules(tr.TransformerConfig(**CFG), mesh)
    jrules = jtr.param_sharding_rules(jtr.TransformerConfig(**CFG), jget_mesh((DP, TP), ("dp", "tp")))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    assert _specs(got) == [tuple(s) for s in jax.tree_util.tree_leaves(jrules, is_leaf=is_spec)]
    assert isinstance(got["layers"][0]["qkv"], P) and got["layers"][0]["qkv"] == (None, "tp")


def test_tp_refuses_what_does_not_split():
    mesh = get_mesh((2, 4), ("dp", "tp"), devices=["cpu"] * 8)
    odd_vocab = tr.TransformerConfig(**dict(CFG, vocab_size=30522, heads=4))
    params = tr.init_params(torch.Generator().manual_seed(0), odd_vocab)
    with pytest.raises(ValueError, match="embed .* does not split evenly over the tp axis of size 4"):
        tr.tp_split(params, odd_vocab, mesh)
    with pytest.raises(ValueError, match="heads 2 not divisible"):
        training.make_sharded_train_step(mesh, tr.TransformerConfig(**dict(CFG, heads=2)))
