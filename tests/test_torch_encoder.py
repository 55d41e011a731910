"""The port's tokenizer, encoder forward, weight bridge, HF loader and
SentenceEncoder against the JAX package, on the same inputs and weights.

Small configs (2 layers, hidden 64, 4 heads) on the CPU; the JAX side runs
its own CPU path. Tolerances: f32 atol 1e-4; bf16 per-row cosine >= 0.999
and atol 2e-2 (the two frameworks round bf16 at different places).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from pathway_tpu.models import hf_loader as jax_hf
from pathway_tpu.models import tokenizer as jax_tok
from pathway_tpu.models import transformer as jax_tf
from pathway_tpu.models.minilm import SentenceEncoder as JaxSentenceEncoder
from pathway_tpu_torch.models import hf_loader as port_hf
from pathway_tpu_torch.models import tokenizer as port_tok
from pathway_tpu_torch.models import transformer as port_tf
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.models.minilm import SentenceEncoder

VOCAB = 512
TEXTS = [
    f"stream table {i} " + "engine shard mesh window " * (i % 5) + ("Join, reduce!" if i % 3 else "")
    for i in range(13)
] + ["", "a", "UPPER case Words and dots..."]


def _configs(dtype, norm_style, **kw):
    jc = jax_tf.TransformerConfig(
        vocab_size=VOCAB, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64,
        dtype=dtype, norm_style=norm_style, **kw,
    )
    pc = port_tf.TransformerConfig(**dataclasses.asdict(jc))
    return jc, pc


def _models(jc, pc, seed=0):
    params = jax_tf.init_params(jax.random.PRNGKey(seed), jc)
    jlm = jax_tf.TransformerLM(jc, params=params)
    plm = port_tf.TransformerLM(
        pc, params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)), device="cpu"
    )
    return jlm, plm


def _assert_close(got, want, dtype, rows):
    got, want = got[rows], want[rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
        cos = (got * want).sum(-1) / (
            np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1) + 1e-12
        )
        assert cos.min() >= 0.999


# -- tokenizer ---------------------------------------------------------------


@pytest.mark.parametrize("max_len", [8, 64, 512])
def test_encode_batch_identical(max_len):
    texts = TEXTS + ["naïve café – ünïcode"]
    jt = jax_tok.HashTokenizer(vocab_size=VOCAB)
    pt = port_tok.HashTokenizer(vocab_size=VOCAB)
    for batch in (texts, texts[:1], [t for t in texts if t.isascii()]):
        j_ids, j_mask = jax_tok.encode_batch(jt, batch, max_len=max_len)
        p_ids, p_mask = port_tok.encode_batch(pt, batch, max_len=max_len)
        assert p_ids.dtype == j_ids.dtype and p_mask.dtype == j_mask.dtype
        np.testing.assert_array_equal(p_ids, j_ids)
        np.testing.assert_array_equal(p_mask, j_mask)


@pytest.mark.parametrize("budget", [16, 64, 256])
def test_pack_batch_identical(budget):
    jt = jax_tok.HashTokenizer(vocab_size=VOCAB)
    pt = port_tok.HashTokenizer(vocab_size=VOCAB)
    j_ids, j_seg, j_slots = jax_tok.pack_batch(jt, TEXTS, max_len=64, token_budget=budget)
    p_ids, p_seg, p_slots = port_tok.pack_batch(pt, TEXTS, max_len=64, token_budget=budget)
    np.testing.assert_array_equal(p_ids, j_ids)
    np.testing.assert_array_equal(p_seg, j_seg)
    assert p_slots == j_slots


def test_wordpiece_and_wire_dtypes_identical():
    vocab = {t: i for i, t in enumerate("[PAD] [UNK] [CLS] [SEP] the quick ##s fox".split())}
    j = jax_tok.WordPieceTokenizer(vocab)
    p = port_tok.WordPieceTokenizer(vocab)
    for text in ("the quicks fox", "unknown the", "THE Fox"):
        assert p.encode(text, max_len=4) == j.encode(text, max_len=4)
        assert p.encode_pair(text, "fox", max_len=16) == j.encode_pair(text, "fox", max_len=16)
    for size in (100, 40000, 70000):
        tok = port_tok.HashTokenizer(vocab_size=size)
        assert port_tok._wire_dtype(tok) == jax_tok._wire_dtype(jax_tok.HashTokenizer(vocab_size=size))
    assert port_tok.seq_bucket_length(51) == jax_tok.seq_bucket_length(51)
    assert port_tok.bucket_length(9) == jax_tok.bucket_length(9)


# -- forward -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_style", ["pre", "post"])
def test_forward_classic_matches_jax(dtype, norm_style):
    jc, pc = _configs(dtype, norm_style)
    jlm, plm = _models(jc, pc)
    tok = jax_tok.HashTokenizer(vocab_size=VOCAB)
    ids, mask = jax_tok.encode_batch(tok, TEXTS, max_len=64)
    want = np.asarray(jlm(ids, mask))
    got = plm(ids, mask).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    _assert_close(got, want, dtype, slice(0, len(TEXTS)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_style", ["pre", "post"])
def test_forward_packed_matches_jax(dtype, norm_style):
    jc, pc = _configs(dtype, norm_style)
    jlm, plm = _models(jc, pc, seed=1)
    tok = jax_tok.HashTokenizer(vocab_size=VOCAB)
    ids, seg, slots = jax_tok.pack_batch(tok, TEXTS, max_len=64, token_budget=48)
    want = np.asarray(jlm.encode_packed(ids, seg, jax_tok.PACK_MAX_SEGMENTS))
    got = plm.encode_packed(ids, seg, port_tok.PACK_MAX_SEGMENTS).numpy()
    assert got.shape == want.shape
    rows = tuple(np.array(slots).T)
    _assert_close(got, want, dtype, rows)
    empty = np.ones(got.shape[:2], dtype=bool)
    empty[rows] = False
    assert (got[empty] == 0).all()  # empty slots pool to zero


@pytest.mark.parametrize("causal", [False, True])
def test_forward_use_flash_on_cpu_takes_plain_flash(causal):
    jc, pc = _configs("float32", "pre", causal=causal)
    jlm, plm = _models(jc, pc, seed=2)
    tok = jax_tok.HashTokenizer(vocab_size=VOCAB)
    ids, mask = jax_tok.encode_batch(tok, TEXTS, max_len=64)
    want = np.asarray(
        jax_tf.forward(jlm.params, jc, ids.astype(np.int32), mask.astype(np.int32), use_flash=False)
    )
    got = plm(ids, mask, use_flash=True).numpy()
    _assert_close(got, want, "float32", slice(0, len(TEXTS)))


@pytest.mark.parametrize("pooling", ["cls", "none"])
def test_forward_pooling_modes_match_jax(pooling):
    jc, pc = _configs("float32", "pre", pooling=pooling)
    jlm, plm = _models(jc, pc, seed=3)
    tok = jax_tok.HashTokenizer(vocab_size=VOCAB)
    ids, mask = jax_tok.encode_batch(tok, TEXTS[:5], max_len=64)
    want = np.asarray(jlm(ids, mask))
    got = plm(ids, mask).numpy()
    assert got.shape == want.shape
    _assert_close(got, want, "float32", slice(0, 5))


def test_packed_positions_restart_per_segment():
    seg = np.array([[1, 1, 1, 2, 2, 0, 0], [1, 2, 2, 2, 3, 3, 3]], dtype=np.int32)
    want = np.asarray(jax_tf._packed_positions(jax.numpy.asarray(seg)))
    got = port_tf._packed_positions(torch.from_numpy(seg).long()).numpy()
    np.testing.assert_array_equal(got, want)


# -- weights -----------------------------------------------------------------


def test_params_from_jax_keeps_layout_and_rejects_unknown_keys():
    jc, pc = _configs("float32", "pre")
    params = jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jc))
    tree = params_from_jax(params)
    lm = port_tf.TransformerLM(pc, params=tree, device="cpu")
    got = lm.params
    assert got["layers"][1]["qkv"].shape == (64, 192)
    np.testing.assert_array_equal(got["layers"][0]["down"].numpy(), params["layers"][0]["down"])
    params["bogus"] = np.zeros(3)
    with pytest.raises(KeyError):
        params_from_jax(params)


def test_random_init_is_seeded_and_shaped_like_jax():
    jc, pc = _configs("float32", "pre")
    a = port_tf.init_params(torch.Generator().manual_seed(4), pc)
    b = port_tf.init_params(torch.Generator().manual_seed(4), pc)
    j = jax_tf.init_params(jax.random.PRNGKey(4), jc)
    flat_a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: tuple(t.shape), a))
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: tuple(t.shape), j))
    assert flat_a == flat_j
    assert torch.equal(a["embed"], b["embed"])


@pytest.fixture
def npz_checkpoint(tmp_path):
    """A tiny BERT-family checkpoint: config.json + weights.npz + vocab.txt."""
    rng = np.random.default_rng(0)
    vocab = "[PAD] [UNK] [CLS] [SEP] the quick brown fox jump ##s over lazy dog".split()
    h, m, layers = 32, 64, 2
    cfg = {
        "vocab_size": len(vocab), "hidden_size": h, "num_hidden_layers": layers,
        "num_attention_heads": 2, "intermediate_size": m, "max_position_embeddings": 32,
    }
    t = {
        "embeddings.word_embeddings.weight": rng.normal(size=(len(vocab), h)),
        "embeddings.position_embeddings.weight": rng.normal(size=(32, h)),
        "embeddings.token_type_embeddings.weight": rng.normal(size=(2, h)),
        "embeddings.LayerNorm.weight": 1 + 0.1 * rng.normal(size=h),
        "embeddings.LayerNorm.bias": 0.1 * rng.normal(size=h),
    }
    for i in range(layers):
        p = f"bert.encoder.layer.{i}."
        for name, shape in (
            ("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
            ("intermediate.dense", (m, h)), ("output.dense", (h, m)),
        ):
            t[p + name + ".weight"] = 0.1 * rng.normal(size=shape)
            t[p + name + ".bias"] = 0.1 * rng.normal(size=shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[p + name + ".weight"] = 1 + 0.1 * rng.normal(size=h)
            t[p + name + ".bias"] = 0.1 * rng.normal(size=h)
    t = {("bert." + k if not k.startswith("bert.") else k): v.astype(np.float32) for k, v in t.items()}
    np.savez(tmp_path / "weights.npz", **t)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return str(tmp_path)


def test_npz_checkpoint_loads_to_equal_embeddings(npz_checkpoint):
    jcfg, jparams = jax_hf.load_hf_encoder(npz_checkpoint, dtype="float32")
    pcfg, pparams = port_hf.load_hf_encoder(npz_checkpoint, dtype="float32")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for a, b in zip(jax.tree_util.tree_leaves(pparams), jax.tree_util.tree_leaves(bridged)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    texts = ["the quick brown fox", "jumps over the lazy dog", "fox"]
    jenc = JaxSentenceEncoder(npz_checkpoint)
    penc = SentenceEncoder(npz_checkpoint, device="cpu")
    assert type(penc.tokenizer).__name__ == "WordPieceTokenizer"
    # the checkpoint default is bf16 compute
    _assert_close(penc.encode(texts), np.asarray(jenc.encode(texts)), "bfloat16", slice(None))


# -- SentenceEncoder ---------------------------------------------------------


def _encoders(dtype="float32", max_len=64):
    jc, pc = _configs(dtype, "pre")
    jenc = JaxSentenceEncoder("enc-test", config=jc, max_len=max_len)
    penc = SentenceEncoder("enc-test", config=pc, max_len=max_len, device="cpu")
    penc.lm = port_tf.TransformerLM(
        pc, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jenc.lm.params)),
        device="cpu",
    )
    return jenc, penc


def test_sentence_encoder_paths_match_jax():
    jenc, penc = _encoders()
    got = penc.encode(TEXTS)
    assert got.shape == (len(TEXTS), 64)
    np.testing.assert_allclose(got, np.asarray(jenc.encode(TEXTS)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        penc.encode_packed(TEXTS), np.asarray(jenc.encode_packed(TEXTS)), atol=1e-4, rtol=0
    )
    np.testing.assert_allclose(penc.encode_one("fox"), jenc.encode_one("fox"), atol=1e-4, rtol=0)
    handle = penc.encode_submit(TEXTS[:3])
    np.testing.assert_array_equal(penc.encode_await(handle), got[:3])
    assert penc.encode([]).shape == (0, 64)


def test_sentence_encoder_cached_reuses_instance():
    a = SentenceEncoder.cached("cache-test", config=_configs("float32", "pre")[1], device="cpu")
    b = SentenceEncoder.cached("cache-test", config=_configs("float32", "pre")[1], device="cpu")
    assert a is b and a.dimension == 64
    assert os.path.basename(a.name) == "cache-test"
