"""The port's KV-cached decoder against the JAX package's.

Both packages get the same weights (the JAX tree carried over with
`decoder_params_from_jax`) and the same inputs, made by numpy from a
seed. On the CPU the port's flash wrapper runs its plain version and the
JAX side runs its Pallas kernel in interpret mode. Three configs: `TINY`
(head dim 16), a small config at the decoder's head dim 128 and one at
head dim 256 (hidden 512, 2 q heads, 1 kv head).

Tolerances: f32 logits within 1e-4 absolute (logits of order 1, sums of
at most 512 terms taken in another order by XLA and by torch); greedy
tokens identical.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import hf_loader as jhf
from pathway_tpu.models import transformer as jtr
from pathway_tpu.models.transformer import TINY_DECODER as J_TINY_DECODER
from pathway_tpu.models.transformer import TransformerLM as JTransformerLM
from pathway_tpu.ops.kernels import flash_attention as jax_flash
from pathway_tpu_torch.models import decoder as dec
from pathway_tpu_torch.models import hf_loader
from pathway_tpu_torch.models import transformer as tr
from pathway_tpu_torch.models.convert import decoder_params_from_jax, params_from_jax
from pathway_tpu_torch.models.decoder_lm import ChatModel
from pathway_tpu_torch.models.transformer import TINY_DECODER, TransformerLM
from pathway_tpu_torch.ops.kernels import flash_attention

HD128 = dict(
    vocab_size=512, hidden=256, layers=2, q_heads=2, kv_heads=1,
    mlp_dim=512, max_len=64, dtype="float32",
)
# heads of 256, the card's largest flash instance (no model the JAX package
# configures has heads above 128; this one holds the port there)
HD256 = dict(HD128, hidden=512)
CONFIGS = {
    "tiny": (jdec.TINY, dec.TINY),
    "hd128": (jdec.DecoderConfig(**HD128), dec.DecoderConfig(**HD128)),
    "hd256": (jdec.DecoderConfig(**HD256), dec.DecoderConfig(**HD256)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = CONFIGS[request.param]
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    tparams = decoder_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), max(lengths)), dtype=np.int32)
    mask = np.zeros_like(ids)
    for r, n in enumerate(lengths):
        ids[r, :n] = rng.integers(1, vocab, size=n)
        mask[r, :n] = 1
    return ids, mask


def test_config_geometry_matches_jax():
    assert dec.MISTRAL_7B_DECODER == dec.DecoderConfig(**vars(jdec.MISTRAL_7B_DECODER))
    assert dec.TINY == dec.DecoderConfig(**vars(jdec.TINY))
    assert dec.MISTRAL_7B_DECODER.head_dim == 128
    assert CONFIGS["hd128"][1].head_dim == 128
    assert CONFIGS["hd256"][1].head_dim == 256
    for name in ("MISTRAL_7B", "TINY_DECODER"):
        assert vars(getattr(tr, name)) == vars(getattr(jtr, name)), name


@pytest.mark.parametrize("use_flash", [False, True])
def test_cacheless_forward_matches_jax(model, use_flash):
    jcfg, tcfg, jparams, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (11, 7, 4), seed=1)
    want, _ = jdec.decoder_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), use_flash=use_flash
    )
    before = flash_attention.launches
    got, cache = dec.decoder_forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), use_flash=use_flash
    )
    assert flash_attention.launches == before  # the plain version is no launch
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (3, 11, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_prefill_into_the_cache_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (9, 5), seed=2)
    positions = np.cumsum(mask, axis=1) - 1
    kv_valid = np.zeros((2, tcfg.max_len), dtype=np.int32)
    kv_valid[:, : ids.shape[1]] = mask
    want, jcache = jdec.decoder_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        positions=jnp.asarray(positions), kv_cache=jdec.init_kv_cache(jcfg, 2),
        kv_valid=jnp.asarray(kv_valid), slot_offset=0, use_flash=True,
    )
    cache = dec.init_kv_cache(tcfg, 2)
    got, same = dec.decoder_forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        positions=torch.from_numpy(positions), kv_cache=cache,
        kv_valid=torch.from_numpy(kv_valid), slot_offset=0, use_flash=True,
    )
    assert same is cache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for layer, jlayer in zip(cache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name].numpy(), np.asarray(jlayer[name]), atol=1e-5, rtol=0
            )


def test_decode_step_matches_jax(model):
    """One cached decode step after the prefill: dense f32 attention over
    the cache, grouped per kv head, bounded to the written slots."""
    jcfg, tcfg, jparams, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (6, 8, 3), seed=3)
    l = ids.shape[1]
    kv_valid = np.zeros((3, tcfg.max_len), dtype=np.int32)
    kv_valid[:, :l] = mask
    positions = np.cumsum(mask, axis=1) - 1
    jcache = jdec.init_kv_cache(jcfg, 3)
    _, jcache = jdec.decoder_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), positions=jnp.asarray(positions),
        kv_cache=jcache, kv_valid=jnp.asarray(kv_valid), slot_offset=0,
    )
    cache = dec.init_kv_cache(tcfg, 3)
    dec.decoder_forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        positions=torch.from_numpy(positions), kv_cache=cache,
        kv_valid=torch.from_numpy(kv_valid), slot_offset=0,
    )
    kv_valid[:, l] = 1
    tok = np.array([[5], [9], [13]], dtype=np.int32)
    pos = mask.sum(axis=1)[:, None]
    want, _ = jdec.decoder_forward(
        jparams, jcfg, jnp.asarray(tok), jnp.ones((3, 1), jnp.int32), positions=jnp.asarray(pos),
        kv_cache=jcache, kv_valid=jnp.asarray(kv_valid), slot_offset=l,
    )
    got, _ = dec.decoder_forward(
        tparams, tcfg, torch.from_numpy(tok), torch.ones((3, 1), dtype=torch.int32),
        positions=torch.from_numpy(pos), kv_cache=cache,
        kv_valid=torch.from_numpy(kv_valid), slot_offset=l,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_greedy_tokens_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (5, 9, 3), seed=4)
    want = jdec.generate_tokens(jparams, jcfg, ids, mask, max_new_tokens=6)
    got = dec.generate_tokens(tparams, tcfg, ids, mask, max_new_tokens=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_static_decode_tokens_match_jax(model):
    """The static decode step (`DecodeGraphs`, uncaptured on the CPU)
    picks the JAX package's greedy tokens."""
    jcfg, tcfg, jparams, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (5, 9, 3), seed=4)
    want = jdec.generate_tokens(jparams, jcfg, ids, mask, max_new_tokens=6)
    got = dec.generate_tokens(tparams, tcfg, ids, mask, max_new_tokens=6,
                              graphs=dec.DecodeGraphs(tparams, tcfg))
    np.testing.assert_array_equal(got, np.asarray(want))


def _naive_generate_row(params, config, row_ids, steps):
    """One unpadded row, the whole prefix recomputed each step."""
    ids = list(row_ids)
    out = []
    for _ in range(steps):
        a = torch.tensor([ids])
        logits, _ = dec.decoder_forward(params, config, a, torch.ones_like(a), use_flash=False)
        out.append(int(logits[0, -1].argmax()))
        ids.append(out[-1])
    return out


def test_cached_generation_matches_naive_recompute(model):
    _, tcfg, _, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (5, 9, 3), seed=5)
    toks = dec.generate_tokens(tparams, tcfg, ids, mask, max_new_tokens=6)
    for r in range(len(ids)):
        row = ids[r, : mask[r].sum()]
        assert list(toks[r]) == _naive_generate_row(tparams, tcfg, row, 6), r


def test_sampling_is_seeded_and_in_vocab(model):
    _, tcfg, _, tparams = model
    ids, mask = _prompts(tcfg.vocab_size, (4, 6), seed=6)
    a = dec.generate_tokens(tparams, tcfg, ids, mask, max_new_tokens=5, temperature=0.8, seed=3)
    b = dec.generate_tokens(tparams, tcfg, ids, mask, max_new_tokens=5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and (a >= 0).all() and (a < tcfg.vocab_size).all()


def test_gqa_head_broadcast_shapes():
    config = dec.DecoderConfig(
        vocab_size=64, hidden=32, layers=1, q_heads=8, kv_heads=2,
        mlp_dim=64, max_len=32, dtype="float32",
    )
    params = dec.init_decoder_params(torch.Generator().manual_seed(1), config)
    assert params["layers"][0]["wk"].shape == (32, 8)  # 2 kv heads of 4
    assert "lm_head" not in params and params["ln_f"].dtype == torch.float32
    ids = torch.ones((2, 8), dtype=torch.int32)
    logits, _ = dec.decoder_forward(params, config, ids, torch.ones_like(ids), use_flash=False)
    assert logits.shape == (2, 8, 64) and torch.isfinite(logits).all()


def test_bf16_params_are_stored_in_bf16_with_f32_norms():
    config = dec.DecoderConfig(
        vocab_size=64, hidden=32, layers=1, q_heads=4, kv_heads=2,
        mlp_dim=64, max_len=32, dtype="bfloat16",
    )
    params = dec.init_decoder_params(torch.Generator().manual_seed(0), config)
    assert params["embed"].dtype == params["layers"][0]["down"].dtype == torch.bfloat16
    assert params["layers"][0]["ln1"].dtype == torch.float32
    ids = torch.arange(10).reshape(1, 10)
    logits, _ = dec.decoder_forward(params, config, ids, torch.ones_like(ids))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_generate_rejects_cache_overflow():
    params = dec.init_decoder_params(torch.Generator().manual_seed(0), dec.TINY)
    ids = np.ones((1, 120), dtype=np.int32)
    with pytest.raises(ValueError, match="cache budget"):
        dec.generate_tokens(params, dec.TINY, ids, np.ones_like(ids), max_new_tokens=16)


def test_chat_model_truncates_keeping_tail():
    cm = ChatModel("tiny-decoder", max_len=128, device="cpu")
    assert cm.config == dec.TINY and cm.device.type == "cpu"
    words = [f"tok{i}" for i in range(300)]
    out = cm.generate([" ".join(words), "short"], max_new_tokens=8)
    assert len(out) == 2 and all(isinstance(s, str) for s in out)
    # one token per word, budget 128 - 8 = 120: the kept context is exactly
    # the tail of the hashed prompt
    ids, _ = cm.encode_prompts([" ".join(words)], 8)
    assert ids.shape[1] == 120
    assert list(ids[0]) == cm.tokenizer.encode(" ".join(words))[-120:]
    budget = cm.config.max_len - 8
    assert out[0] == cm.generate([" ".join(words[-budget:])], max_new_tokens=8)[0]


def test_chat_model_rejects_zero_budget():
    cm = ChatModel("tiny-decoder", device="cpu")
    with pytest.raises(ValueError, match="no cache room"):
        cm.generate(["x"], max_new_tokens=cm.config.max_len)
    assert cm.generate([], max_new_tokens=4) == []


def test_chat_model_picks_the_config_by_name_and_caches():
    assert ChatModel.cached("tiny-decoder", device="cpu") is ChatModel.cached(
        "tiny-decoder", device="cpu"
    )
    geometry = dec.MISTRAL_7B_DECODER
    small = dec.DecoderConfig(**{**vars(geometry), "layers": 1, "hidden": 64, "q_heads": 4,
                                 "kv_heads": 1, "mlp_dim": 64, "vocab_size": 100, "max_len": 32})
    cm = ChatModel("my-mistral", config=small, device="cpu")
    assert cm.config is small and cm.params["embed"].dtype == torch.bfloat16


def test_chat_model_generates_what_generate_tokens_does():
    cm = ChatModel("tiny-decoder", seed=4, device="cpu")
    prompts = ["hello world", "stream processing on the card"]
    ids, mask = cm.encode_prompts(prompts, 5)
    toks = dec.generate_tokens(cm.params, cm.config, ids, mask, max_new_tokens=5)
    assert cm.generate(prompts, max_new_tokens=5) == [cm.tokenizer.decode(r) for r in toks]


def _write_llama_npz(path, tied: bool, seed=0):
    rng = np.random.default_rng(seed)
    v, h, kv, m, layers = 96, 32, 16, 64, 2
    cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": v, "hidden_size": h, "intermediate_size": m,
        "num_hidden_layers": layers, "num_attention_heads": 4,
        "num_key_value_heads": 2, "max_position_embeddings": 64,
        "rms_norm_eps": 1e-6, "rope_theta": 500.0,
    }
    tensors = {
        "model.embed_tokens.weight": rng.normal(0, 0.1, (v, h)),
        "model.norm.weight": 1.0 + rng.normal(0, 0.1, (h,)),
    }
    if not tied:
        tensors["lm_head.weight"] = rng.normal(0, 0.1, (v, h))
    for i in range(layers):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = 1.0 + rng.normal(0, 0.1, (h,))
        tensors[p + "post_attention_layernorm.weight"] = 1.0 + rng.normal(0, 0.1, (h,))
        for name, shape in (("q", (h, h)), ("k", (kv, h)), ("v", (kv, h)), ("o", (h, h))):
            tensors[p + f"self_attn.{name}_proj.weight"] = rng.normal(0, 0.1, shape)
        for name, shape in (("gate", (m, h)), ("up", (m, h)), ("down", (h, m))):
            tensors[p + f"mlp.{name}_proj.weight"] = rng.normal(0, 0.1, shape)
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "weights.npz", **{k: a.astype(np.float32) for k, a in tensors.items()})
    return str(path)


@pytest.mark.parametrize("tied", [False, True])
def test_load_hf_decoder_matches_jax(tmp_path, tied):
    path = _write_llama_npz(tmp_path / "ckpt", tied)
    assert hf_loader.is_decoder_checkpoint(path) and jhf.is_decoder_checkpoint(path)
    assert not hf_loader.is_decoder_checkpoint(str(tmp_path))
    jcfg, jparams = jhf.load_hf_decoder(path, dtype="float32")
    tcfg, tparams = hf_loader.load_hf_decoder(path, dtype="float32")
    assert dec.DecoderConfig(**vars(jcfg)) == tcfg
    assert ("lm_head" in tparams) == (not tied)
    carried = decoder_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), carried))
    for a, b in zip(flat, jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tparams))):
        np.testing.assert_array_equal(a, b)
    ids, mask = _prompts(96, (9, 6), seed=7)
    want, _ = jdec.decoder_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), use_flash=False)
    got, _ = dec.decoder_forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_load_hf_decoder_bf16_keeps_norms_and_embed_f32(tmp_path):
    path = _write_llama_npz(tmp_path / "ckpt", tied=False)
    config, params = hf_loader.load_hf_decoder(path)
    assert config.dtype == "bfloat16"
    assert params["layers"][1]["wq"].dtype == torch.bfloat16
    assert params["layers"][1]["wq"].shape == (32, 32)  # transposed onto x @ W
    assert params["embed"].dtype == params["lm_head"].dtype == params["ln_f"].dtype == torch.float32
    cm = ChatModel(path, max_len=16, device="cpu")
    assert cm.config == config and len(cm.generate(["a b c"], max_new_tokens=3)) == 1
    with pytest.raises(ValueError, match="not both"):
        ChatModel(path, config=config, device="cpu")


def test_decoder_params_from_jax_checks_keys():
    tree = jax.tree_util.tree_map(
        np.asarray, jdec.init_decoder_params(jax.random.PRNGKey(0), jdec.TINY)
    )
    with pytest.raises(KeyError, match="unknown"):
        decoder_params_from_jax({**tree, "pos_embed": tree["embed"]})
    bad = dict(tree, layers=[dict(tree["layers"][0], qkv=tree["embed"])])
    with pytest.raises(KeyError, match="layer 0"):
        decoder_params_from_jax(bad)
    bf16 = jax.tree_util.tree_map(
        np.asarray, jdec.init_decoder_params(jax.random.PRNGKey(0), _bf16_config())
    )
    out = decoder_params_from_jax(bf16)
    assert out["layers"][0]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["layers"][0]["wq"].float().numpy(), bf16["layers"][0]["wq"].astype(np.float32)
    )


def _bf16_config():
    return jdec.DecoderConfig(
        vocab_size=64, hidden=32, layers=1, q_heads=4, kv_heads=2,
        mlp_dim=64, max_len=32, dtype="bfloat16",
    )


def test_transformer_generate_matches_jax():
    jlm = JTransformerLM(J_TINY_DECODER, seed=0)
    lm = TransformerLM(
        TINY_DECODER, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params)),
        device="cpu",
    )
    ids, mask = _prompts(TINY_DECODER.vocab_size, (7, 3, 12), seed=8)
    want = jlm.generate(ids.copy(), mask.copy(), max_new_tokens=8)
    got = lm.generate(ids, mask, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert mask.sum() == 22  # the caller's arrays are left as they were


def test_transformer_generate_grows_then_stops_at_max_len():
    jlm = JTransformerLM(J_TINY_DECODER, seed=1)
    lm = TransformerLM(
        TINY_DECODER, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params)),
        device="cpu",
    )
    ids, mask = _prompts(TINY_DECODER.vocab_size, (120, 30), seed=9)
    want = jlm.generate(ids.copy(), mask.copy(), max_new_tokens=12)
    got = lm.generate(ids, mask, max_new_tokens=12)
    assert got.shape == np.asarray(want).shape and got.shape[1] < 12  # stopped at the table
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("lq, lk, causal", [(40, 40, True), (1, 70, False), (24, 56, False)])
def test_flash_plain_at_head_dim_128_matches_jax_kernel(lq, lk, causal):
    rng = np.random.default_rng(lq + lk)
    q = rng.normal(size=(2, 3, lq, 128)).astype(np.float32)
    k = rng.normal(size=(2, 3, lk, 128)).astype(np.float32)
    v = rng.normal(size=(2, 3, lk, 128)).astype(np.float32)
    mask = np.ones((2, lk), dtype=np.int32)
    mask[1, lk - lk // 3:] = 0  # ragged, as left-aligned prompts
    want = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                  causal=causal, block_q=16, block_k=16)
    )
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), causal=causal,
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fast_tokenizer_matches_jax_and_chat_model_picks_it(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    from pathway_tpu.models.tokenizer import FastTokenizer as JFastTokenizer
    from pathway_tpu_torch.models.tokenizer import FastTokenizer

    tok = tokenizers.Tokenizer(BPE(unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(
        ["the quick brown fox jumps over the lazy dog"] * 4,
        BpeTrainer(vocab_size=90, special_tokens=["<unk>", "<s>", "</s>"]),
    )
    path = _write_llama_npz(tmp_path / "ckpt", tied=True)
    tok.save(str(tmp_path / "ckpt" / "tokenizer.json"))
    ours, theirs = FastTokenizer(path + "/tokenizer.json"), JFastTokenizer(path + "/tokenizer.json")
    text = "the lazy fox jumps"
    assert ours.encode(text) == theirs.encode(text) and ours.encode(text, 2) == theirs.encode(text, 2)
    assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    assert (ours.vocab_size, ours.pad_id) == (theirs.vocab_size, theirs.pad_id)
    chat = ChatModel(path, max_len=16, device="cpu")
    assert isinstance(chat.tokenizer, FastTokenizer)
    assert len(chat.generate(["the quick brown"], max_new_tokens=3)) == 1


# -- the static decode step (DecodeGraphs) against the eager loop ----------------------
#
# On the card DecodeGraphs replays captured graphs of the static step; here
# the same step runs eagerly, with the same static shapes: it attends over a
# bucket of slots (multiples of 512, so these configs' max_len of 1,100 makes
# the buckets 512 and 1,024 ... 1,100), its slot a device tensor. Masked
# slots weigh exactly 0, so only the order of the sums differs from the
# eager loop: f32 logits within 1e-5; in bf16 a product rounded the other
# way moves them by about one bf16 step (2^-7 at magnitude 1); tokens equal.

STATIC = {
    "tiny": dataclasses.replace(dec.TINY, max_len=1100),
    "bf16x4": dec.DecoderConfig(vocab_size=512, hidden=64, layers=4, q_heads=4, kv_heads=2,
                                mlp_dim=128, max_len=1100, dtype="bfloat16"),
}
# batch 1, 3 and 16; the two longer sets decode across slot 512
STATIC_LENGTHS = {"b1": (9,), "b3-across": (500, 3, 505), "b16-across": tuple(range(490, 506))}


@pytest.fixture(scope="module", params=sorted(STATIC))
def static_model(request):
    config = STATIC[request.param]
    return config, dec.init_decoder_params(torch.Generator().manual_seed(0), config)


@pytest.mark.parametrize("lengths", sorted(STATIC_LENGTHS))
def test_static_decode_generates_what_the_eager_loop_does(static_model, lengths):
    config, params = static_model
    ids, mask = _prompts(config.vocab_size, STATIC_LENGTHS[lengths], seed=len(lengths))
    new = 16
    want = dec.generate_tokens(params, config, ids, mask, max_new_tokens=new)
    graphs = dec.DecodeGraphs(params, config)
    got = dec.generate_tokens(params, config, ids, mask, max_new_tokens=new, graphs=graphs)
    np.testing.assert_array_equal(got, want)
    l = ids.shape[1]
    buckets = {dec.decode_bucket(l + t + 1, config.max_len) for t in range(new - 1)}
    assert len(buckets) == (2 if lengths.endswith("across") else 1)
    assert graphs.rows == len(ids) and not graphs.graphs  # nothing captured on the CPU


@pytest.mark.parametrize("lengths", sorted(STATIC_LENGTHS))
def test_static_decode_step_logits_match_the_eager_step(static_model, lengths):
    """Step by step on one prefilled cache: the static step (a device
    slot, the bucket's slots) against the eager step (a host slot, the
    slots up to it), logits and cache within 1e-5 in f32 (2^-7 in bf16).
    The static step's copy holds garbage, marked valid, in the slots past
    its own: they must stay dead."""
    config, params = static_model
    tol = dict(atol=1e-5, rtol=0) if config.dtype == "float32" else dict(atol=2**-7, rtol=2**-7)
    ids, mask = (torch.from_numpy(a).long()
                 for a in _prompts(config.vocab_size, STATIC_LENGTHS[lengths], seed=2))
    b, l = ids.shape
    cache = dec.init_kv_cache(config, b)
    kv_valid = torch.zeros((b, config.max_len), dtype=torch.int32)
    kv_valid[:, :l] = mask
    lengths_ = mask.sum(1)
    with torch.no_grad():
        dec.decoder_forward(params, config, ids, mask, positions=mask.cumsum(1) - 1,
                            kv_cache=cache, kv_valid=kv_valid)
        tok = ids[:, :1]
        for t in range(12):
            kv_valid[:, l + t] = 1
            static = [{k: x.clone() for k, x in layer.items()} for layer in cache]
            for layer in static:
                for x in layer.values():
                    x[:, :, l + t + 1 :] = torch.randn(x[:, :, l + t + 1 :].shape)
            stale = kv_valid.clone()
            stale[:, l + t + 1 :] = 1
            positions = (lengths_ + t)[:, None]
            want, _ = dec.decoder_forward(params, config, tok, torch.ones_like(tok),
                                          positions=positions, kv_cache=cache,
                                          kv_valid=kv_valid, slot_offset=l + t)
            got, _ = dec.decoder_forward(params, config, tok, torch.ones_like(tok),
                                         positions=positions, kv_cache=static, kv_valid=stale,
                                         slot_offset=torch.tensor([l + t]),
                                         end=dec.decode_bucket(l + t + 1, config.max_len))
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
            for a, c in zip(cache, static):
                for k in ("k", "v"):
                    np.testing.assert_allclose(c[k][:, :, : l + t + 1].float().numpy(),
                                               a[k][:, :, : l + t + 1].float().numpy(), **tol)
            tok = want[:, 0].argmax(-1)[:, None]


def test_decode_graphs_keep_one_storage_and_stale_slots_dead(static_model):
    """Consecutive calls of other batches and lengths on one DecodeGraphs:
    its storage grows to the largest batch and is then reused in place,
    and slots an earlier, longer call wrote stay dead in a later one."""
    config, params = static_model
    graphs = dec.DecodeGraphs(params, config)
    calls = [(500, 3, 505), tuple(range(490, 506)), (40, 7, 12), (300,) * 2, (1000, 990, 3)]
    pointers = []
    for i, lengths in enumerate(calls):
        ids, mask = _prompts(config.vocab_size, lengths, seed=10 + i)
        want = dec.generate_tokens(params, config, ids, mask, max_new_tokens=8)
        got = dec.generate_tokens(params, config, ids, mask, max_new_tokens=8, graphs=graphs)
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        # live: each row's prompt, then the slots of the 7 decode steps
        l = ids.shape[1]
        live = np.concatenate([mask, np.ones((len(ids), 7), np.int32),
                               np.zeros((len(ids), config.max_len - l - 7), np.int32)], axis=1)
        np.testing.assert_array_equal(graphs.kv_valid[: len(ids)].numpy(), live, err_msg=str(i))
        pointers.append(graphs.cache[0]["k"].data_ptr())
    assert graphs.rows == 16
    assert pointers[0] != pointers[1] and len(set(pointers[1:])) == 1


def test_static_decode_leaves_tp_lists_and_sampling_to_the_eager_loop(static_model):
    """A sampled call ignores the graphs: the same draws as without them,
    and the storage never made."""
    config, params = static_model
    graphs = dec.DecodeGraphs(params, config)
    ids, mask = _prompts(config.vocab_size, (5, 9), seed=6)
    kw = dict(max_new_tokens=5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(
        dec.generate_tokens(params, config, ids, mask, graphs=graphs, **kw),
        dec.generate_tokens(params, config, ids, mask, **kw))
    assert graphs.rows == 0
