"""`pw.load_yaml` in the port against the JAX package's, on the CPU.

* tests/test_misc.py's manifest loads in both packages to the same
  objects, each of its own package.
* chip_smoke.py's demo-question-answering app.yaml (`qa_app_yaml`, the
  manifest phase 14a serves on the card at full width) at a small size:
  a 2-layer encoder and the tiny decoder, the port's models on
  `device: cpu`. The two packages' manifests differ only by those
  `device: cpu` lines (the JAX package's models take no device). The
  port's encoder and decoder are given the JAX package's weights after
  loading, as tests/test_torch_docstore.py and tests/test_torch_rag.py
  give them, and each app is served over REST on a free port and asked
  the same questions through its package's RAGClient: the answers
  (replies, context documents and their metadata), /v1/retrieve and
  /v1/statistics must be equal, retrieval scores within 1e-4 absolute
  (the encoder tests' tolerance: two f32 encoders' sums in another
  order).
* No tag of a manifest loaded by the port resolves into `pathway_tpu`:
  every tag of the full-size manifest resolves inside
  `pathway_tpu_torch`, a tag that names `pathway_tpu` raises, and a
  process that loads a manifest through the port imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
from importlib import import_module

import jax
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.models.convert import decoder_params_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PACKAGES = {"jax": jpw, "port": tpw}
SCORE_ATOL = 1e-4
SERVE_SECONDS = 120.0

# the small app: 12 documents of 20-30 words, chunks of 20-30 tokens, k = 2
N_DOCS = 12
WORDS = (20, 30)
TOPK = 2
NEW_TOKENS = 4
ENCODER = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64,
               dtype="float32")


def _mod(name: str, path: str):
    return import_module(f"{PACKAGES[name].__name__}.{path}")


def test_yaml_loader_manifest_matches_jax():
    """tests/test_misc.py::test_yaml_loader's manifest."""
    manifest = textwrap.dedent(
        """
        $splitter: !pw.xpacks.llm.splitters.NullSplitter

        config:
          chunk_size: 100
          splitter: $splitter
        """
    )
    out = {name: pw.load_yaml(manifest) for name, pw in PACKAGES.items()}
    for name, got in out.items():
        assert set(got) == {"config"} and got["config"]["chunk_size"] == 100
        splitter = got["config"]["splitter"]
        assert isinstance(splitter, _mod(name, "xpacks.llm.splitters").NullSplitter)
    assert type(out["port"]["config"]["splitter"]).__module__.startswith("pathway_tpu_torch.")
    assert (out["port"]["config"]["splitter"].func(["a b"], [None])
            == out["jax"]["config"]["splitter"].func(["a b"], [None]))


def test_yaml_variables_lists_and_scalars_match_jax():
    manifest = textwrap.dedent(
        """
        $rows:
          - [1, x]
          - [2, y]
        $markdown: |
          a | b
          1 | x
          2 | y
        table: !pw.debug.table_from_markdown $markdown
        names: [$rows, plain, 3]
        nothing: !pw.xpacks.llm.parsers.Utf8Parser
        """
    )
    out = {}
    for name, pw in PACKAGES.items():
        pw.G.clear()
        try:
            got = pw.load_yaml(manifest)
            (cap,) = _mod(name, "internals.runner").run_tables(got["table"])
        finally:
            pw.G.clear()
        assert type(got["nothing"]).__name__ == "Utf8Parser"
        out[name] = (sorted(cap.state.rows.values()), got["names"], sorted(got))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(1, "x"), (2, "y")]


# -- the demo-question-answering app at a small size ---------------------------


def _manifest(name: str, docs_dir: str, port: int) -> str:
    config = ", ".join(f"{k}: {v}" for k, v in ENCODER.items())
    embedder = {
        "model": "yaml-app-encoder",
        "config": f"!pw.models.transformer.TransformerConfig {{{config}}}",
        "max_len": ENCODER["max_len"],
        "seed": 3,
    }
    generator = {"model": "yaml-app-decoder", "max_len": 128}
    if name == "port":
        embedder["device"] = generator["device"] = "cpu"
    return chip_smoke.qa_app_yaml(
        docs_dir, port, embedder=embedder, generator=generator, reserved_space=64,
        dimensions=ENCODER["hidden"], splitter=WORDS, search_topk=TOPK,
        max_new_tokens=NEW_TOKENS,
    )


def test_the_two_manifests_differ_only_by_the_device_lines(tmp_path):
    jax_text = _manifest("jax", str(tmp_path), 8000)
    port_lines = _manifest("port", str(tmp_path), 8000).splitlines()
    assert [line for line in port_lines if line.strip() != "device: cpu"] == jax_text.splitlines()
    assert len(port_lines) == len(jax_text.splitlines()) + 2


def _jax_weights(config: dict):
    """The decoder weights both apps answer with: the JAX package's tiny
    decoder at its cached seed, dense weights scaled by 10 so that a
    greedy reply depends on its prompt (tests/test_torch_rag.py)."""
    jm = import_module("pathway_tpu.models.decoder_lm").ChatModel("yaml-app-decoder", **config)
    return jax.tree_util.tree_map(lambda x: x * 10 if x.ndim == 2 else x, jm.params)


def _share_weights(apps: dict) -> None:
    """Give the port's loaded models the JAX package's weights."""
    jqa, pqa = apps["jax"]["question_answerer"], apps["port"]["question_answerer"]
    jenc = jqa.indexer.retriever_factory.embedder.encoder
    penc = pqa.indexer.retriever_factory.embedder.encoder
    port_tf = import_module("pathway_tpu_torch.models.transformer")
    penc.lm = port_tf.TransformerLM(
        port_tf.TransformerConfig(**dataclasses.asdict(jenc.config)),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jenc.lm.params)),
        device="cpu",
    )
    params = _jax_weights({"max_len": 128})
    jqa.llm.generator.params = params
    pqa.llm.generator.params = decoder_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _norm_doc(d: dict) -> dict:
    # seen_at is the reader's clock, in seconds
    meta = {k: v for k, v in d.get("metadata", {}).items() if k != "seen_at"}
    return {**d, "metadata": meta}


def _norm_answer(a):
    if isinstance(a, dict) and "context_docs" in a:
        return {**a, "context_docs": [_norm_doc(d) for d in a["context_docs"]]}
    if isinstance(a, list):
        return [_norm_doc(d) for d in a]
    return a


def _serve(name: str, app: dict, queries, probe: str) -> list:
    """The app served as chip_smoke.serve_declared_app serves it: the
    routes of question_answerer.build_server(host, port), run_server on a
    thread, every doc counted, then the questions."""
    qa_mod = _mod(name, "xpacks.llm.question_answering")
    runner = _mod(name, "internals.runner")
    qa = app["question_answerer"]
    qa.build_server(app["host"], app["port"])
    server = qa.run_server(threaded=True)
    client = qa_mod.RAGClient(app["host"], app["port"], timeout=60)
    try:
        deadline = time.monotonic() + SERVE_SECONDS
        while True:  # the routes register once the engine runs
            assert server.is_alive(), f"the {name} app's engine stopped"
            try:
                stats = client.statistics()
                if stats and stats.get("file_count") == N_DOCS:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert time.monotonic() < deadline, f"the {name} app did not count its docs"
            time.sleep(0.05)
        assert client.retrieve(probe, k=1)[0]["text"] == probe
        out = [stats["file_count"]]
        for q in queries:
            out.append(_norm_answer(client.answer(q, return_context_docs=True)))
            out.append(_norm_answer(client.retrieve(q, k=TOPK)))
        results = [None] * len(queries)

        def one(i: int) -> None:
            results[i] = _norm_answer(client.answer(queries[i]))

        threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_SECONDS)
        assert not any(t.is_alive() for t in threads), f"a concurrent {name} answer did not return"
        return out + results
    finally:
        engine = runner.last_engine()
        if engine is not None:
            engine.terminate_flag.set()
        server.join(SERVE_SECONDS)
        assert not server.is_alive(), f"the {name} app's engine did not stop"
        PACKAGES[name].G.clear()
        # the JAX package's serving tier keeps one micro-batcher per route
        # for the life of the process, bound to the route's first connector
        _mod(name, "internals.serving").reset_for_tests()


def _assert_agree(got, want) -> None:
    """Equal but for the scores, which agree within SCORE_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            if k in ("score", "dist"):
                assert abs(got[k] - want[k]) <= SCORE_ATOL, (k, got[k], want[k])
            else:
                _assert_agree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_agree(g, w)
    else:
        assert got == want


def test_declared_qa_app_serves_what_the_jax_package_serves(tmp_path):
    import random

    docs = chip_smoke.qa_docs(N_DOCS, random.Random(31), WORDS)
    docs_dir = str(tmp_path / "documents")
    chip_smoke.write_text_docs(docs, docs_dir)
    apps = {}
    for name, pw in PACKAGES.items():
        pw.G.clear()
        apps[name] = pw.load_yaml(_manifest(name, docs_dir, chip_smoke._free_port()))
    _share_weights(apps)
    port_gen = apps["port"]["question_answerer"].llm.generator
    assert port_gen.device.type == "cpu"
    assert apps["port"]["question_answerer"].indexer.retriever_factory.embedder.encoder.device.type == "cpu"
    queries = [docs[3], "vector index latency join", docs[7][:60]]
    served = {name: _serve(name, apps[name], queries, docs[-1]) for name in ("port", "jax")}
    _assert_agree(served["port"], served["jax"])
    answers = [a for a in served["port"][1:] if isinstance(a, dict)]
    assert len(answers) == 2 * len(queries) and any(a["response"] for a in answers)
    first = served["port"][1]
    assert len(first["context_docs"]) == TOPK and first["context_docs"][0]["text"] == docs[3]
    # the served reply is generate() on the prompt the app built
    prompt = chip_smoke._rag_prompts([queries[0]], [first["context_docs"]])[0]
    assert first["response"] == port_gen.generate([prompt], max_new_tokens=NEW_TOKENS)[0]


# -- no tag reaches the JAX package ----------------------------------------------


def _full_size_manifest() -> str:
    """chip_smoke.py's phase-14a manifest, as it is loaded on the card."""
    return chip_smoke.qa_app_yaml(
        "/data/documents", 8000,
        embedder={"model": "all-MiniLM-L6-v2", "max_len": 512},
        generator={"model": "mistral-7b", "max_len": chip_smoke.QA_DECODER_LEN},
        reserved_space=chip_smoke.N_QA_DOCS, dimensions=chip_smoke.DIM,
    )


def _tags(value):
    yl = import_module("pathway_tpu_torch.internals.yaml_loader")
    if isinstance(value, yl._Tagged):
        yield value.path
        yield from _tags(value.value)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tags(v)
    elif isinstance(value, list):
        for v in value:
            yield from _tags(v)


def test_every_tag_of_the_card_manifest_resolves_inside_the_port():
    import yaml

    yl = import_module("pathway_tpu_torch.internals.yaml_loader")
    raw = yaml.load(_full_size_manifest(), Loader=yl._Loader)  # noqa: S506 — SafeLoader subclass
    tags = sorted(set(_tags(raw)))
    assert len(tags) == 9, tags
    for tag in tags:
        obj = yl._resolve_dotted(tag)
        module = getattr(obj, "__module__", None) or type(obj).__module__
        assert module.startswith("pathway_tpu_torch."), (tag, module)


@pytest.mark.parametrize("tag", ["pathway_tpu.io.fs.read", "pathway_tpu.xpacks.llm.splitters.NullSplitter",
                                 "pathway_tpu"])
def test_a_tag_naming_the_jax_package_raises(tag):
    with pytest.raises(ImportError, match="does not import pathway_tpu"):
        tpw.load_yaml(f"x: !{tag}\n")


def test_loading_manifests_through_the_port_imports_no_jax(tmp_path):
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import yaml
        import chip_smoke
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals import yaml_loader as yl

        out = pw.load_yaml("$s: !pw.xpacks.llm.splitters.TokenCountSplitter\\n  max_tokens: 9\\n"
                           "splitter: $s\\n")
        assert type(out["splitter"]).__module__ == "pathway_tpu_torch.xpacks.llm.splitters"
        raw = yaml.load(chip_smoke.qa_app_yaml("/d", 1, embedder={{"model": "m"}},
                                               generator={{"model": "g"}}, reserved_space=1,
                                               dimensions=1), Loader=yl._Loader)
        def walk(v):
            if isinstance(v, yl._Tagged):
                yl._resolve_dotted(v.path)
                walk(v.value)
            elif isinstance(v, dict):
                [walk(x) for x in v.values()]
            elif isinstance(v, list):
                [walk(x) for x in v]
        walk(raw)
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                     or m == "pathway_tpu" or m.startswith("pathway_tpu."))
        assert not bad, bad
        """
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
