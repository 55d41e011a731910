"""A checkout-like tree with toy cells, for the CPU tests.

`toy_tree(tmp)` copies the benchmark into `tmp` and adds, as a later change
would, files and entries only: two toy configurations (a small BERT
encoder and a small Mistral-layout decoder, float32), their traffic
mixes, their cells and a toy per-layer metric. `drive(root, workload)`
runs one cell there on the CPU, past the harness's look for a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TOY_ENCODER = {
    "model_name": "toy-encoder", "architectures": ["BertModel"], "model_type": "bert",
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
    "hidden_act": "gelu", "vocab_size": 1000, "max_position_embeddings": 64, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "torch_dtype": "float32", "max_seq_length": 32, "pooling": "mean",
    "normalize": True,
    "index": {"factory": "BruteForceKnnFactory", "metric": "cos", "dimensions": 32,
              "reserved_space": 4096},
    "limits": {"embed_gap": 1e-4, "search_gap_mean": 1e-4, "score_err_mean": 1e-4},
}
TOY_DECODER = {
    "model_name": "toy-decoder", "architectures": ["MistralForCausalLM"], "model_type": "mistral",
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "vocab_size": 1000, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "torch_dtype": "float32",
    "serving": {"max_len": 1024, "max_new_tokens": 16, "max_batch_size": 8, "search_topk": 2},
    "embedder": {k: v for k, v in TOY_ENCODER.items() if k != "limits"},
    "limits": {"corpus_embed_gap": 1e-4, "token_gap": 1e-3},
}
COMMON = {"vocab_words": 500, "word_letters": [2, 6], "zipf_s": 1.07,
          "chunks": {"full_share": 0.8, "full_words": [28, 38], "tail_words": [6, 28]},
          "chunks_per_file": 32, "poll_s": 0.02}
TOY_INGEST = dict(COMMON, driver="docstore_ingest", backlog_files=3, autocommit_ms=25,
                  warmup_files=2, settle_s=0.2, trace_s=1, sample_files=2, sample_per_file=8,
                  queries=4, k=3, question_words=[4, 8], setup_limit_s=60, drain_limit_s=15)
TOY_RAG = dict(COMMON, driver="rag_answer", corpus_chunks=64, clients=6, questions_per_client=100,
               question_words=[4, 8], request_timeout_s=60, warmup_calls=1, client_groups=1, trace_calls=2,
               trace_limit_s=60, sample_answers=50, setup_limit_s=60, drain_limit_s=15)
TOY_METRIC = '''"""Toy: the answers received in the window."""


def read(ctx):
    return float(sum(1 for a in ctx.get("answers", ())
                     if ctx["t_open"] <= a["record"]["t_recv"] <= ctx["t_close"]))
'''


def toy_tree(tmp: str) -> str:
    """The benchmark copied into `tmp` with the toy files added; returns
    the tree's root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "pathway_tpu_torch"), os.path.join(root, "pathway_tpu_torch"))
    bench = os.path.join(root, "bench_port")
    for name, body in (("toy-encoder", TOY_ENCODER), ("toy-rag", TOY_DECODER)):
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump(body, f)
    for name, body in (("toy-ingest", TOY_INGEST), ("toy-rag-closed", TOY_RAG)):
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(body, f)
    with open(os.path.join(bench, "metrics", "toy.answers_seen.py"), "w") as f:
        f.write(TOY_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] += [
        {"name": "toy-encoder", "source": "toy", "file": "bench_port/configs/toy-encoder.json",
         "reduced": [], "why": "toy"},
        {"name": "toy-rag", "source": "toy", "file": "bench_port/configs/toy-rag.json",
         "reduced": [], "why": "toy"},
    ]
    spec["workloads"] += [
        {"name": "toy-ingest", "config": "toy-encoder", "traffic": "toy-ingest", "chips": 1, "why": "toy"},
        {"name": "toy-rag", "config": "toy-rag", "traffic": "toy-rag-closed", "chips": 1, "why": "toy"},
    ]
    for m in spec["end_to_end"]:
        if m["name"] == "ingest_docs_per_s":
            m["workloads"].append("toy-ingest")
        if m["name"] in ("answers_per_s", "answer_p95_ms"):
            m["workloads"].append("toy-rag")
    for m in spec["per_layer"]:
        if m["name"].startswith("ingest."):
            m["workloads"].append("toy-ingest")
        if m["name"].startswith("rag."):
            m["workloads"].append("toy-rag")
    spec["per_layer"].append({"name": "toy.answers_seen", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "RAG serving",
                              "moves": "answers_per_s", "workloads": ["toy-rag"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=2)
    return root


def drive(root: str, workload: str, seed: int = 3, seconds: int = 2, trace: int = 0,
          control: bool = False) -> dict:
    """One run of `workload` on the CPU in the tree at `root` (imported
    from there), returning its result line."""
    import importlib
    import sys

    sys.path.insert(0, root)
    try:
        for name in [m for m in sys.modules if m == "bench_port" or m.startswith("bench_port.")]:
            del sys.modules[name]
        main = importlib.import_module("bench_port.harness.main")
        core = importlib.import_module("bench_port.harness.core")
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
        run = core.Run(time.perf_counter())
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
        return main.drive(run, args, info, "cpu", root, os.path.join(root, "bench_port"), control)
    finally:
        sys.path.remove(root)
