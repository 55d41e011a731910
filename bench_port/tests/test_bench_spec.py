"""BENCHMARK.json against the rules its consumers hold it to: names and
units of the allowed characters, the keys each entry may have, every
metric's `moves` reported in the same cells, and every file it names
present under the benchmark's own directory."""

from __future__ import annotations

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
          "experts_per_tok", "num_experts_per_tok")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert 1 <= len(spec["command"]) <= 32 and all(one_line(w) for w in spec["command"])
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in spec["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"]), word


def test_names_units_and_entry_keys(spec):
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTHS)
                       for k in c["reduced"]), c["reduced"]
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert os.path.exists(os.path.join(REPO, c["file"]))
        names.add(("config", c["name"]))
    assert len(names) == len(spec["configs"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        cells.add(w["name"])
    assert len(cells) == len(spec["workloads"])
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(cells)
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in spec["workloads"]}
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_every_metric_moves_an_end_to_end_metric_of_its_cells(spec):
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in spec["workloads"]]))
           for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for w in spec["workloads"]:
        reported = {k for k, cells in e2e.items() if w["name"] in cells}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])


def test_rooflines_and_mfu_are_percent(spec):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files_keep_their_published_widths(spec):
    widths = {
        "minilm-l6-docstore": {"hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
                               "intermediate_size": 1536, "vocab_size": 30522,
                               "max_position_embeddings": 512, "max_seq_length": 256},
        "mistral-7b-private-rag": {"hidden_size": 4096, "num_hidden_layers": 32,
                                   "num_attention_heads": 32, "num_key_value_heads": 8,
                                   "intermediate_size": 14336, "vocab_size": 32000,
                                   "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                                   "sliding_window": 4096},
    }
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            body = json.load(f)
        for k, v in widths[c["name"]].items():
            assert body[k] == v, (c["name"], k)
