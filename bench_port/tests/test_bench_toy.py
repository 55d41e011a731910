"""A new cell from files alone: the harness finds a toy
configuration, traffic mix, cell and per-layer metric that were only
added, and runs both drivers end to end on the CPU."""

from __future__ import annotations

import pytest

from bench_port.tests import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_tree(str(tmp_path_factory.mktemp("toy")))


@pytest.mark.parametrize("workload,rate", [("toy-ingest", "ingest_docs_per_s"), ("toy-rag", "answers_per_s")])
def test_toy_cell_runs_and_is_correct(root, workload, rate):
    result = toy.drive(root, workload, seed=2**31 + 5)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {rate, "setup_s"} | ({"answer_p95_ms"} if workload == "toy-rag" else set())
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def test_toy_metric_is_read_from_its_own_file(root):
    result = toy.drive(root, "toy-rag", seed=11, trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["toy.answers_seen"]["value"] >= 1
    assert {"rag.batch_mean", "rag.generate_share", "rag.decoder_mfu"} <= set(result["metrics"])
    assert "breakdown" in result and result["device"]["window_s"] > 0
