"""A run that cannot measure ends in seconds, prints no result on
standard output, ends its standard error with a line of `"correct":
false`, and exits non-zero: in a checkout that holds only the benchmark,
and with the port present but no card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
LIMIT_S = 30.0


def bench_only(tmp) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "bench_port"), ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    return root


def run_cell(root: str, workload: str) -> tuple:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", workload, "--seed", str(2**31 + 7),
         "--seconds", "10", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=LIMIT_S + 30,
    )
    return proc, time.perf_counter() - t0


def assert_failed_fast(proc, took: float, reason: str) -> None:
    assert took < LIMIT_S
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    last = json.loads(proc.stderr.strip().splitlines()[-1])
    assert last["correct"] is False and reason in last["error"]


@pytest.mark.parametrize("workload", ["docstore-ingest-256", "private-rag-long"])
def test_without_the_port(tmp_path, workload):
    proc, took = run_cell(bench_only(tmp_path), workload)
    assert_failed_fast(proc, took, "the port does not import")


@pytest.mark.parametrize("workload", ["docstore-ingest-256", "private-rag-long"])
def test_without_a_card(tmp_path, workload):
    root = bench_only(tmp_path)
    os.symlink(os.path.join(REPO, "pathway_tpu_torch"), os.path.join(root, "pathway_tpu_torch"))
    proc, took = run_cell(root, workload)
    assert_failed_fast(proc, took, "CUDA card")


def test_an_unknown_cell(tmp_path):
    proc, took = run_cell(bench_only(tmp_path), "no-such-cell")
    assert_failed_fast(proc, took, "no workload named")
