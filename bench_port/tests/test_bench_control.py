"""The control: the reference in fp8 in the program's place reads above
each limit that it must fail, where the program reads below it. At a toy
size on the CPU (float32 configurations, so the limits are the toy's
own); the cells' own readings, on the card, are in PERF.md."""

from __future__ import annotations

import pytest

from bench_port.tests import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_tree(str(tmp_path_factory.mktemp("toy")))


@pytest.mark.parametrize("workload,number", [("toy-ingest", "embed_gap"), ("toy-rag", "token_gap"),
                                            ("toy-rag", "corpus_embed_gap")])
def test_the_control_fails_where_the_program_passes(root, workload, number):
    result = toy.drive(root, workload, seed=99, seconds=3, control=True)
    assert result["correct"] is True, result["checks"]
    limit = result["checks"][number]["limit"]
    assert result["checks"][number]["value"] <= limit
    assert result["control"][number] > limit
