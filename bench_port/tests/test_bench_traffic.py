"""The traffic generator: the same seed gives the same texts, seeds
change the words and the order but never the amount of work, and the
length mix stays in its ranges."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from bench_port.harness.textgen import TextGen, chunk_id, json_line, length_multiset
from bench_port.reference import tokenizer

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic")) if f.endswith(".json"))
BIG_SEED = 2**31 + 12345


def mix(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=MIXES)
def traffic(request):
    return mix(request.param)


def test_same_seed_same_texts(traffic):
    a, b = TextGen(BIG_SEED, traffic), TextGen(BIG_SEED, traffic)
    assert a.file_chunks(3) == b.file_chunks(3)
    assert a.questions(5, 8, 8, 24) == b.questions(5, 8, 8, 24)


def test_seeds_change_words_and_order_not_the_work(traffic):
    a, b = TextGen(BIG_SEED, traffic), TextGen(7, traffic)
    fa, fb = a.file_chunks(0), b.file_chunks(0)
    assert fa != fb
    assert sorted(map(tokenizer.count, fa)) == sorted(map(tokenizer.count, fb))
    assert not np.array_equal(a.file_lengths(0), b.file_lengths(0))


def test_length_mix_in_range(traffic):
    gen = TextGen(BIG_SEED, traffic)
    chunks = gen.file_chunks(1)
    assert len(chunks) == traffic["chunks_per_file"]
    tokens = np.array([tokenizer.count(c) for c in chunks])
    lo, hi = traffic["chunks"]["tail_words"][0] + 2, traffic["chunks"]["full_words"][1] + 2
    assert tokens.min() >= lo and tokens.max() <= hi
    full = (tokens >= traffic["chunks"]["full_words"][0] + 2).mean()
    assert abs(full - traffic["chunks"]["full_share"]) < 0.01
    assert [chunk_id(c) for c in chunks] == list(range(traffic["chunks_per_file"],
                                                        2 * traffic["chunks_per_file"]))


def test_the_cells_mix_fills_l_256_as_stated():
    traffic = mix("ingest-backlog-256")
    tokens = np.array([min(n + 2, 256) for n in length_multiset(traffic["chunks"], 1024)])
    assert 0.85 <= (tokens == 256).mean() <= 0.90  # "about 88 % of chunks fill L = 256"


def test_questions_and_json_lines(traffic):
    gen = TextGen(BIG_SEED, traffic)
    qs = gen.questions(0, 40, 8, 24)
    words = sorted(len(q.split()) - 1 for q in qs)
    assert words[0] == 8 and words[-1] == 24
    assert json.loads(json_line(gen.file_chunks(0)[0]))["data"].startswith("c0 ")
