"""The yardstick's arithmetic against values worked by hand: FLOPs,
the flash bound, the busy union, the window's rate and tail."""

from __future__ import annotations

import math

import pytest

from bench_port.harness import costs
from bench_port.harness.stats import credited_rate, overlap, p95_ms
from bench_port.harness.trace import idle_gaps, union_us

MISTRAL = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
           "intermediate_size": 14336, "num_hidden_layers": 32, "vocab_size": 32000}


def test_encoder_flops_at_243_tokens():
    # 6 x (2 (4 * 384^2 + 2 * 384 * 1536) + 4 * 243 * 384) = 23,473,152 a token
    per_token = costs.encoder_flops_per_token(243, 384, 1536, 6)
    assert per_token == 6 * (2 * (4 * 384 * 384 + 2 * 384 * 1536) + 4 * 243 * 384) == 23_473_152
    assert costs.encoder_flops_per_doc(243, 384, 1536, 6) == pytest.approx(5.704e9, rel=1e-3)


def test_decoder_params_and_answer_flops():
    # wq, wo 4096^2 each; wk, wv 4096 x 1024; gate, up, down 4096 x 14336
    assert costs.decoder_layer_params(MISTRAL) == 218_103_808
    n, new = 2500, 32
    per_token = 2 * 218_103_808 * 32
    attn = 4 * 4096 * 32
    want = (n * per_token + attn * n * (n + 1) / 2
            + 31 * per_token + attn * sum(n + t + 1 for t in range(31))
            + 2 * 32000 * 4096 * 32)
    assert costs.decoder_answer_flops(MISTRAL, n, new) == pytest.approx(want)
    # about 14.6 GFLOP a token: 2 x 6.98e9 matmul parameters, and attention
    assert costs.decoder_answer_flops(MISTRAL, n, new) / (n + new) == pytest.approx(1.462e10, rel=0.01)


def test_flash_bound_matches_the_kernel_table():
    # PERF.md: [8, 32, 1024, 128] causal, 0.080 ms, by bytes
    t = costs.flash_least_seconds([1024] * 8, 32, 128)
    assert t == pytest.approx(4 * 8 * 32 * 1024 * 128 * 2 / 3.35e12)
    assert t * 1e3 == pytest.approx(0.0801, abs=1e-4)
    # a long prompt is bound by its causal products
    long = costs.flash_least_seconds([3000] * 32, 32, 128)
    assert long == pytest.approx(4 * 128 * 32 * 32 * 3000 * 3001 / 2 / 989e12)


def test_busy_union_and_gaps():
    busy, merged = union_us([(0, 10), (5, 12), (20, 30), (25, 26)])
    assert busy == 22 and merged == [[0, 12], [20, 30]]
    assert idle_gaps(merged, -5, 40) == [(-5, 0), (12, 20), (30, 40)]


def test_partial_credit_at_the_window_edges_sums():
    spans = [(0.0, 4.0), (2.0, 6.0), (9.0, 13.0)]
    # window [3, 10]: 1/4 + 3/4 + 1/4 over 7 s
    assert credited_rate(spans, 3.0, 10.0) == pytest.approx((0.25 + 0.75 + 0.25) / 7.0)
    # back-to-back answers of one client credit exactly the window's share
    chain = [(float(i), float(i + 1)) for i in range(20)]
    assert credited_rate(chain, 2.5, 12.5) == pytest.approx(1.0)
    assert overlap(0, 1, 2, 3) == 0.0


def chain(latencies) -> list:
    """One closed-loop client's (send, receive) spans."""
    spans, t = [], 0.0
    for x in latencies:
        spans.append((t, t + x))
        t += x
    return spans


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = [chain([1.0] * 60) for _ in range(4)]
    # two 5 s stalls hold every client's answers sent at t = 20 and 26
    stalled = [chain([1.0] * 20 + [6.0, 6.0] + [1.0] * 38) for _ in range(4)]
    flat = lambda clients: [s for c in clients for s in c]  # noqa: E731
    assert credited_rate(flat(stalled), 5.0, 35.0) < credited_rate(flat(steady), 5.0, 35.0)
    lat = lambda clients: [e - s for s, e in flat(clients) if 5.0 <= s < 35.0]  # noqa: E731
    assert p95_ms(lat(steady)) == pytest.approx(1000.0)
    assert p95_ms(lat(stalled)) > 1000.0


def test_p95_is_linear_and_a_missing_answer_is_infinite():
    assert p95_ms([0.1 * i for i in range(1, 21)]) == pytest.approx(1905.0)
    assert math.isinf(p95_ms([0.1] * 10 + [None]))
