"""The window arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def credited_rate(spans, t_open: float, t_close: float) -> float:
    """Completions per second over [t_open, t_close]: each (start, end)
    span is credited with the share of its own length that lies inside
    the window, so a completion is never counted whole at the edge."""
    credit = 0.0
    for s, e in spans:
        if e > s:
            credit += overlap(s, e, t_open, t_close) / (e - s)
    return credit / (t_close - t_open)


def p95_ms(latencies_s) -> float:
    """The 95th percentile (linear) in ms; a failed request is an
    infinite latency, since it misses any limit."""
    lat = sorted(math.inf if x is None else float(x) for x in latencies_s)
    if not lat:
        return math.inf
    at = 0.95 * (len(lat) - 1)
    lo, hi = lat[math.floor(at)], lat[math.ceil(at)]
    if math.isinf(hi):
        return math.inf
    return (lo + (hi - lo) * (at - math.floor(at))) * 1000.0
