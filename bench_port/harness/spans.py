"""The program's own spans over a traced window, for per-layer metrics.

The port records host spans in a process-wide ring (its
internals/tracing.py: the device pipeline's stages, the decoder's
prefill, decode steps, readback and first token, ingest's copies and
index writes) and query spans with their marks (internals/qtrace.py:
ingress, search_start, device_end, udf_start, udf_end, respond), both on
time.perf_counter, the clock of the benchmark's window. A metric reads
them after the run over [t_open, t_close]. A program that records none
of them (one older than the ring) gives None here, never an error, and
so does a ring that has lost part of the window.
"""

from __future__ import annotations

from bench_port.harness.stats import overlap
from bench_port.harness.trace import clip, idle_gaps, union_us


def window(ctx):
    """(t_open, t_close) on perf_counter: those the cell's context gives,
    else the traced window's edges (the `bench.window` span, laid back on
    perf_counter)."""
    if "t_open" in ctx and "t_close" in ctx:
        return ctx["t_open"], ctx["t_close"]
    trace = ctx.get("trace")
    if trace is None:
        return None
    return (trace.lo - trace.offset_us) / 1e6, (trace.hi - trace.offset_us) / 1e6


def host_spans(t0: float, t1: float):
    """[(name, start, end, rows, thread)] of the program's host-span ring
    that overlap [t0, t1]; None without a ring or with part of it lost."""
    try:
        from pathway_tpu_torch.internals import tracing

        ring = tracing.host_spans()
        if not ring.holds_since(t0):
            return None
        records = ring.spans_between(t0, t1)
    except (ImportError, AttributeError):
        return None
    return [(r[0], r[1], r[1] + r[2], r[3], r[4]) for r in records]


def query_spans(t0: float, t1: float):
    """The program's finished query spans overlapping [t0, t1] (dicts
    with "route" and "marks"); None where the program keeps none."""
    try:
        from pathway_tpu_torch.internals import qtrace

        return qtrace.tracker().finished_between(t0, t1)
    except (ImportError, AttributeError):
        return None


def seconds_in(spans, name: str, t0: float, t1: float) -> float:
    """Seconds of the spans named `name`, clipped to [t0, t1]."""
    return sum(overlap(s, e, t0, t1) for n, s, e, *_ in spans if n == name)


def inside(spans, name: str, outer) -> list:
    """The spans named `name` on `outer`'s thread that lie within it."""
    _n, a, b, _rows, thread = outer
    return [sp for sp in spans if sp[0] == name and sp[4] == thread and a <= sp[1] and sp[2] <= b]


def generate_calls(spans, t0: float, t1: float) -> list:
    """The `llm.generate` spans wholly inside [t0, t1], each as a dict of
    its own spans: "call", "first_token", "decode" (a list), "readback";
    a call without its first token or readback is left out."""
    calls = []
    for call in spans:
        if call[0] != "llm.generate" or call[1] < t0 or call[2] > t1:
            continue
        first, readback = inside(spans, "decoder.first_token", call), inside(spans, "decoder.readback", call)
        if len(first) == 1 and len(readback) == 1:
            calls.append({"call": call, "first_token": first[0], "readback": readback[0],
                          "decode": inside(spans, "decoder.decode", call)})
    return calls


def answers(ctx, route: str = "/v2/answer"):
    """(answers, host spans): the window's finished query spans on
    `route` sent inside it that passed through a batched UDF, and the
    host spans up to the last one's response; None without either."""
    w = window(ctx)
    if w is None:
        return None
    t0, t1 = w
    queries = query_spans(t0, t1)
    if queries is None:
        return None
    sent = [q for q in queries if q.get("route") == route and t0 <= q["marks"]["ingress"] <= t1
            and "udf_start" in q["marks"] and "udf_end" in q["marks"]]
    if not sent:
        return None
    host = host_spans(t0, max(q["marks"]["respond"] for q in sent))
    if host is None:
        return None
    return sent, host


def busy_merged(trace) -> list:
    """The card's busy intervals in the traced window, merged (profiler us)."""
    return union_us(clip([(s, t) for s, t, _ in trace.kernels], trace.lo, trace.hi))[1]


def idle_us(merged: list, a: float, b: float) -> float:
    """Microseconds of [a, b] not covered by the merged busy intervals."""
    return sum(e - s for s, e in idle_gaps(merged, a, b))
