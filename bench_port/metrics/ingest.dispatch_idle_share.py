"""The card's idle seconds that lie under the device pipeline's dispatch
stage (the program's `pipeline:dispatch` spans: the host enqueueing a
slab's copies, encode and index write), over the traced window's
seconds."""

from bench_port.harness import spans
from bench_port.harness.trace import clip, idle_gaps, union_us


def read(ctx):
    trace = ctx.get("trace")
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    if trace is None or not trace.kernels or not host:
        return None
    dispatch = [(trace.to_us(s), trace.to_us(e)) for n, s, e, *_ in host if n == "pipeline:dispatch"]
    if not dispatch:
        return None
    _, under = union_us(clip(dispatch, trace.lo, trace.hi))
    gaps = idle_gaps(spans.busy_merged(trace), trace.lo, trace.hi)
    idle, i = 0.0, 0
    for s, e in gaps:  # both lists sorted and disjoint within themselves
        while i < len(under) and under[i][1] <= s:
            i += 1
        j = i
        while j < len(under) and under[j][0] < e:
            idle += min(e, under[j][1]) - max(s, under[j][0])
            j += 1
    return idle / (trace.hi - trace.lo)
