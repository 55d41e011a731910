"""Host ms in the index's writes (the program's `index.write` spans:
slot assignment, the slot copy and the enqueued write of a dispatched
slab) per 1,000 chunks indexed, over the traced window."""

from bench_port.harness import spans


def read(ctx):
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    if not host or not ctx.get("docs"):
        return None
    ms = spans.seconds_in(host, "index.write", *w) * 1e3
    if ms <= 0:
        return None
    return ms / (ctx["docs"] / 1000.0)
