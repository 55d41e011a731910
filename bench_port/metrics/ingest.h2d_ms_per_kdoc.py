"""Host ms in the slabs' host-to-card copies (the program's `encode.h2d`
spans: ids, segment ids and gather slots) per 1,000 chunks indexed, over
the traced window."""

from bench_port.harness import spans


def read(ctx):
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    if not host or not ctx.get("docs"):
        return None
    ms = spans.seconds_in(host, "encode.h2d", *w) * 1e3
    if ms <= 0:
        return None
    return ms / (ctx["docs"] / 1000.0)
