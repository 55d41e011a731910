"""The card's idle share over the decode of the generate calls wholly in
the window: from each call's `decoder.first_token` end (the card done
with the prefill) to its `decoder.readback` end (the tokens on the
host), the seconds no kernel ran over the seconds of those intervals."""

from bench_port.harness import spans


def read(ctx):
    trace = ctx.get("trace")
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    if trace is None or not trace.kernels or not host:
        return None
    merged = spans.busy_merged(trace)
    idle = total = 0.0
    for c in spans.generate_calls(host, *w):
        a, b = trace.to_us(c["first_token"][2]), trace.to_us(c["readback"][2])
        if b > a:
            idle += spans.idle_us(merged, a, b)
            total += b - a
    return idle / total if total > 0 else None
