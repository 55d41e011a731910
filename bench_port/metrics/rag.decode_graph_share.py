"""The share of the decode steps that replayed a captured CUDA graph:
over the generate calls wholly in the window, the `decoder.decode` spans
that hold a `decoder.graph_replay` span. None from a program that never
recorded a `decoder.graph_capture` (one that decodes without graphs)."""

from bench_port.harness import spans


def read(ctx):
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    steps = [d for c in (spans.generate_calls(host, *w) if host else []) for d in c["decode"]]
    ever = spans.host_spans(float("-inf"), w[1]) if steps else None
    if not steps or not ever or not any(r[0] == "decoder.graph_capture" for r in ever):
        return None
    return sum(1 for d in steps if spans.inside(host, "decoder.graph_replay", d)) / len(steps)
