"""Host ms a decode step: the mean length of the `decoder.decode` spans
(the host enqueueing one step's forward and pick) of the generate calls
wholly in the window."""

from bench_port.harness import spans


def read(ctx):
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    steps = [d for c in (spans.generate_calls(host, *w) if host else []) for d in c["decode"]]
    if not steps:
        return None
    return 1e3 * sum(e - s for _n, s, e, *_ in steps) / len(steps)
