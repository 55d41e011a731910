"""The prefill as the card gives it: the mean length of
`decoder.first_token` (the generate call's start to the card done with
the prefill and the first pick) of the generate calls wholly in the
window."""

from bench_port.harness import spans


def read(ctx):
    w = spans.window(ctx)
    host = spans.host_spans(*w) if w else None
    calls = spans.generate_calls(host, *w) if host else []
    if not calls:
        return None
    return 1e3 * sum(c["first_token"][2] - c["first_token"][1] for c in calls) / len(calls)
