"""Time to first token: over the /v2/answer requests sent in the window,
the mean of ingress (the request's arrival, its query span's first
mark) to the end of `decoder.first_token` (the card done with the
prefill and the first pick) of the `llm.generate` call inside the
request's batched-UDF marks [udf_start, udf_end]; the first such call
where a batch held two. Only first tokens before the window's close
count: the close (a synchronize and the profiler's stop, which holds
the process for seconds) would stretch a span that runs across it."""

from bench_port.harness import spans


def read(ctx):
    got = spans.answers(ctx)
    if got is None:
        return None
    sent, host = got
    t_close = spans.window(ctx)[1]
    ttft = []
    for q in sent:
        m = q["marks"]
        calls = sorted(c for c in host if c[0] == "llm.generate"
                       and m["udf_start"] <= c[1] and c[2] <= m["udf_end"])
        first = spans.inside(host, "decoder.first_token", calls[0]) if calls else []
        if len(first) == 1 and first[0][2] <= t_close:
            ttft.append(first[0][2] - m["ingress"])
    return 1e3 * sum(ttft) / len(ttft) if ttft else None
