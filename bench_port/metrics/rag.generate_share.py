"""Per answer received in the window, the share of its latency (the
client's own timing) that the generate call serving it took; the mean
over those answers."""

from bench_port.harness.stats import overlap


def read(ctx):
    shares = []
    for a in ctx["answers"]:
        r = a["record"]
        if a["call"] is None or not ctx["t_open"] <= r["t_recv"] <= ctx["t_close"]:
            continue
        call = ctx["calls"][a["call"]]
        shares.append(overlap(call["t0"], call["t1"], r["t_send"], r["t_recv"])
                      / (r["t_recv"] - r["t_send"]))
    return sum(shares) / len(shares) if shares else None
