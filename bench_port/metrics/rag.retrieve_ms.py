"""Retrieval inside /v2/answer: over the requests sent in the window
whose search ended before its close (rag.ttft_ms says why), the mean of
their query spans' search_start to device_end (the index's search of the
question, its embedding included)."""

from bench_port.harness import spans


def read(ctx):
    got = spans.answers(ctx)
    if got is None:
        return None
    t_close = spans.window(ctx)[1]
    marks = [q["marks"] for q in got[0] if "search_start" in q["marks"]
             and q["marks"].get("device_end", t_close + 1.0) <= t_close]
    if not marks:
        return None
    return 1e3 * sum(m["device_end"] - m["search_start"] for m in marks) / len(marks)
