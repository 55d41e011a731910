"""The card's idle share over the traced RAG window (two or more whole
generate calls): 1 - the union of kernel intervals over the window."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.kernels:
        return None
    return 1.0 - trace.busy_s / trace.window_s
