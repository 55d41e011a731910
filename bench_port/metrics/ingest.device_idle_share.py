"""The card's idle share over the traced ingest window: 1 - the union
of kernel intervals over the window (trace_port.py's busy union)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.kernels:
        return None
    return 1.0 - trace.busy_s / trace.window_s
