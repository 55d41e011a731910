"""flash_fwd's share of its roofline in the traced window: the least
time of the prefill flash calls of the generate calls that lie wholly
in the window (one call a layer, [B, q heads, L, head dim] causal,
harness/costs.py's bound) over the device time of the flash kernels
that ran inside those calls, from the profiler."""

from bench_port.harness import costs


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    calls = [(i, c) for i, c in enumerate(ctx["calls"])
             if c["t0"] >= ctx["t_open"] and c["t1"] <= ctx["t_close"]]
    tokens = {}
    for a in ctx["answers"]:
        if a["call"] is not None:
            tokens.setdefault(a["call"], []).append(a["prompt_tokens"])
    cfg = ctx["config"]
    heads, hd = cfg["num_attention_heads"], cfg["hidden_size"] // cfg["num_attention_heads"]
    least, flash_calls = 0.0, []
    for i, call in calls:
        rows = tokens.get(i, [])
        if len(rows) != len(call["prompts"]):
            return None  # a prompt of this call was not joined to its answer
        if max(rows) > costs.FLASH_GATE:
            least += cfg["num_hidden_layers"] * costs.flash_least_seconds(rows, heads, hd)
            flash_calls.append((call["t0"], call["t1"]))
    device = trace.kernel_seconds("flash_fwd", flash_calls)
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
