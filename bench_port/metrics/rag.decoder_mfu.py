"""The decoder's useful FLOPs in the window over its seconds, as a
percent of the card's bf16 peak. Each generate call's FLOPs (every
prompt's real tokens and its new tokens, attention included:
harness/costs.py) are credited by the share of the call inside the
window."""

from bench_port.harness import costs
from bench_port.harness.stats import overlap


def read(ctx):
    cfg, new = ctx["config"], ctx["new_tokens"]
    tokens = {}
    for a in ctx["answers"]:
        if a["call"] is not None:
            tokens.setdefault(a["call"], []).append(a["prompt_tokens"])
    flops = 0.0
    for ci, call in enumerate(ctx["calls"]):
        share = overlap(call["t0"], call["t1"], ctx["t_open"], ctx["t_close"]) / (call["t1"] - call["t0"])
        if share <= 0:
            continue
        if len(tokens.get(ci, ())) != len(call["prompts"]):
            return None  # a prompt of this call was not joined to its answer
        flops += share * sum(costs.decoder_answer_flops(cfg, n, new) for n in tokens[ci])
    if flops <= 0:
        return None
    return 100.0 * flops / ctx["window_s"] / costs.BF16_FLOPS
