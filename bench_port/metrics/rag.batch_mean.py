"""Prompts per generate call, mean over the calls that ran wholly in the
window, from the benchmark's recorder around the chat model it hands to
HFPipelineChat."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c["t0"] >= ctx["t_open"] and c["t1"] <= ctx["t_close"]]
    if not calls:
        return None
    return sum(len(c["prompts"]) for c in calls) / len(calls)
