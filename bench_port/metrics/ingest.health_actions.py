"""Actions of the health controller (throttle, relax, ...) in the
window: pathway_health_actions_total, differenced."""


def read(ctx):
    before, after = ctx["before"]["health_actions"], ctx["after"]["health_actions"]
    return float(sum(after[k] - before.get(k, 0) for k in after))
