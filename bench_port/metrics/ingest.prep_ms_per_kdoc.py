"""Host ms in the DevicePipeline's prepare stage (tokenize and pack) per
1,000 chunks indexed, over the traced window: the utilization window's
prep span sum, reset at the window's start (as chip_smoke's 9a reads
it)."""


def read(ctx):
    util = ctx.get("util")
    if not util or not ctx.get("docs"):
        return None
    return util["span_seconds"]["prep"] * 1000.0 / (ctx["docs"] / 1000.0)
