"""The share of the encoder's slab tokens that were padding in the
window: the DevicePipeline's real and slab token counters, differenced
over the window."""


def read(ctx):
    slab = ctx["after"]["slab_tokens"] - ctx["before"]["slab_tokens"]
    if slab <= 0:
        return None
    return 1.0 - (ctx["after"]["real_tokens"] - ctx["before"]["real_tokens"]) / slab
