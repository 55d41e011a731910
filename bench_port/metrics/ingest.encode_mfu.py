"""The encoder's useful FLOPs over the traced window's seconds, as a
percent of the card's bf16 peak: the chunks the index took in the
window, each at its real token count (the generator's words, plus
[CLS] and [SEP], cut at max_seq_length: the tokenizer's rule), by
costmodel's encoder formula (harness/costs.py)."""

from bench_port.harness import costs


def read(ctx):
    if not ctx.get("docs"):
        return None
    flops = costs.encoder_flops(ctx["config"], ctx["token_counts"])
    return 100.0 * flops / ctx["window_s"] / costs.BF16_FLOPS
