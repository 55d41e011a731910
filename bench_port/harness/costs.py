"""The yardstick's arithmetic: the card's published peaks, the models'
useful FLOPs and the flash kernel's least time.

Frozen copies, each from its source:
- the encoder's FLOPs a token, from pathway_tpu_torch/internals/costmodel.py
  (`encoder_flops_per_token`): per layer 2 (4 h^2 + 2 h ffn) for the
  projections and the MLP, and 2 * 2 * seq * h for attention's scores and
  mix, a doc's real tokens attending within the doc;
- the decoder's 2 x params a token, from the same file
  (`decoder_flops_per_token`), with causal attention added: 4 * (q heads
  x head dim) FLOPs a key a layer, each token attending to itself and
  every token before it;
- flash's bound, from PERF.md's kernel table: bytes of q, k, v and o read
  or written once at 3.35 TB/s, or the products of the live causal pairs
  (4 D FLOPs a pair a head) at 989 TFLOP/s, whichever is larger.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the port's flash gate (models/transformer.py FLASH_MIN_LEN): attention
# over more keys than this takes the flash kernel on the card
FLASH_GATE = 256


def encoder_flops_per_token(seq: float, hidden: int, mlp_dim: int, layers: int) -> float:
    h = hidden
    return layers * (2 * (4 * h * h + 2 * h * mlp_dim) + 2 * 2 * seq * h)


def encoder_flops_per_doc(tokens: int, hidden: int, mlp_dim: int, layers: int) -> float:
    """Useful FLOPs of one doc of `tokens` real tokens."""
    return encoder_flops_per_token(tokens, hidden, mlp_dim, layers) * tokens


def encoder_flops(cfg: dict, token_counts) -> float:
    return sum(encoder_flops_per_doc(n, cfg["hidden_size"], cfg["intermediate_size"],
                                     cfg["num_hidden_layers"]) for n in token_counts)


def decoder_layer_params(cfg: dict) -> int:
    """Matmul parameters of one decoder layer: wq, wk, wv, wo, gate, up, down."""
    h = cfg["hidden_size"]
    kv = cfg["num_key_value_heads"] * (h // cfg["num_attention_heads"])
    return 2 * h * h + 2 * h * kv + 3 * h * cfg["intermediate_size"]


def decoder_answer_flops(cfg: dict, prompt_tokens: int, new_tokens: int) -> float:
    """Useful FLOPs of one answer: the prefill of its real prompt tokens
    (the output head only where a token is chosen), then new_tokens - 1
    cached decode steps, each new token's head."""
    h, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    per_token = 2.0 * decoder_layer_params(cfg) * layers
    attn_per_key = 4.0 * h * layers  # q heads x head dim = hidden
    n = prompt_tokens
    prefill = n * per_token + attn_per_key * n * (n + 1) / 2
    steps = max(new_tokens - 1, 0)
    decode = steps * per_token + attn_per_key * sum(n + t + 1 for t in range(steps))
    head = 2.0 * cfg["vocab_size"] * h * new_tokens
    return prefill + decode + head


def flash_least_seconds(rows: list, heads: int, head_dim: int, elem_bytes: int = 2) -> float:
    """The least time of one causal flash call over a batch of rows of
    `rows` real tokens each, padded to the longest: max(bytes / HBM, ops /
    peak). q, k, v and o are [B, heads, L, D] as the call is given them."""
    b, l = len(rows), max(rows)
    bytes_moved = 4 * b * heads * l * head_dim * elem_bytes
    pairs = sum(n * (n + 1) // 2 for n in rows)
    ops = 4 * head_dim * pairs * heads
    return max(bytes_moved / HBM_BYTES_PER_S, ops / BF16_FLOPS)
