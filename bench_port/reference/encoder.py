"""Plain all-MiniLM-L6-v2: BERT encoder, mean pooling, L2 normalisation.

Follows the published BERT layout (arXiv:1810.04805; the
sentence-transformers model card): word + position + token-type
embeddings, LayerNorm; per layer softmax(q k^T / sqrt(d)) v over the
unpadded keys, a residual and LayerNorm, then erf GELU in the MLP, a
residual and LayerNorm (eps 1e-12); the mean of the last hidden states
over the real tokens, divided by its L2 norm. Departures: the weights
come in the port's key names ([in, out] dense weights, q, k and v in one
[h, 3h] matrix), and token type 0 is every token's, as a single sentence
has it. Runs in blocks of rows; imports torch and numpy only.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference import tokenizer
from bench_port.reference.numerics import full_f32, matmul

EPS = 1e-12


def _ln(x, p):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * p["scale"].float() + p["bias"].float()


def _dense(x, w, b, mode):
    return matmul(x, w, mode) + b.float()


def encode_ids(tree: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, mode: str = "f32"):
    """Pooled unit rows [B, h] of ids / mask [B, L] (mask 1 on real tokens)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = h // heads
    b, l = ids.shape
    with torch.no_grad(), full_f32():
        x = (tree["embed"][ids].float() + tree["pos_embed"][:l].float()[None]
             + tree["type_embed"][0].float()[None, None])
        x = _ln(x, tree["embed_ln"])
        dead = (mask == 0)[:, None, None, :]
        for layer in tree["layers"]:
            qkv = _dense(x, layer["qkv"], layer["qkv_b"], mode)
            q, k, v = (t.reshape(b, l, heads, hd).transpose(1, 2) for t in qkv.split(h, dim=-1))
            s = matmul(q, k.transpose(2, 3), mode) / math.sqrt(hd)
            p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
            ctx = matmul(p, v, mode).transpose(1, 2).reshape(b, l, h)
            x = _ln(x + _dense(ctx, layer["out"], layer["out_b"], mode), layer["ln1"])
            y = _dense(x, layer["up"], layer["up_b"], mode)
            y = 0.5 * y * (1.0 + torch.erf(y / math.sqrt(2.0)))
            x = _ln(x + _dense(y, layer["down"], layer["down_b"], mode), layer["ln2"])
        m = mask[:, :, None].float()
        pooled = (x * m).sum(1) / m.sum(1)
        return pooled / pooled.norm(dim=-1, keepdim=True)


def encode_texts(tree: dict, cfg: dict, texts, device, mode: str = "f32", block: int = 128):
    """Unit embeddings [len(texts), h] f32 of texts, cut to max_seq_length."""
    max_len = cfg["max_seq_length"]
    out = []
    for s in range(0, len(texts), block):
        enc = [tokenizer.encode(t, cfg["vocab_size"], max_len) for t in texts[s : s + block]]
        width = max(len(e) for e in enc)
        ids = torch.zeros((len(enc), width), dtype=torch.int64)
        mask = torch.zeros((len(enc), width), dtype=torch.int64)
        for i, e in enumerate(enc):
            ids[i, : len(e)] = torch.tensor(e)
            mask[i, : len(e)] = 1
        out.append(encode_ids(tree, cfg, ids.to(device), mask.to(device), mode))
    return torch.cat(out) if out else torch.zeros((0, cfg["hidden_size"]), device=device)
