"""Plain Mistral-7B: the logits of a full forward pass, no cache.

Follows the published architecture (arXiv:2310.06825; the model's
config.json): token embedding; per layer RMSNorm, q / k / v projections
with rotary embeddings (theta 10,000, the two-halves rotation), causal
grouped-query attention (8 kv heads shared by 32 q heads), the output
projection and a residual, then RMSNorm, the SwiGLU MLP and a residual;
a final RMSNorm and the untied output head. The sliding window (4,096)
is no shorter than any sequence here, so attention is full. Departures:
the weights come in the port's key names ([in, out] dense weights), and
layer i's weights come from `layer(i)`, so only one layer is held in f32
at a time. Imports torch only.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.numerics import full_f32, matmul


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None].float() * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, mode, head_block: int = 8):
    """Causal attention of one sequence: q [H, n, d], k / v [KVH, n, d]."""
    qh, n, d = q.shape
    rep = qh // k.shape[0]
    out = torch.empty_like(q)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
    for h0 in range(0, qh, head_block):
        hs = slice(h0, h0 + head_block)
        kv = torch.arange(h0, min(h0 + head_block, qh), device=q.device) // rep
        s = matmul(q[hs], k[kv].transpose(1, 2), mode) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
        out[hs] = matmul(p, v[kv], mode)
    return out


def logits_at(head: dict, layer, cfg: dict, seqs, last: int, mode: str = "f32"):
    """For each token sequence in `seqs` (lists of ids), the logits [last,
    V] f32 of its final `last` positions. head: embed, lm_head, ln_f;
    layer(i): layer i's weights (any dtype)."""
    h, qh, kvh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = h // qh, cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = head["embed"].device
    with torch.no_grad(), full_f32():
        ids = [torch.tensor(s, dtype=torch.int64, device=dev) for s in seqs]
        xs = [head["embed"][t].float() for t in ids]
        for i in range(cfg["num_hidden_layers"]):
            w = {k: (v.float() if torch.is_tensor(v) else v) for k, v in layer(i).items()}
            for j, x in enumerate(xs):
                n = x.shape[0]
                pos = torch.arange(n, device=dev)
                y = _rms(x, w["ln1"], eps)
                q = _rope(matmul(y, w["wq"], mode).reshape(n, qh, hd).transpose(0, 1), pos, theta)
                k = _rope(matmul(y, w["wk"], mode).reshape(n, kvh, hd).transpose(0, 1), pos, theta)
                v = matmul(y, w["wv"], mode).reshape(n, kvh, hd).transpose(0, 1)
                ctx = _attention(q, k, v, mode).transpose(0, 1).reshape(n, h)
                x = x + matmul(ctx, w["wo"], mode)
                y = _rms(x, w["ln2"], eps)
                g = matmul(y, w["gate"], mode)
                x = x + matmul(torch.nn.functional.silu(g) * matmul(y, w["up"], mode), w["down"], mode)
                xs[j] = x
            del w
        lm_head = head["lm_head"].float().t()
        return [matmul(_rms(x[-last:], head["ln_f"], eps), lm_head, mode) for x in xs]
