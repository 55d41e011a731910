"""Plain cosine top-k, and the judgement of served answers against it.

The reference's scores of the served docs are compared with its own
k-th best: a served doc that lies below the k-th best by more than
rounding is a wrong answer, whatever its rank. Imports torch only.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.numerics import full_f32


def judge(rows: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, served: list,
          slot_of_text: dict, k: int) -> dict:
    """rows [N, d] unit vectors (valid [N] bool), queries [Q, d] unit
    vectors; served[i]: query i's answer as (text, score) pairs, and
    slot_of_text the row of each text. Over the served docs: the gap by
    which each one's reference score lies below the reference's k-th
    best (none above it), and |served score - reference score|, each as
    its mean and its largest; and the answers that were short or named
    an unknown text."""
    with torch.no_grad(), full_f32():
        scores = queries.float() @ rows.float().T
        scores = scores.masked_fill(~valid.bool()[None, :], -math.inf)
        kth = torch.topk(scores, k, dim=1).values[:, -1]
    gaps, errs, short, unknown = [], [], 0, 0
    for i, answer in enumerate(served):
        if len(answer) < k:
            short += 1
        for text, score in answer:
            slot = slot_of_text.get(text)
            if slot is None:
                unknown += 1
                continue
            ref = float(scores[i, slot])
            gaps.append(max(0.0, float(kth[i]) - ref))
            errs.append(abs(score - ref))
    short += max(0, queries.shape[0] - len(served))
    mean = lambda xs: sum(xs) / len(xs) if xs else math.inf  # noqa: E731
    return {"gap": mean(gaps), "gap_max": max(gaps, default=math.inf), "score_err": mean(errs),
            "score_err_max": max(errs, default=math.inf), "short": short, "unknown": unknown}


def ranked(rows: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int,
           slot_of_text: dict) -> list:
    """Each query's top k over `rows` as (text, score) pairs."""
    text_of = {slot: text for text, slot in slot_of_text.items()}
    with torch.no_grad(), full_f32():
        scores = (queries.float() @ rows.float().T).masked_fill(~valid.bool()[None, :], -math.inf)
        top = torch.topk(scores, k, dim=1)
    return [[(text_of.get(int(j), ""), float(v)) for v, j in zip(vs, js)]
            for vs, js in zip(top.values.tolist(), top.indices.tolist())]
