"""ML classifiers (reference: python/pathway/stdlib/ml/classifiers/
_knn_lsh.py — LSH-based KNN classifier; backed here by KNNIndex, the
brute-force device index on the CUDA card). `device=` in kwargs places
the index (None: the card)."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.ml.index import KNNIndex


def knn_lsh_classifier_train(
    data: Table,
    L: int = 20,
    type: str = "euclidean",
    **kwargs,
):
    """Train: build the index over (data, label) rows; returns a classify
    function (reference: _knn_lsh.py knn_lsh_classifier_train)."""
    d = kwargs.get("d")
    if d is None:
        raise ValueError("provide d= (embedding dimensionality)")
    index = KNNIndex(
        data.data, data, n_dimensions=d, distance_type=type, device=kwargs.get("device")
    )

    def classify(queries: Table, k: int = 3) -> Table:
        matches = index.get_nearest_items(queries.data, k=k)
        # majority vote over neighbor labels
        def majority(labels):
            from collections import Counter

            votes = Counter(l for l in (labels or ()) if l is not None)
            if not votes:
                return None
            return votes.most_common(1)[0][0]

        return matches.select(
            predicted_label=pw_api.apply_with_type(
                majority, Any, matches.label
            )
        )

    return classify


knn_classifier_train = knn_lsh_classifier_train
