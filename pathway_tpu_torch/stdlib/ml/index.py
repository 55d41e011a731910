"""Legacy KNNIndex API (reference: python/pathway/stdlib/ml/index.py:9 —
LSH-based; here backed by the brute-force device index, whose search is
the knn_topk kernel on the CUDA card). `device` places the index (None:
the card; "cpu" runs the kernel's plain version).

>>> import numpy as np
>>> import pathway_tpu_torch as pw
>>> from pathway_tpu_torch.stdlib.ml.index import KNNIndex
>>> data = pw.debug.table_from_rows(
...     pw.schema_from_types(doc=str, emb=np.ndarray),
...     [("apple", np.array([1.0, 0.0])), ("pear", np.array([0.9, 0.1]))],
... )
>>> index = KNNIndex(data.emb, data, n_dimensions=2, device="cpu")
>>> qs = pw.debug.table_from_rows(
...     pw.schema_from_types(qemb=np.ndarray), [(np.array([1.0, 0.05]),)]
... )
>>> r = index.get_nearest_items(qs.qemb, k=1).select(pw.this.doc)
>>> pw.debug.compute_and_print(r, include_id=False)
doc
('apple',)
"""

from __future__ import annotations

from typing import Any, Optional

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnMetricKind,
)


class KNNIndex:
    """reference: ml/index.py KNNIndex — thin wrapper over DataIndex."""

    def __init__(
        self,
        data_embedding,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata=None,
        device=None,
    ):
        metric = (
            BruteForceKnnMetricKind.COS
            if distance_type == "cosine"
            else BruteForceKnnMetricKind.L2SQ
        )
        inner = BruteForceKnn(
            data_embedding,
            metadata,
            dimensions=n_dimensions,
            metric=metric,
            device=device,
        )
        self._index = DataIndex(data, inner)
        self._data = data

    def get_nearest_items(
        self,
        query_embedding,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter=None,
    ) -> Table:
        return self._index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter=None,
    ) -> Table:
        return self._index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
