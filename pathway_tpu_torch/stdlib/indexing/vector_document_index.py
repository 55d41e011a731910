"""Prebuilt document indexes (reference:
python/pathway/stdlib/indexing/vector_document_index.py:12-196)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    LshKnnFactory,
    UsearchKnnFactory,
)


def default_vector_document_index(
    data_column,
    data_table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column=None,
) -> DataIndex:
    return default_brute_force_knn_document_index(
        data_column,
        data_table,
        embedder=embedder,
        dimensions=dimensions,
        metadata_column=metadata_column,
    )


def default_brute_force_knn_document_index(
    data_column,
    data_table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column=None,
) -> DataIndex:
    factory = BruteForceKnnFactory(
        dimensions=dimensions,
        metric=BruteForceKnnMetricKind.COS,
        embedder=embedder,
    )
    return factory.build_index(data_column, data_table, metadata_column)


def default_usearch_knn_document_index(
    data_column,
    data_table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column=None,
) -> DataIndex:
    factory = UsearchKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_lsh_knn_document_index(
    data_column,
    data_table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column=None,
) -> DataIndex:
    factory = LshKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)
