"""Hybrid retrieval via reciprocal rank fusion (reference:
python/pathway/stdlib/indexing/hybrid_index.py HybridIndex:14, RRF :35-120)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from pathway_tpu_torch.engine.index_node import IndexImpl
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    AbstractRetrieverFactory,
)
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex


class _HybridImpl(IndexImpl):
    def __init__(self, impls: List[IndexImpl], k_const: float):
        self.impls = impls
        self.k_const = k_const

    def add(self, key, value, metadata) -> None:
        # value is a tuple: one entry per inner index
        for impl, v in zip(self.impls, value):
            impl.add(key, v, metadata)

    def remove(self, key) -> None:
        for impl in self.impls:
            impl.remove(key)

    def search(self, value, k, metadata_filter):
        fused: Dict[Any, float] = {}
        for impl, v in zip(self.impls, value):
            results = impl.search(v, k, metadata_filter)
            for rank, (key, _score) in enumerate(results):
                fused[key] = fused.get(key, 0.0) + 1.0 / (
                    self.k_const + rank + 1
                )
        ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:k]


class HybridIndex(InnerIndex):
    """Fuses rankings of several inner indexes over the same data table."""

    def __init__(self, inner_indexes: List[InnerIndex], *, k: float = 60.0):
        self.inner_indexes = inner_indexes
        self.k_const = k
        first = inner_indexes[0]
        from pathway_tpu_torch.internals.api import make_tuple

        data_cols = [
            idx._data_preprocess(idx.data_column) for idx in inner_indexes
        ]
        self.data_column = make_tuple(*data_cols)
        self.metadata_column = first.metadata_column
        self.data_table = first.data_table

    def _make_impl(self) -> IndexImpl:
        return _HybridImpl(
            [idx._make_impl() for idx in self.inner_indexes], self.k_const
        )

    def _query_preprocess(self, query_column):
        from pathway_tpu_torch.internals.api import make_tuple

        return make_tuple(
            *(idx._query_preprocess(query_column) for idx in self.inner_indexes)
        )

    def _data_preprocess(self, data_column):
        return self.data_column


@dataclass
class HybridIndexFactory(AbstractRetrieverFactory):
    retriever_factories: List[Any]
    k: float = 60.0

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        inner = [
            f.build_inner_index(data_column, metadata_column)
            for f in self.retriever_factories
        ]
        return HybridIndex(inner, k=self.k)

