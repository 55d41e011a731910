"""Full-text document index (reference:
python/pathway/stdlib/indexing/full_text_document_index.py)."""

from __future__ import annotations

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex


def default_full_text_document_index(
    data_column,
    data_table,
    *,
    metadata_column=None,
) -> DataIndex:
    factory = TantivyBM25Factory()
    return factory.build_index(data_column, data_table, metadata_column)
