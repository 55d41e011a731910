"""pw.indexing — KNN / BM25 / hybrid retrieval (reference:
python/pathway/stdlib/indexing/). BruteForceKnn runs on the port's device
index (pathway_tpu_torch/ops/knn.py); BM25, LSH and IVF run on the host.
"""

from pathway_tpu_torch.stdlib.indexing.data_index import (
    DataIndex,
    InnerIndex,
    IdScoreSchema,
)
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    AbstractRetrieverFactory,
    BruteForceKnn,
    DefaultKnnFactory,
    LshKnnFactory,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    LshKnn,
    USearchKnn,
    UsearchKnnFactory,
    USearchMetricKind,
)
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex, HybridIndexFactory
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)

__all__ = [
    "AbstractRetrieverFactory",
    "DefaultKnnFactory",
    "LshKnnFactory",
    "DataIndex",
    "InnerIndex",
    "IdScoreSchema",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "USearchKnn",
    "UsearchKnnFactory",
    "USearchMetricKind",
    "LshKnn",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "default_full_text_document_index",
]
