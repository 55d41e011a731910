"""pw.ml (reference: python/pathway/stdlib/ml/)."""

from pathway_tpu_torch.stdlib.ml import (
    classifiers,
    datasets,
    hmm,
    index,
    smart_table_ops,
    utils,
)
from pathway_tpu_torch.stdlib.ml.hmm import create_hmm_reducer
from pathway_tpu_torch.stdlib.ml.utils import classifier_accuracy

__all__ = [
    "classifiers",
    "classifier_accuracy",
    "create_hmm_reducer",
    "datasets",
    "hmm",
    "index",
    "smart_table_ops",
    "utils",
]
