"""pw.utils (reference: python/pathway/stdlib/utils/)."""

from pathway_tpu_torch.stdlib.utils import bucketing, col, filtering
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows, argmin_rows
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = [
    "argmax_rows",
    "argmin_rows",
    "bucketing",
    "col",
    "filtering",
    "pandas_transformer",
]
