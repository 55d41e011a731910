"""Standard library (reference: python/pathway/stdlib)."""

from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
)

__all__ = [
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "stateful",
    "statistical",
    "temporal",
    "utils",
]
