"""ML helpers (reference: python/pathway/stdlib/ml/utils.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def classifier_accuracy(predicted_labels: Table, exact_labels: Table) -> Table:
    """Counts of matching/mismatching predictions (reference:
    ml/utils.py classifier_accuracy:13). `predicted_labels` has
    `predicted_label`, `exact_labels` (same keys) has `label`."""
    comparative = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.restrict(predicted_labels).label,
    )
    comparative = comparative.select(
        thisclass.this.predicted_label,
        thisclass.this.label,
        match=comparative.label == comparative.predicted_label,
    )
    return comparative.groupby(comparative.match).reduce(
        cnt=reducers.count(),
        value=comparative.match,
    )
