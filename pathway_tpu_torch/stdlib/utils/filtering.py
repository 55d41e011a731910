"""Row filters (reference: python/pathway/stdlib/utils/filtering.py).

>>> import pathway_tpu_torch as pw
>>> from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows
>>> t = pw.debug.table_from_markdown('''
... g | v
... a | 1
... a | 5
... b | 2
... ''')
>>> pw.debug.compute_and_print(
...     argmax_rows(t, pw.this.g, what=pw.this.v), include_id=False
... )
g | v
b | 2
a | 5
"""

from __future__ import annotations

from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table


def argmax_rows(table: Table, *on, what) -> Table:
    """Keep, per group of `on`, the row maximizing `what` (reference:
    filtering.py argmax_rows:8)."""
    filter_t = (
        table.groupby(*on)
        .reduce(argmax_id=reducers.argmax(what))
        .with_id(thisclass.this.argmax_id)
    )
    return table.restrict(filter_t)


def argmin_rows(table: Table, *on, what) -> Table:
    filter_t = (
        table.groupby(*on)
        .reduce(argmin_id=reducers.argmin(what))
        .with_id(thisclass.this.argmin_id)
    )
    return table.restrict(filter_t)
