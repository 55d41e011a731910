"""pw.ordered — order-aware helpers (reference:
python/pathway/stdlib/ordered/diff.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar


def diff(table, timestamp, *values, instance=None):
    """Difference with the previous row in `timestamp` order (reference:
    stdlib/ordered/diff.py — built on sort's prev pointers).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... t | v
    ... 1 | 10
    ... 2 | 13
    ... 3 | 11
    ... ''')
    >>> res = t.diff(pw.this.t, pw.this.v)
    >>> pw.debug.compute_and_print(
    ...     res.select(v=pw.this.diff_v), include_id=False
    ... )
    v
    -2
    None
    3
    """
    mapping = {thisclass.this: table}
    ts = desugar(timestamp, mapping)
    from pathway_tpu_torch.internals.api import require, unwrap

    sorted_t = table.sort(key=ts, instance=instance)
    prev_rows = table.ix(sorted_t.prev, optional=True)
    cols = {}
    for v in values:
        ref = desugar(v, mapping)
        # first row (prev is None) gets None, not an Error (reference:
        # ordered/diff.py wraps the subtraction in pw.require on prev)
        cols[f"diff_{ref.name}"] = require(
            ref - unwrap(prev_rows[ref.name]), sorted_t.prev
        )
    return table.select(**cols)


__all__ = ["diff"]
