"""pw.statistical (reference:
python/pathway/stdlib/statistical/_interpolate.py)."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.api import apply_with_type, coalesce, if_else
from pathway_tpu_torch.internals.desugaring import desugar


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def _linear_interpolate(t, prev_t, prev_v, next_t, next_v):
    if prev_v is None and next_v is None:
        return None
    if prev_v is None:
        return float(next_v)
    if next_v is None:
        return float(prev_v)
    if next_t == prev_t:
        return float(prev_v)
    w = (t - prev_t) / (next_t - prev_t)
    return float(prev_v) + w * (float(next_v) - float(prev_v))


def interpolate(table, timestamp, *values, mode: InterpolateMode = InterpolateMode.LINEAR):
    """Linear interpolation of missing values over time order (reference:
    stdlib/statistical/_interpolate.py).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... t | v
    ... 0 | 0
    ... 2 |
    ... 4 | 4
    ... ''')
    >>> res = t.interpolate(pw.this.t, pw.this.v)
    >>> pw.debug.compute_and_print(
    ...     res.select(v=pw.this.v), include_id=False
    ... )
    v
    4
    0
    2.0
    """
    if mode is not InterpolateMode.LINEAR:
        raise ValueError("only linear interpolation is supported")
    mapping = {thisclass.this: table}
    ts = desugar(timestamp, mapping)
    sorted_t = table.sort(key=ts)
    prev_rows = table.ix(sorted_t.prev, optional=True)
    next_rows = table.ix(sorted_t.next, optional=True)
    cols = {ts.name: ts} if hasattr(ts, "name") else {}
    for v in values:
        ref = desugar(v, mapping)
        # walk to neighbors; a full interpolation to farther rows requires
        # iterate; single-step interpolation covers the common case
        cols[ref.name] = coalesce(
            ref,
            apply_with_type(
                _linear_interpolate,
                float | None,
                ts,
                prev_rows[ts.name] if hasattr(ts, "name") else None,
                prev_rows[ref.name],
                next_rows[ts.name] if hasattr(ts, "name") else None,
                next_rows[ref.name],
            ),
        )
    return table.select(**cols)


__all__ = ["interpolate", "InterpolateMode"]
