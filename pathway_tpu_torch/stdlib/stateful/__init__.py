"""pw.stateful (reference: python/pathway/stdlib/stateful/deduplicate.py)."""

from __future__ import annotations

from typing import Any, Callable


def deduplicate(
    table,
    *,
    value=None,
    col=None,
    instance=None,
    acceptor: Callable[[Any, Any], bool] | None = None,
    name: str | None = None,
    persistent_id: str | None = None,
):
    """Keep the latest accepted value per instance (reference:
    stdlib/stateful/deduplicate.py).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... instance | v | __time__
    ... 1        | 1 |     2
    ... 1        | 5 |     4
    ... ''')
    >>> res = pw.stateful.deduplicate(
    ...     t, value=pw.this.v, instance=pw.this.instance,
    ...     acceptor=lambda new, old: new > old,
    ... )
    >>> pw.debug.compute_and_print(
    ...     res.select(v=pw.this.v), include_id=False
    ... )
    v
    5
    """
    return table.deduplicate(
        value=value if value is not None else col,
        instance=instance,
        acceptor=acceptor,
        name=name,
    )


__all__ = ["deduplicate"]
