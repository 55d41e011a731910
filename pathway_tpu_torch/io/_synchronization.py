"""Input synchronization groups (reference:
python/pathway/io/_synchronization.py:17
register_input_synchronization_group; Rust side
src/connectors/synchronization.rs:499 — readers are throttled so that the
tracked column's values never diverge by more than `max_difference` across
the group's sources).

A source thread about to emit a row whose tracked value runs too far ahead
of the slowest source blocks until the others catch up — the same
backpressure the reference applies inside the Rust connector runtime.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class SynchronizationGroup:
    def __init__(self, max_difference):
        self.max_difference = max_difference
        self._cond = threading.Condition()
        self._frontier: Dict[Any, Any] = {}  # source -> max value emitted
        self._pending: Dict[Any, Any] = {}  # source -> value it waits to emit
        self._active: set = set()

    def add_source(self, source, column_name: str) -> None:
        with self._cond:
            self._active.add(source)
            self._frontier.setdefault(source, None)
        source.sync_group = self
        source.sync_column = column_name

    def source_closed(self, source) -> None:
        with self._cond:
            self._active.discard(source)
            self._cond.notify_all()

    def _may_emit(self, source, value) -> bool:
        if self._frontier.get(source) is None:
            # every source may deliver its first value unconditionally
            return True
        others = [
            f
            for s, f in self._frontier.items()
            if s is not source and s in self._active
        ]
        if any(f is None for f in others):
            # an active source hasn't delivered yet: hold the group back
            # until it does (reference: synchronization.rs waits for all
            # sources' first values before advancing the window)
            return False
        if not others:
            return True
        return value <= min(others) + self.max_difference

    def _all_blocked_and_i_am_min(self, source, value) -> bool:
        # every active source is parked in wait_for: nobody can catch up, so
        # the window must advance — release the smallest pending value first
        # (reference: synchronization.rs advances the group window when all
        # readers are waiting)
        others = self._active - {source}
        if not all(s in self._pending for s in others):
            return False
        pendings = [self._pending[s] for s in others if self._pending[s] is not None]
        return not pendings or value <= min(pendings)

    def wait_for(self, source, value) -> None:
        """Block the reader thread until emitting `value` keeps the group
        within max_difference (reference: synchronization.rs throttling)."""
        if value is None:
            return
        with self._cond:
            self._pending[source] = value
            try:
                while (
                    not self._may_emit(source, value)
                    and not self._all_blocked_and_i_am_min(source, value)
                    and self._active - {source}
                ):
                    self._cond.wait(timeout=0.5)
            finally:
                self._pending.pop(source, None)
            prev = self._frontier.get(source)
            if prev is None or value > prev:
                self._frontier[source] = value
            self._cond.notify_all()


def register_input_synchronization_group(
    *columns, max_difference, name: str | None = None
) -> SynchronizationGroup:
    """Align several input connectors on a shared column, e.g. event time
    (reference: io/_synchronization.py:17). Each argument is a
    ColumnReference on a connector-backed table; sources are throttled so
    the column's values across sources stay within `max_difference`.
    """
    group = SynchronizationGroup(max_difference)
    for column in columns:
        table = column.table
        live = getattr(table, "_live_source", None)
        if live is None:
            raise ValueError(
                "synchronization groups require connector-backed tables "
                "(pw.io.* read with streaming mode)"
            )
        group.add_source(live, column.name)
    return group
