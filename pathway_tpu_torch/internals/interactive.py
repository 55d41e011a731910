"""Interactive mode — live-updating table snapshots in notebooks
(reference: python/pathway/internals/interactive.py:130
enable_interactive_mode + LiveTable over the engine's export machinery).

`pw.enable_interactive_mode()` arms the mode; `table.live()` (or
`LiveTable._create(table)`) registers an export sink and — on first use —
launches the whole current graph on a background thread. The LiveTable
handle then renders the table's current state at any moment while the
stream keeps running, via the same ExportedTable bridge other graphs can
import (internals/api.py, reference export.rs:207)."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class InteractiveModeNotEnabled(RuntimeError):
    pass


class _InteractiveState:
    def __init__(self):
        self.enabled = False
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def running(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


_state = _InteractiveState()


def enable_interactive_mode() -> None:
    """reference: pw.enable_interactive_mode (interactive.py:130)."""
    _state.enabled = True


def is_interactive_mode_enabled() -> bool:
    return _state.enabled


def _launch_background_run() -> None:
    if _state.running():
        return
    from pathway_tpu_torch.internals.runner import run

    def runner():
        try:
            run()
        except BaseException as exc:  # noqa: BLE001 — surfaced via .failed
            _state.error = exc

    _state.thread = threading.Thread(
        target=runner, daemon=True, name="pathway-interactive"
    )
    _state.thread.start()


class LiveTable:
    """A live view over a running table (reference: interactive.py
    LiveTable:130). Snapshot access while the background engine runs."""

    def __init__(self, table):
        if not _state.enabled:
            raise InteractiveModeNotEnabled(
                "call pw.enable_interactive_mode() first"
            )
        from pathway_tpu_torch.internals.api import export_table

        self.column_names: List[str] = table.column_names()
        self._exported = export_table(table)

    @classmethod
    def _create(cls, table) -> "LiveTable":
        lt = cls(table)
        _launch_background_run()
        return lt

    @property
    def failed(self) -> bool:
        return _state.error is not None

    @property
    def finished(self) -> bool:
        return self._exported.closed

    def snapshot(self) -> Dict[Any, tuple]:
        return self._exported.snapshot()

    def to_pandas(self):
        import pandas as pd

        rows = self.snapshot()
        return pd.DataFrame(
            list(rows.values()), columns=self.column_names,
            index=[repr(k) for k in rows],
        )

    def __str__(self) -> str:
        rows = self.snapshot()
        lines = [" | ".join(self.column_names)]
        for _k, values in sorted(rows.items()):
            lines.append(" | ".join(str(v) for v in values))
        return "\n".join(lines)

    def _repr_pretty_(self, p, cycle: bool) -> None:
        p.text(str(self))


def live(table) -> LiveTable:
    """Grafted onto Table as `.live()`."""
    return LiveTable._create(table)
