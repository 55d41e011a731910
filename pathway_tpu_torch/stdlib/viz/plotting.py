"""Live plots from tables (reference:
python/pathway/stdlib/viz/plotting.py plot:35 — a user plotting function
over a Bokeh ColumnDataSource, streamed updates in notebooks).

Bokeh/Panel are optional: without them, `plot` returns a `PlotHandle`
exposing the same streaming `ColumnDataSource`-like dict the user function
receives, so pipelines remain testable headless; matplotlib (if present)
can render a static snapshot via `PlotHandle.to_matplotlib`."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List


class StreamingSource:
    """Dict-of-columns view of a table, updated from the change stream —
    the headless stand-in for bokeh's ColumnDataSource."""

    def __init__(self, table):
        self.column_names: List[str] = table.column_names()
        self._rows: Dict[Any, tuple] = {}
        self._lock = threading.Lock()
        self._listeners: List[Callable[[], None]] = []

        from pathway_tpu_torch.io._subscribe import subscribe

        def on_change(key, row, time, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[key] = tuple(row[c] for c in self.column_names)
                else:
                    self._rows.pop(key, None)
            for listener in list(self._listeners):
                listener()

        subscribe(table, on_change=on_change)

    @property
    def data(self) -> Dict[str, list]:
        with self._lock:
            rows = list(self._rows.values())
        return {
            name: [r[i] for r in rows]
            for i, name in enumerate(self.column_names)
        }

    def on_update(self, listener: Callable[[], None]) -> None:
        self._listeners.append(listener)


class PlotHandle:
    def __init__(self, source: StreamingSource, plotting_function):
        self.source = source
        self.plotting_function = plotting_function

    def to_matplotlib(self, x: str, y: str):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        data = self.source.data
        ax.plot(data[x], data[y], "o-")
        ax.set_xlabel(x)
        ax.set_ylabel(y)
        return fig


def plot(table, plotting_function: Callable, sorting_col=None):
    """reference: plotting.py plot:35."""
    try:
        import bokeh.models  # type: ignore
        import panel as pn  # type: ignore

        source = bokeh.models.ColumnDataSource(
            data={c: [] for c in table.column_names()}
        )
        fig = plotting_function(source)
        streaming = StreamingSource(table)

        def push():
            source.data = streaming.data

        streaming.on_update(push)
        return pn.Column(pn.pane.Bokeh(fig))
    except Exception:  # noqa: BLE001 — bokeh/panel absent
        source = StreamingSource(table)
        try:
            fig = plotting_function(source)
        except Exception:  # noqa: BLE001 — function expects bokeh API
            fig = None
        return PlotHandle(source, plotting_function)
