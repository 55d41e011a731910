"""Live table visualization (reference:
python/pathway/stdlib/viz/table_viz.py show:26 — Panel/Bokeh live table in
notebooks, styled DataFrame snapshots).

Panel/Bokeh are optional: with them installed, `show` returns a live
`panel.Column` exactly like the reference; without them it returns a
`TableVisualization` handle whose snapshot renders as text/HTML — the same
subscribe-driven update loop either way."""

from __future__ import annotations

import threading
from typing import Any, Dict, List


class TableVisualization:
    """Accumulates a live snapshot of a table for display."""

    def __init__(self, table, *, include_id: bool = True, sorting_col=None):
        self.column_names: List[str] = table.column_names()
        self.include_id = include_id
        self.sorting_col = sorting_col
        self._rows: Dict[Any, tuple] = {}
        self._lock = threading.Lock()

        from pathway_tpu_torch.io._subscribe import subscribe

        def on_change(key, row, time, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[key] = tuple(
                        row[c] for c in self.column_names
                    )
                else:
                    self._rows.pop(key, None)

        subscribe(table, on_change=on_change)

    def snapshot(self) -> List[tuple]:
        with self._lock:
            items = list(self._rows.items())
        if self.sorting_col is not None:
            idx = self.column_names.index(self.sorting_col)
            items.sort(key=lambda kv: repr(kv[1][idx]))
        else:
            items.sort(key=lambda kv: kv[0])
        return items

    def to_pandas(self):
        import pandas as pd

        items = self.snapshot()
        df = pd.DataFrame(
            [v for _k, v in items], columns=self.column_names
        )
        if self.include_id:
            df.index = [repr(k) for k, _v in items]
        return df

    def __str__(self) -> str:
        items = self.snapshot()
        header = list(self.column_names)
        lines = [" | ".join(header)]
        for _k, values in items:
            lines.append(" | ".join(str(v) for v in values))
        return "\n".join(lines)

    def _repr_html_(self) -> str:
        try:
            return self.to_pandas().to_html()
        except Exception:  # noqa: BLE001
            return f"<pre>{self}</pre>"


def show(table, *, include_id: bool = True, short_pointers: bool = True,
         sorting_col=None, **kwargs):
    """reference: table_viz.py show:26. Returns a live panel when
    panel/bokeh are importable, else a TableVisualization handle."""
    viz = TableVisualization(
        table, include_id=include_id, sorting_col=sorting_col
    )
    try:
        import panel as pn  # type: ignore

        df_pane = pn.pane.DataFrame(viz.to_pandas(), **kwargs)

        def refresh():
            df_pane.object = viz.to_pandas()

        pn.state.add_periodic_callback(refresh, period=500)
        return pn.Column(df_pane)
    except Exception:  # noqa: BLE001 — panel absent: text-mode handle
        return viz


def _repr_mimebundle_(self, include, exclude):
    """Notebook hook grafted onto Table (reference: table_viz.py:20).

    Rendering a table must not mutate the graph (a bare `t` in a notebook
    cell would otherwise register one subscriber sink per display), so the
    repr shows the schema; `t.show()` / interactive mode give live data."""
    return {
        "text/plain": (
            repr(self)
            + " — call .show() or enable_interactive_mode() + .live() "
            "for data"
        )
    }
