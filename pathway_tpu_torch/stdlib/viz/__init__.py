"""pw.viz — live table/plot visualization (reference:
python/pathway/stdlib/viz/). Grafts `.show()` and `.plot()` onto Table as
the reference does."""

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.viz.plotting import PlotHandle, StreamingSource, plot
from pathway_tpu_torch.stdlib.viz.table_viz import (
    TableVisualization,
    _repr_mimebundle_,
    show,
)

from pathway_tpu_torch.internals.interactive import live as _live

Table.show = show
Table.live = _live
Table.plot = plot
Table._repr_mimebundle_ = _repr_mimebundle_

__all__ = [
    "PlotHandle",
    "StreamingSource",
    "TableVisualization",
    "plot",
    "show",
]
