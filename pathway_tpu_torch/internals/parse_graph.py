"""Global lazy parse graph (reference:
python/pathway/internals/parse_graph.py — `G = ParseGraph()`).

Tables are lazy: each holds a build closure over its dependency tables.
The graph object registers *sinks* (output connectors, subscribes) and
iteration contexts so `pw.run()` knows what to execute, and gives tests a
`clear()` to reset state between cases.

The graph also carries the static-analysis substrate (analysis/):
`register_table` keeps a weakref to every constructed Table so the
dead-subgraph pass can see tables that never reach a sink, and
`record_op` attaches an `OpSpec` to op-result tables — kind, input
tables, and the expressions the op closed over.  Build closures capture
dependencies invisibly; OpSpec is the explicit edge the analyzer walks.
"""

from __future__ import annotations

import itertools
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class SinkSpec:
    """A registered output: tables to build + a hook attaching the engine
    sink node (subscribe callback, writer, ...)."""

    def __init__(self, tables: list, attach: Callable):
        self.tables = tables
        self.attach = attach


@dataclass
class OpSpec:
    """Analyzer-visible description of the operation that produced a
    table.  `inputs` are the upstream Tables (the same objects the build
    closure captured), `exprs` is a kind-specific expression payload, and
    `synthetic` marks ops issued from inside the package (stdlib/temporal
    machinery) rather than directly from user code."""

    kind: str
    op_id: int
    inputs: Tuple[Any, ...]
    exprs: Dict[str, Any] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)
    synthetic: bool = False


# Files implementing the public op layer itself: frames inside them are
# skipped when deciding whether an op call came from user code or from
# another package module (which would make the op synthetic).
_OP_LAYER_SUFFIXES = (
    "internals/parse_graph.py",
    "internals/table.py",
    "internals/joins.py",
    "internals/groupbys.py",
    "internals/iterate.py",
    "internals/desugaring.py",
    "internals/thisclass.py",
    "internals/expression.py",
)


def _called_from_package() -> bool:
    """True when the nearest frame outside the op layer is still inside
    the pathway_tpu_torch package — i.e. the op was issued by library code."""
    from pathway_tpu_torch.internals.trace import _PACKAGE_DIR

    frame = sys._getframe(2)
    while frame is not None:
        fn = frame.f_code.co_filename
        if not fn.endswith(_OP_LAYER_SUFFIXES):
            return fn.startswith(_PACKAGE_DIR)
        frame = frame.f_back
    return False


@dataclass
class MarkerSpec:
    """A graph-level analyzer fact not tied to one result table —
    temporal entry points record these (the Table only materializes
    later, from .select()/.reduce() on the intermediate result)."""

    kind: str
    info: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None


class ParseGraph:
    def __init__(self):
        self.sinks: List[SinkSpec] = []
        self.sources: List[Any] = []  # streaming connector descriptors
        self.node_counter = itertools.count()
        self.op_counter = itertools.count()
        self.cache: dict = {}  # misc per-graph caches (udf caches etc.)
        # weakrefs: iterate's fixpoint loop constructs tables per
        # iteration; strong refs would pin every generation
        self.all_tables: List[weakref.ref] = []
        self.markers: List[MarkerSpec] = []

    def add_sink(self, tables: list, attach: Callable) -> None:
        self.sinks.append(SinkSpec(tables, attach))

    def add_source(self, source: Any) -> None:
        self.sources.append(source)

    def register_table(self, table: Any) -> None:
        tables = self.all_tables
        if len(tables) > 4096:
            self.all_tables = tables = [r for r in tables if r() is not None]
        tables.append(weakref.ref(table))

    def live_tables(self) -> List[Any]:
        return [t for t in (r() for r in self.all_tables) if t is not None]

    def pending_sources(self) -> List[Any]:
        """Connector descriptors visible to the analyzer: build_streaming
        registers LiveSources into `sources` only at build time, but
        analysis runs before any build — connector tables carry their
        descriptor as `_live_source` from DSL time, so the union (deduped
        by identity, registration order first) is the pre-build view the
        mesh pass (PWT405) lints."""
        out: List[Any] = []
        seen: set = set()
        for src in self.sources:
            if id(src) not in seen:
                seen.add(id(src))
                out.append(src)
        for t in self.live_tables():
            # vars() sidesteps Table.__getattr__'s column-lookup fallback
            live = vars(t).get("_live_source")
            if live is not None and id(live) not in seen:
                seen.add(id(live))
                out.append(live)
        return out

    def clear(self) -> None:
        self.__init__()


def record_op(
    table: Any,
    kind: str,
    inputs: tuple,
    exprs: Optional[Dict[str, Any]] = None,
    **info: Any,
) -> Any:
    """Attach an OpSpec to an op-result table (and return the table, so
    call sites can wrap their `return`)."""
    table._op = OpSpec(
        kind=kind,
        op_id=next(G.op_counter),
        inputs=tuple(inputs),
        exprs=exprs or {},
        info=info,
        synthetic=_called_from_package(),
    )
    return table


def record_marker(kind: str, **info: Any) -> None:
    """Record a table-less analyzer fact with the user frame that
    produced it (e.g. a temporal join call and whether it got a
    behavior)."""
    from pathway_tpu_torch.internals.trace import trace_user_frame

    G.markers.append(
        MarkerSpec(kind=kind, info=info, trace=trace_user_frame())
    )


G = ParseGraph()
