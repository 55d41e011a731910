"""Graph access layer for the analyzer.

The parse graph records an `OpSpec` on every op-result table
(`internals/parse_graph.record_op`) — kind, input tables, expression
payload.  This module turns that flat record into the views the passes
need: the anchored set (tables reachable upstream from a sink), a
consumer index for downstream reachability, expression traversal, and a
best-effort dtype resolver.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    IdReference,
)
from pathway_tpu_torch.internals.type_interpreter import infer_dtype


def walk_expr(expr: Any) -> Iterator[ColumnExpression]:
    """Yield `expr` and every sub-expression, in pre-order.  Children are
    discovered structurally (any ColumnExpression attribute, or tuple /
    list / dict attribute containing one), matching how expression
    classes store operands."""
    if not isinstance(expr, ColumnExpression):
        return
    stack: List[ColumnExpression] = [expr]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ColumnReference):
            continue  # leaf: do not follow the _table backref
        for value in vars(node).values():
            if isinstance(value, ColumnExpression):
                stack.append(value)
            elif isinstance(value, (tuple, list)):
                for v in value:
                    if isinstance(v, ColumnExpression):
                        stack.append(v)
            elif isinstance(value, dict):
                for v in value.values():
                    if isinstance(v, ColumnExpression):
                        stack.append(v)


def op_exprs(op: Any) -> Iterator[ColumnExpression]:
    """Every expression the op's payload closes over, flattened."""
    for value in op.exprs.values():
        if isinstance(value, ColumnExpression):
            yield value
        elif isinstance(value, (tuple, list)):
            for v in value:
                if isinstance(v, ColumnExpression):
                    yield v
        elif isinstance(value, dict):
            for v in value.values():
                if isinstance(v, ColumnExpression):
                    yield v


def resolve_ref_dtype(ref: ColumnReference) -> dt.DType:
    if isinstance(ref, IdReference):
        return dt.POINTER
    return ref._table._schema[ref.name].dtype


def infer(expr: ColumnExpression) -> Optional[dt.DType]:
    """Best-effort dtype of an expression; None when inference fails
    (the analyzer then stays silent rather than guessing)."""
    try:
        return infer_dtype(expr, resolve_ref_dtype)
    except Exception:  # noqa: BLE001
        return None


class GraphView:
    """Immutable snapshot of the parse graph, indexed for analysis."""

    def __init__(self, graph: Any, extra_tables: Iterable[Any] = ()):
        self.graph = graph
        self.markers = list(graph.markers)
        self.sink_tables: List[Any] = []
        seen_sink: Set[int] = set()
        for spec in graph.sinks:
            for t in spec.tables:
                if id(t) not in seen_sink:
                    seen_sink.add(id(t))
                    self.sink_tables.append(t)
        for t in extra_tables:
            if id(t) not in seen_sink:
                seen_sink.add(id(t))
                self.sink_tables.append(t)

        # anchored: everything a sink transitively depends on
        self.anchored: List[Any] = []
        self._anchored_ids: Set[int] = set()
        stack = list(self.sink_tables)
        while stack:
            t = stack.pop()
            if id(t) in self._anchored_ids:
                continue
            self._anchored_ids.add(id(t))
            self.anchored.append(t)
            op = getattr(t, "_op", None)
            if op is not None:
                stack.extend(op.inputs)

        # every table the analyzer can see: anchored first (dead tables
        # may already be garbage-collected; live_tables catches the rest)
        self.tables: List[Any] = list(self.anchored)
        known = set(self._anchored_ids)
        for t in graph.live_tables():
            if id(t) not in known:
                known.add(id(t))
                self.tables.append(t)

        # one sweep over the visible tables builds every index the passes
        # share: the consumer map, the (table, op) pair lists behind
        # ops(), the anchored per-kind buckets, and the connector tables
        # carrying a live-source descriptor.  vars() sidesteps
        # Table.__getattr__'s column-lookup fallback.
        self.sink_ids: Set[int] = seen_sink
        self.consumers: Dict[int, List[Any]] = {}
        self.anchored_by_kind: Dict[str, List[Any]] = {}
        self.live_source_tables: List[Any] = []
        self._all_pairs: List[Any] = []
        self._anchored_pairs: List[Any] = []
        self._anchored_consumers: Dict[int, List[Any]] = {}
        anchored_ids = self._anchored_ids
        for t in self.tables:
            d = vars(t)
            live = d.get("_live_source")
            if live is not None:
                self.live_source_tables.append((live, t))
            op = d.get("_op")
            if op is None:
                continue
            self._all_pairs.append((t, op))
            anchored = id(t) in anchored_ids
            if anchored:
                self._anchored_pairs.append((t, op))
                self.anchored_by_kind.setdefault(op.kind, []).append((t, op))
            for inp in op.inputs:
                self.consumers.setdefault(id(inp), []).append(t)
                if anchored:
                    self._anchored_consumers.setdefault(
                        id(inp), []
                    ).append(t)

        self._apply_index: Optional[Dict[int, Tuple[Any, ...]]] = None
        self._apply_sites: Optional[List[Any]] = None
        self._label_cache: Dict[int, str] = {}

    def apply_index(self) -> Dict[int, Tuple[Any, ...]]:
        """table id -> deduped ApplyExpression nodes in that table's op
        payload, in expression-walk order.  Four passes scan for UDF call
        sites (udf_pass, embedder_pass, the fusion planner's barrier
        check and the mesh pass's embedder-marker scan); the graph is
        immutable under this view, so the expression walk happens once
        and everyone shares the result."""
        if self._apply_index is None:
            idx: Dict[int, Tuple[Any, ...]] = {}
            rows: List[Any] = []
            for t, op in self.ops():
                seen: Set[int] = set()
                sites: List[Any] = []
                for expr in op_exprs(op):
                    for node in walk_expr(expr):
                        if (
                            isinstance(node, ApplyExpression)
                            and id(node) not in seen
                        ):
                            seen.add(id(node))
                            sites.append(node)
                if sites:
                    idx[id(t)] = tuple(sites)
                    rows.append((t, op, tuple(sites)))
            self._apply_index = idx
            self._apply_sites = rows
        return self._apply_index

    def apply_sites(self) -> List[Any]:
        """(table, op, ApplyExpression sites) rows for every op that
        calls at least one UDF, in ops() order.  The UDF-centric passes
        iterate this short list instead of scanning every op."""
        if self._apply_sites is None:
            self.apply_index()
        return self._apply_sites

    def is_anchored(self, table: Any) -> bool:
        return id(table) in self._anchored_ids

    def anchored_consumers(self) -> Dict[int, List[Any]]:
        """Consumer index restricted to the anchored region (built in
        __init__).  Only anchored consumers are ever built, so only they
        pin a table's materialization — this is the index the fusion
        planner walks (a dead reader must not break an otherwise fusable
        chain)."""
        return self._anchored_consumers

    def ops(self, *, anchored_only: bool = False) -> Iterator[Any]:
        """(table, op) pairs, de-duplicated, anchored tables first
        (precomputed in __init__)."""
        return iter(self._anchored_pairs if anchored_only else self._all_pairs)

    def graph_path(self, table: Any, depth: int = 5) -> str:
        """Short upstream chain for trace-less findings:
        "select#7 <- join#3 <- source"."""
        parts: List[str] = []
        t = table
        while t is not None and len(parts) < depth:
            op = getattr(t, "_op", None)
            if op is None:
                parts.append("source")
                break
            parts.append(f"{op.kind}#{op.op_id}")
            t = op.inputs[0] if op.inputs else None
        else:
            if t is not None:
                parts.append("...")
        return " <- ".join(parts)

    def op_label(self, table: Any) -> str:
        """The trace-fallback operator label: kind#op_id plus path.
        Memoized — every pass labels the tables it reports on, and the
        upstream path never changes under this view."""
        label = self._label_cache.get(id(table))
        if label is None:
            op = vars(table).get("_op")
            if op is None:
                label = "source"
            else:
                path = self.graph_path(table)
                label = f"{op.kind}#{op.op_id} ({path})"
            self._label_cache[id(table)] = label
        return label

    def reaches_kind(self, table: Any, kinds: Set[str]) -> bool:
        """Does any transitive consumer of `table` run an op in `kinds`?"""
        stack = list(self.consumers.get(id(table), ()))
        seen: Set[int] = set()
        while stack:
            t = stack.pop()
            if id(t) in seen:
                continue
            seen.add(id(t))
            op = getattr(t, "_op", None)
            if op is not None and op.kind in kinds:
                return True
            stack.extend(self.consumers.get(id(t), ()))
        return False
