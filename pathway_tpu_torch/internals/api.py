"""Top-level expression/table functions: pw.apply, pw.cast, pw.if_else, ...

TPU-native rebuild of the reference's top-level namespace (reference:
python/pathway/__init__.py, internals/common.py).
"""

from __future__ import annotations

import enum as _enum
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    FullyAsyncApplyExpression,
    IfElseExpression,
    MakeTupleExpression,
    RequireExpression,
    UnwrapExpression,
    smart_wrap,
)


def _infer_return_type(fun: Callable) -> Any:
    hints = typing.get_type_hints(fun) if callable(fun) else {}
    return hints.get("return", Any)


def apply(fun: Callable, *args, **kwargs) -> ColumnExpression:
    """Apply a python function rowwise (reference: pw.apply).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a
    ... 2
    ... ''')
    >>> r = t.select(sq=pw.apply(lambda x: x * x, pw.this.a))
    >>> pw.debug.compute_and_print(r, include_id=False)
    sq
    4
    """
    return ApplyExpression(fun, _infer_return_type(fun), *args, **kwargs)


def apply_with_type(fun: Callable, ret_type, *args, **kwargs) -> ColumnExpression:
    return ApplyExpression(fun, ret_type, *args, **kwargs)


def apply_async(fun: Callable, *args, **kwargs) -> ColumnExpression:
    return ApplyExpression(
        fun, _infer_return_type(fun), *args, is_async=True, **kwargs
    )


def apply_fully_async(fun: Callable, *args, **kwargs) -> ColumnExpression:
    return FullyAsyncApplyExpression(
        fun, _infer_return_type(fun), *args, is_async=True, **kwargs
    )


def cast(target_type, col) -> ColumnExpression:
    return CastExpression(dt.wrap(target_type), col)


def declare_type(target_type, col) -> ColumnExpression:
    return DeclareTypeExpression(dt.wrap(target_type), col)


def if_else(if_clause, then_clause, else_clause) -> ColumnExpression:
    """Ternary expression (reference: pw.if_else).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a
    ... 1
    ... 5
    ... ''')
    >>> r = t.select(kind=pw.if_else(pw.this.a > 3, "big", "small"))
    >>> pw.debug.compute_and_print(r, include_id=False)
    kind
    small
    big
    """
    return IfElseExpression(if_clause, then_clause, else_clause)


def coalesce(*args) -> ColumnExpression:
    """First non-None argument (reference: pw.coalesce).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a | b
    ... 1 |
    ...   | 2
    ... ''')
    >>> r = t.select(v=pw.coalesce(pw.this.a, pw.this.b))
    >>> pw.debug.compute_and_print(r, include_id=False)
    v
    1
    2
    """
    return CoalesceExpression(*args)


def require(val, *deps) -> ColumnExpression:
    return RequireExpression(val, *deps)


def unwrap(col) -> ColumnExpression:
    """Strip Optional from a column's type, asserting no Nones at runtime
    (reference: pw.unwrap).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a
    ... 1
    ... ''')
    >>> t.select(v=pw.unwrap(pw.this.a)).typehints()["v"]
    <class 'int'>
    """
    return UnwrapExpression(col)


def fill_error(col, replacement) -> ColumnExpression:
    return FillErrorExpression(col, replacement)


def make_tuple(*args) -> ColumnExpression:
    """Pack expressions into a tuple column (reference: pw.make_tuple).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a | b
    ... 1 | 2
    ... ''')
    >>> r = t.select(pair=pw.make_tuple(pw.this.a, pw.this.b))
    >>> pw.debug.compute_and_print(r, include_id=False)
    pair
    (1, 2)
    """
    return MakeTupleExpression(*args)


def assert_table_has_schema(
    table,
    schema,
    *,
    allow_superset: bool = True,
    ignore_primary_keys: bool = True,
) -> None:
    schema.assert_matches_schema(
        table.schema,
        allow_superset=allow_superset,
        ignore_primary_keys=ignore_primary_keys,
    )


def table_transformer(func=None, **kwargs):
    """Decorator marking a Table -> Table transformer (reference:
    pw.table_transformer); checks are advisory here."""

    def wrap_fn(f):
        return f

    if func is None:
        return wrap_fn
    return wrap_fn(func)


def iterate(func, iteration_limit: int | None = None, **kwargs):
    """Fixed-point iteration (reference: pw.iterate, internals
    complex_columns.rs / Graph::iterate:895).

    Runs `func` on snapshot tables repeatedly until outputs stop changing
    (or `iteration_limit`), per engine time. The body is re-executed as a
    nested batch dataflow on each iteration — idiomatic for a
    recompute-based engine; XLA-compiled bodies amortize via jit caching.
    """
    from pathway_tpu_torch.internals.iterate import iterate_impl

    if iteration_limit is not None and iteration_limit < 1:
        raise ValueError("wrong iteration limit")
    return iterate_impl(func, iteration_limit=iteration_limit, **kwargs)


class ExportedTable:
    """Bridge between separate graphs (reference: export.rs:207
    ExportedTable — frontier + data access + on-update subscription;
    Graph::export_table graph.rs:954).

    While the exporting graph runs, the handle accumulates the table's
    state; other graphs (or threads) import it as a source. `subscribe`
    callbacks fire per delta, enabling live cross-graph feeds."""

    def __init__(self, schema, column_names):
        import threading

        self.schema = schema
        self.column_names = list(column_names)
        self._rows: dict = {}
        self._subscribers: list = []
        self._lock = threading.Lock()
        self.closed = False

    # -- producer side (called by the exporting graph's sink) ------------
    def _apply(self, deltas) -> None:
        with self._lock:
            for key, values, diff in deltas:
                if diff > 0:
                    self._rows[key] = values
                else:
                    self._rows.pop(key, None)
            subs = list(self._subscribers)
        for cb in subs:
            cb(deltas)

    def _close(self) -> None:
        self.closed = True
        with self._lock:
            subs = list(self._subscribers)
        for cb in subs:
            cb(None)  # end-of-stream marker

    # -- consumer side ---------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._rows)

    def subscribe(self, cb) -> dict:
        """Register cb(deltas | None); returns the state snapshot current
        at registration (no gap between snapshot and stream)."""
        with self._lock:
            self._subscribers.append(cb)
            return dict(self._rows)


def export_table(table) -> ExportedTable:
    """Register an export sink on the current graph (reference:
    Graph::export_table). The handle fills while the graph runs."""
    from pathway_tpu_torch.internals.parse_graph import G

    exported = ExportedTable(table._schema, table.column_names())

    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import SubscribeNode

        (node,) = nodes

        def on_change(key, row, time, is_addition):
            exported._apply(
                [(key, tuple(row[c] for c in exported.column_names),
                  1 if is_addition else -1)]
            )

        SubscribeNode(
            ctx.engine,
            node,
            on_change=on_change,
            on_end=exported._close,
            column_names=exported.column_names,
        )

    G.add_sink([table], attach)
    return exported


def import_table(exported: ExportedTable):
    """Materialize an ExportedTable as a source in the current graph
    (reference: Graph::import_table). If the exporting graph has finished,
    this is a static table; if it is still live (another thread), updates
    stream through a connector subject."""
    from pathway_tpu_torch.io.python import ConnectorSubject, read

    class _ImportSubject(ConnectorSubject):
        def run(self) -> None:
            import queue as queue_mod

            q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
            snapshot = exported.subscribe(q.put)
            names = exported.column_names
            # rows keep their original pointers across the graph boundary
            # (_pw_key is honored by the connector sink)
            for key, values in snapshot.items():
                self.next(_pw_key=key, **dict(zip(names, values)))
            self.commit()
            if exported.closed:
                return
            while True:
                deltas = q.get()
                if deltas is None:
                    return
                for key, values, diff in deltas:
                    row = {"_pw_key": key, **dict(zip(names, values))}
                    if diff > 0:
                        self.next(**row)
                    else:
                        self._remove(row)
                self.commit()

    return read(_ImportSubject, schema=exported.schema)


class PathwayType:
    """Connector-facing type tags (reference: engine.pyi PathwayType:34,
    exported as ``pw.Type``). Each tag IS the corresponding internal
    dtype, so schemas built from these flow through unchanged."""

    ANY = dt.ANY
    STRING = dt.STR
    INT = dt.INT
    BOOL = dt.BOOL
    FLOAT = dt.FLOAT
    POINTER = dt.POINTER
    DATE_TIME_NAIVE = dt.DATE_TIME_NAIVE
    DATE_TIME_UTC = dt.DATE_TIME_UTC
    DURATION = dt.DURATION
    JSON = dt.JSON
    BYTES = dt.BYTES
    PY_OBJECT_WRAPPER = dt.PY_OBJECT_WRAPPER

    @staticmethod
    def optional(arg):
        return dt.Optionalize(arg)

    @staticmethod
    def array(dim=None, wrapped=None):
        return dt.ArrayDType(
            dim, wrapped if wrapped is not None else dt.ANY
        )

    @staticmethod
    def tuple(*args):
        return dt.TupleDType(tuple(args))

    @staticmethod
    def list(arg):
        return dt.ListDType(arg)

    @staticmethod
    def future(arg):
        return dt.Future(arg)


class PersistenceMode(_enum.Enum):
    """reference: engine.pyi PersistenceMode:937. The engine honors
    PERSISTING/OPERATOR_PERSISTING (input + operator snapshots) and the
    replay modes through PATHWAY_REPLAY_MODE; the rest are accepted for
    config parity."""

    BATCH = "batch"
    SPEEDRUN_REPLAY = "speedrun_replay"
    REALTIME_REPLAY = "realtime_replay"
    PERSISTING = "persisting"
    SELECTIVE_PERSISTING = "selective_persisting"
    UDF_CACHING = "udf_caching"
    OPERATOR_PERSISTING = "operator_persisting"
