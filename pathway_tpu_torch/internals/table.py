"""The Table DSL — lazy, typed, keyed collections.

TPU-native rebuild of the reference Table (reference:
python/pathway/internals/table.py:53 — 108 methods). A Table is a schema +
universe + a build closure producing its engine node; operations compose
build closures lazily, and `pw.run()` / `pw.debug` drive the engine.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Type

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar, expand_select_args
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    BinaryOpExpression,
    CastExpression,
    ColumnExpression,
    ColumnReference,
    DeclareTypeExpression,
    IdReference,
    PointerExpression,
    ReducerExpression,
    collect_tables,
    collect_tables_ordered,
    smart_wrap,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
    schema_from_types,
)
from pathway_tpu_torch.internals.type_interpreter import infer_dtype
from pathway_tpu_torch.internals.universe import Universe, solver

_table_names = itertools.count()


class Table:
    """A lazy keyed table (reference: internals/table.py Table:53)."""

    def __init__(
        self,
        *,
        schema: Type[Schema],
        universe: Universe,
        build: Callable,
        name: str | None = None,
    ):
        self._schema = schema
        self._universe = universe
        self._build = build
        self._name = name or f"table_{next(_table_names)}"
        # remember which user line created this operator; engine errors
        # resurface it (reference: internals/trace.py)
        from pathway_tpu_torch.internals.trace import trace_user_frame

        self._trace = trace_user_frame()
        # analysis substrate: ops attach an OpSpec after construction; the
        # graph keeps a weakref so the dead-subgraph pass can see tables
        # that never reach a sink
        self._op = None
        from pathway_tpu_torch.internals.parse_graph import G

        G.register_table(self)

    # -- introspection ----------------------------------------------------
    @property
    def schema(self) -> Type[Schema]:
        return self._schema

    @property
    def id(self) -> IdReference:
        return IdReference(self)

    def column_names(self) -> List[str]:
        return list(self._schema.keys())

    def keys(self):
        return self._schema.keys()

    def typehints(self) -> Dict[str, Any]:
        return self._schema.typehints()

    def dtypes(self) -> Dict[str, dt.DType]:
        return self._schema.dtypes()

    @property
    def _event_stream(self) -> bool:
        """True for multiset event streams (to_stream outputs and their
        derivations) — the universe carries the property so every derived
        table inherits it."""
        return self._universe.multiset

    @property
    def C(self) -> "ColumnNamespace":
        return ColumnNamespace(self)

    @property
    def slice(self) -> "TableSlice":
        return TableSlice(self, self.column_names())

    def __repr__(self):
        cols = ", ".join(
            f"{n}: {c.dtype!r}" for n, c in self._schema.columns().items()
        )
        return f"<pw.Table {self._name}({cols})>"

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        if name == "id":
            return IdReference(self)
        schema = object.__getattribute__(self, "_schema")
        if name not in schema.keys():
            raise AttributeError(
                f"table {self._name!r} has no column {name!r}; "
                f"columns: {self.column_names()}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, str):
            if arg == "id":
                return IdReference(self)
            if arg not in self._schema.keys():
                raise KeyError(
                    f"table {self._name!r} has no column {arg!r}; "
                    f"columns: {self.column_names()}"
                )
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return self[arg.name]
        from pathway_tpu_torch.internals.expression import ThisColumnReference

        if isinstance(arg, ThisColumnReference):
            return self[arg.name]
        if isinstance(arg, (list, tuple)):
            return self.select(*(self[c] for c in arg))
        raise TypeError(f"cannot index table with {arg!r}")

    def __iter__(self):
        raise TypeError("a Table is not iterable; use pw.debug utilities")

    # -- mapping context --------------------------------------------------
    def _mapping(self) -> dict:
        return {thisclass.this: self}

    def _infer(self, expr: ColumnExpression) -> dt.DType:
        def resolve(ref: ColumnReference) -> dt.DType:
            if isinstance(ref, IdReference):
                return dt.POINTER
            return ref._table._schema[ref.name].dtype

        return infer_dtype(expr, resolve)

    # -- core transformations --------------------------------------------
    def select(self, *args, **kwargs) -> "Table":
        """Project/compute columns (reference: table.py select).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b
        ... 3 | 4
        ... 5 | 6
        ... ''')
        >>> r = t.select(pw.this.a, total=pw.this.a + pw.this.b)
        >>> pw.debug.compute_and_print(r, include_id=False)
        a | total
        3 | 7
        5 | 11
        """
        mapping = self._mapping()
        cols = expand_select_args(args, self, mapping)
        for name, e in kwargs.items():
            cols[name] = desugar(e, mapping)
        return self._select_impl(cols)

    def _select_impl(self, cols: Dict[str, ColumnExpression]) -> "Table":
        schema_cols = {
            name: ColumnSchema(name=name, dtype=self._infer(e))
            for name, e in cols.items()
        }
        schema = schema_from_columns(schema_cols)
        build = _rowwise_build(self, cols)
        from pathway_tpu_torch.internals.parse_graph import record_op

        # discovery order, not set order: the recorded inputs tuple must
        # be identical between identical runs (byte-identical builds)
        foreign: List[Table] = []
        f_seen = {id(self)}
        for e in cols.values():
            for t in collect_tables_ordered(e):
                if id(t) not in f_seen:
                    f_seen.add(id(t))
                    foreign.append(t)
        return record_op(
            Table(schema=schema, universe=self._universe, build=build),
            "select",
            (self, *foreign),
            {"cols": dict(cols)},
        )

    def filter(self, filter_expression) -> "Table":
        """Subset rows (reference: table.py filter).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... 2
        ... 3
        ... ''')
        >>> pw.debug.compute_and_print(t.filter(pw.this.a > 1), include_id=False)
        a
        3
        2
        """
        expr = desugar(filter_expression, self._mapping())
        foreign = [t for t in collect_tables_ordered(expr) if t is not self]
        if foreign:
            for other in foreign:
                if not solver.query_are_equal(
                    other._universe, self._universe
                ):
                    raise ValueError(
                        "filter() predicates may only reference the "
                        "filtered table or tables sharing its universe"
                    )
            # predicate over same-universe foreign columns: materialize it
            # next to our columns first, then take the single-table path
            tmp = "_pw_filter_pred"
            while tmp in self.column_names():
                tmp += "_"
            helper = self._select_impl(
                {**{c: self[c] for c in self.column_names()}, tmp: expr}
            )
            return helper.filter(helper[tmp]).without(tmp)
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import FilterNode

            node = ctx.node(self_)
            prog = _compile_on(ctx, [self_], expr)
            return FilterNode(ctx.engine, node, prog)

        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=self._schema,
                universe=self._universe.subset(),
                build=build,
            ),
            "filter",
            (self,),
            {"expr": expr},
        )

    def split(self, split_expression) -> tuple["Table", "Table"]:
        """Two disjoint tables: rows satisfying the predicate and the rest
        (reference: table.py split).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... 2
        ... 3
        ... ''')
        >>> pos, neg = t.split(pw.this.a > 1)
        >>> pw.debug.compute_and_print(neg, include_id=False)
        a
        1
        """
        pos = self.filter(split_expression)
        from pathway_tpu_torch.internals.expression import UnaryOpExpression

        neg = self.filter(UnaryOpExpression("~", desugar(split_expression, self._mapping())))
        return pos, neg

    def with_columns(self, *args, **kwargs) -> "Table":
        """All existing columns plus the given ones (reference: table.py
        with_columns).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b
        ... 1 | 2
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     t.with_columns(c=pw.this.a * 10), include_id=False
        ... )
        a | b | c
        1 | 2 | 10
        """
        mapping = self._mapping()
        cols: Dict[str, ColumnExpression] = {
            name: self[name] for name in self.column_names()
        }
        cols.update(expand_select_args(args, self, mapping))
        for name, e in kwargs.items():
            cols[name] = desugar(e, mapping)
        return self._select_impl(cols)

    def without(self, *columns) -> "Table":
        """Drop the given columns (reference: table.py without).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b | c
        ... 1 | 2 | 3
        ... ''')
        >>> pw.debug.compute_and_print(t.without(pw.this.b), include_id=False)
        a | c
        1 | 3
        """
        drop = {c if isinstance(c, str) else c.name for c in columns}
        cols = {
            name: self[name] for name in self.column_names() if name not in drop
        }
        return self._select_impl(cols)

    def rename_columns(self, **kwargs) -> "Table":
        """rename_columns(new_name=pw.this.old) (reference: table.py).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b
        ... 1 | 2
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     t.rename_columns(x=pw.this.a, y=pw.this.b), include_id=False
        ... )
        x | y
        1 | 2
        """
        renames: Dict[str, str] = {}
        for new, old in kwargs.items():
            old_name = old if isinstance(old, str) else old.name
            renames[old_name] = new
        return self._rename_impl(renames)

    def rename_by_dict(self, names_mapping: Mapping) -> "Table":
        """Rename columns by an old→new mapping (reference: table.py
        rename_by_dict).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a | b
        ... 1 | 2
        ... ''')
        >>> pw.debug.compute_and_print(
        ...     t.rename_by_dict({"a": "x"}), include_id=False
        ... )
        x | b
        1 | 2
        """
        renames = {
            (k if isinstance(k, str) else k.name): v
            for k, v in names_mapping.items()
        }
        return self._rename_impl(renames)

    def _rename_impl(self, renames: Dict[str, str]) -> "Table":
        missing = set(renames) - set(self.column_names())
        if missing:
            raise ValueError(f"rename: unknown columns {sorted(missing)}")
        cols: Dict[str, ColumnExpression] = {}
        for name in self.column_names():
            out_name = renames.get(name, name)
            if out_name in cols:
                raise ValueError(
                    f"rename: output column {out_name!r} would collide"
                )
            cols[out_name] = self[name]
        if len(cols) != len(self.column_names()):
            raise ValueError("rename: output column names collide")
        return self._select_impl(cols)

    def rename(self, names_mapping: Mapping | None = None, **kwargs) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def copy(self) -> "Table":
        from pathway_tpu_torch.internals.parse_graph import record_op

        self_ = self
        return record_op(
            Table(
                schema=self._schema,
                universe=self._universe,
                build=lambda ctx: ctx.node(self_),
            ),
            "copy",
            (self,),
        )

    # -- typing -----------------------------------------------------------
    def cast_to_types(self, **kwargs) -> "Table":
        """Cast columns to the given types (reference: table.py
        cast_to_types).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... ''')
        >>> t.cast_to_types(a=float).typehints()["a"]
        <class 'float'>
        """
        cols: Dict[str, ColumnExpression] = {
            name: self[name] for name in self.column_names()
        }
        for name, target in kwargs.items():
            cols[name] = CastExpression(dt.wrap(target), self[name])
        return self._select_impl(cols)

    def update_types(self, **kwargs) -> "Table":
        cols: Dict[str, ColumnExpression] = {
            name: self[name] for name in self.column_names()
        }
        for name, target in kwargs.items():
            cols[name] = DeclareTypeExpression(dt.wrap(target), self[name])
        return self._select_impl(cols)

    # -- keying -----------------------------------------------------------
    def pointer_from(self, *args, optional: bool = False, instance=None):
        return PointerExpression(
            self,
            *(desugar(a, self._mapping()) for a in args),
            optional=optional,
            instance=instance,
        )

    def with_id_from(self, *args, instance=None) -> "Table":
        """Re-key rows by a pointer computed from the given expressions
        (reference: table.py with_id_from).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... k | v
        ... a | 1
        ... b | 2
        ... ''')
        >>> r = t.with_id_from(pw.this.k)
        >>> pw.debug.compute_and_print(r.select(pw.this.v), include_id=False)
        v
        2
        1
        """
        expr = PointerExpression(
            self,
            *(desugar(a, self._mapping()) for a in args),
            instance=(
                desugar(instance, self._mapping()) if instance is not None else None
            ),
        )
        return self._reindex(expr)

    def with_id(self, new_id) -> "Table":
        expr = desugar(new_id, self._mapping())
        return self._reindex(expr)

    def _reindex(self, key_expr: ColumnExpression) -> "Table":
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import ReindexNode

            from pathway_tpu_torch.engine.exchange import exchange_by_key

            node = ctx.node(self_)
            prog = _compile_on(ctx, [self_], key_expr)
            # multi-worker: new keys must land on their owning worker
            return exchange_by_key(ctx.engine, ReindexNode(ctx.engine, node, prog))

        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=self._schema, universe=Universe(), build=build),
            "reindex",
            (self,),
            {"key": key_expr},
        )

    # -- groupby / reduce -------------------------------------------------
    def groupby(
        self,
        *args,
        id=None,
        instance=None,
        sort_by=None,
        _filter_out_results_of_forgetting: bool = False,
        **kwargs,
    ):
        """Group rows; call ``.reduce`` on the result (reference: table.py
        groupby).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... g | v
        ... a | 1
        ... a | 2
        ... b | 3
        ... ''')
        >>> r = t.groupby(pw.this.g).reduce(
        ...     pw.this.g, total=pw.reducers.sum(pw.this.v)
        ... )
        >>> pw.debug.compute_and_print(r, include_id=False)
        g | total
        b | 3
        a | 3
        """
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        mapping = self._mapping()
        grouping = [desugar(a, mapping) for a in args]
        return GroupedTable(
            self,
            grouping,
            instance=desugar(instance, mapping) if instance is not None else None,
            id_expr=desugar(id, mapping) if id is not None else None,
            sort_by=desugar(sort_by, mapping) if sort_by is not None else None,
        )

    def reduce(self, *args, **kwargs) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value=None,
        instance=None,
        acceptor: Callable[[Any, Any], bool] = None,
        name: str | None = None,
        persistent_id: str | None = None,
    ) -> "Table":
        """Keep the latest accepted row per instance (reference: table.py
        deduplicate / Graph::deduplicate).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... v | __time__
        ... 1 | 2
        ... 2 | 4
        ... 1 | 6
        ... ''')
        >>> r = t.deduplicate(
        ...     value=pw.this.v, acceptor=lambda new, old: new != old
        ... )
        >>> pw.debug.compute_and_print(r, include_id=False)
        v
        1
        """
        mapping = self._mapping()
        value_expr = (
            desugar(value, mapping) if value is not None else IdReference(self)
        )
        instance_expr = desugar(instance, mapping) if instance is not None else None
        if acceptor is None:
            acceptor = lambda new, old: True  # noqa: E731
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import DeduplicateNode

            node = ctx.node(self_)
            value_prog = _compile_on(ctx, [self_], value_expr)
            instance_prog = (
                _compile_on(ctx, [self_], instance_expr)
                if instance_expr is not None
                else None
            )
            from pathway_tpu_torch.engine.exchange import exchange_by_key

            return exchange_by_key(
                ctx.engine,
                DeduplicateNode(
                    ctx.engine, node, value_prog, instance_prog, acceptor
                ),
            )

        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=self._schema, universe=Universe(), build=build),
            "deduplicate",
            (self,),
            {"value": value_expr, "instance": instance_expr},
        )

    # -- joins ------------------------------------------------------------
    def join(self, other: "Table", *on, id=None, how=None, **kwargs):
        """Join with another table; ``.select`` on the result picks output
        columns (reference: table.py join).

        >>> import pathway_tpu_torch as pw
        >>> left = pw.debug.table_from_markdown('''
        ... k | a
        ... 1 | x
        ... 2 | y
        ... ''')
        >>> right = pw.debug.table_from_markdown('''
        ... k | b
        ... 2 | u
        ... 3 | w
        ... ''')
        >>> r = left.join(right, left.k == right.k).select(
        ...     left.k, left.a, right.b
        ... )
        >>> pw.debug.compute_and_print(r, include_id=False)
        k | a | b
        2 | y | u
        """
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        if how is None:
            how = JoinMode.INNER
        if isinstance(how, str):
            how = JoinMode[how.upper()]
        return JoinResult(self, other, on, id_expr=id, mode=how)

    def join_inner(self, other: "Table", *on, id=None, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        return JoinResult(self, other, on, id_expr=id, mode=JoinMode.INNER)

    def join_left(self, other: "Table", *on, id=None, **kwargs):
        """Left join: unmatched left rows keep ``None`` right columns
        (reference: table.py join_left).

        >>> import pathway_tpu_torch as pw
        >>> left = pw.debug.table_from_markdown('''
        ... k | a
        ... 1 | x
        ... 2 | y
        ... ''')
        >>> right = pw.debug.table_from_markdown('''
        ... k | b
        ... 2 | u
        ... ''')
        >>> r = left.join_left(right, left.k == right.k).select(
        ...     left.k, right.b
        ... )
        >>> pw.debug.compute_and_print(r, include_id=False)
        k | b
        2 | u
        1 | None
        """
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        return JoinResult(self, other, on, id_expr=id, mode=JoinMode.LEFT)

    def join_right(self, other: "Table", *on, id=None, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        return JoinResult(self, other, on, id_expr=id, mode=JoinMode.RIGHT)

    def join_outer(self, other: "Table", *on, id=None, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        return JoinResult(self, other, on, id_expr=id, mode=JoinMode.OUTER)

    # -- universe algebra -------------------------------------------------
    def intersect(self, *tables: "Table") -> "Table":
        """Rows whose keys appear in every argument (reference: table.py
        intersect).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... 2  | 20
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... id | w
        ... 2  | 200
        ... 3  | 300
        ... ''')
        >>> pw.debug.compute_and_print(t1.intersect(t2), include_id=False)
        v
        20
        """
        out = self
        for other in tables:
            out = _semijoin(out, other, keep_present=True)
        return out

    def difference(self, other: "Table") -> "Table":
        """Rows whose keys do NOT appear in ``other`` (reference: table.py
        difference).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... 2  | 20
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... id | w
        ... 2  | 200
        ... ''')
        >>> pw.debug.compute_and_print(t1.difference(t2), include_id=False)
        v
        10
        """
        return _semijoin(self, other, keep_present=False)

    def restrict(self, other: "Table") -> "Table":
        """Like ``intersect`` but promises ``other``'s universe is a
        subset, so the result keeps it (reference: table.py restrict).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... 2  | 20
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... id | w
        ... 2  | 200
        ... ''')
        >>> pw.debug.compute_and_print(t1.restrict(t2), include_id=False)
        v
        20
        """
        result = _semijoin(self, other, keep_present=True)
        solver.register_equal(result._universe, other._universe)
        return result

    def having(self, *indexers) -> "Table":
        """Rows whose key appears in each indexer expression's values
        (reference: table.py having).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... k | v
        ... a | 1
        ... b | 2
        ... ''')
        >>> keys = pw.debug.table_from_markdown('''
        ... k
        ... a
        ... ''')
        >>> r = t.with_id_from(pw.this.k).having(
        ...     keys.with_id_from(pw.this.k).id
        ... )
        >>> pw.debug.compute_and_print(r.select(pw.this.v), include_id=False)
        v
        1
        """
        out = self
        for indexer in indexers:
            expr = smart_wrap(indexer)
            src_tables = list(collect_tables(expr, set()))
            if len(src_tables) != 1:
                raise ValueError("having() indexer must reference one table")
            src = src_tables[0]
            out = _semijoin(out, src, keep_present=True, filter_expr=expr)
        return out

    def update_rows(self, other: "Table") -> "Table":
        """Rows of `other` override/add to `self` (reference: table.py
        update_rows, update_rows_table in graph.rs).

        >>> import pathway_tpu_torch as pw
        >>> old = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... 2  | 20
        ... ''')
        >>> new = pw.debug.table_from_markdown('''
        ... id | v
        ... 2  | 99
        ... 3  | 30
        ... ''')
        >>> pw.debug.compute_and_print(old.update_rows(new), include_id=False)
        v
        30
        99
        10
        """
        if set(other.column_names()) != set(self.column_names()):
            raise ValueError(
                "update_rows: schemas must have the same columns; "
                f"{self.column_names()} vs {other.column_names()}"
            )
        other_aligned = other.select(
            **{c: other[c] for c in self.column_names()}
        )
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import UpdateRowsNode

            return UpdateRowsNode(
                ctx.engine, ctx.node(self_), ctx.node(other_aligned)
            )

        schema_cols = {}
        for name in self.column_names():
            merged = dt.types_lca(
                self._schema[name].dtype, other._schema[name].dtype
            )
            schema_cols[name] = ColumnSchema(name=name, dtype=merged)
        universe = solver.get_union(self._universe, other._universe)
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=universe,
                build=build,
            ),
            "update_rows",
            (self, other_aligned),
        )

    def update_cells(self, other: "Table") -> "Table":
        """Override a subset of columns for keys present in `other`
        (reference: table.py update_cells, `t << other`).

        >>> import pathway_tpu_torch as pw
        >>> old = pw.debug.table_from_markdown('''
        ... id | a | b
        ... 1  | 1 | x
        ... 2  | 2 | y
        ... ''')
        >>> new = pw.debug.table_from_markdown('''
        ... id | b
        ... 1  | z
        ... ''')
        >>> pw.debug.compute_and_print(old.update_cells(new), include_id=False)
        a | b
        2 | y
        1 | z
        """
        extra = set(other.column_names()) - set(self.column_names())
        if extra:
            raise ValueError(f"update_cells: unknown columns {sorted(extra)}")
        self_ = self
        other_cols = other.column_names()
        self_cols = self.column_names()
        other_idx = {c: i for i, c in enumerate(other_cols)}

        def build(ctx):
            from pathway_tpu_torch.engine.engine import RowwiseNode

            a = ctx.node(self_)
            b = ctx.node(other)

            def batch_fn(keys, rows):
                out = []
                a_rows, b_rows = rows
                for ar, br in zip(a_rows, b_rows):
                    if br is None:
                        out.append(ar)
                    else:
                        out.append(
                            tuple(
                                br[other_idx[c]] if c in other_idx else ar[i]
                                for i, c in enumerate(self_cols)
                            )
                        )
                return out

            return RowwiseNode(ctx.engine, [a, b], batch_fn)

        schema_cols = {}
        for name in self_cols:
            dtype = self._schema[name].dtype
            if name in other_idx:
                dtype = dt.types_lca(dtype, other._schema[name].dtype)
            schema_cols[name] = ColumnSchema(name=name, dtype=dtype)
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=self._universe,
                build=build,
            ),
            "update_cells",
            (self, other),
        )

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def with_universe_of(self, other: "Table") -> "Table":
        from pathway_tpu_torch.internals.parse_graph import record_op

        self_ = self
        result = Table(
            schema=self._schema,
            universe=other._universe,
            build=lambda ctx: ctx.node(self_),
        )
        return record_op(result, "copy", (self,))

    def unsafe_promise_universes_are_equal(self, other: "Table") -> "Table":
        solver.register_equal(self._universe, other._universe)
        return self

    def unsafe_promise_universe_is_subset_of(self, other: "Table") -> "Table":
        solver.register_subset(self._universe, other._universe)
        return self

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        solver.register_disjoint(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        solver.register_subset(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        solver.register_equal(self._universe, other._universe)
        return self

    # -- concat / flatten / sort -----------------------------------------
    def concat(self, *others: "Table") -> "Table":
        """Disjoint union (reference: table.py concat).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... id | v
        ... 2  | 20
        ... ''')
        >>> pw.universes.promise_are_pairwise_disjoint(t1, t2)
        >>> pw.debug.compute_and_print(t1.concat(t2), include_id=False)
        v
        20
        10
        """
        # like the reference, refuse to build unless key-set disjointness
        # is promised/derived — silent key collisions corrupt data
        # (reference: test_common.py test_concat_unsafe_collision)
        all_tables = [self, *others]
        for i, a in enumerate(all_tables):
            for b in all_tables[i + 1:]:
                if not solver.query_are_disjoint(a._universe, b._universe):
                    raise ValueError(
                        "Table.concat() requires universes to be "
                        "disjoint; use concat_reindex, or promise it "
                        "via pw.universes.promise_are_pairwise_disjoint"
                    )
        tables = [self] + [
            o.select(**{c: o[c] for c in self.column_names()}) for o in others
        ]

        def build(ctx):
            from pathway_tpu_torch.engine.operators import ConcatNode

            return ConcatNode(ctx.engine, [ctx.node(t) for t in tables])

        schema_cols = {}
        for name in self.column_names():
            dtype = self._schema[name].dtype
            for o in others:
                dtype = dt.types_lca(dtype, o._schema[name].dtype)
            schema_cols[name] = ColumnSchema(name=name, dtype=dtype)
        universe = solver.get_union(*(t._universe for t in [self, *others]))
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=universe,
                build=build,
            ),
            "concat",
            tuple(tables),
        )

    def concat_reindex(self, *others: "Table") -> "Table":
        """Concat tables whose keys may collide by re-keying each side
        first (reference: table.py concat_reindex).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 10
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... id | v
        ... 1  | 20
        ... ''')
        >>> pw.debug.compute_and_print(t1.concat_reindex(t2), include_id=False)
        v
        20
        10
        """
        reindexed = [
            t.with_id_from(IdReference(t), i)
            for i, t in enumerate([self, *others])
        ]
        # the distinct per-side instance mixed into each key makes the
        # reindexed key sets disjoint by construction
        for i, a in enumerate(reindexed):
            for b in reindexed[i + 1:]:
                solver.register_disjoint(a._universe, b._universe)
        return reindexed[0].concat(*reindexed[1:])

    def flatten(self, to_flatten: ColumnReference, *, origin_id: str | None = None) -> "Table":
        """One row per element of a sequence column (reference: table.py
        flatten, flatten_table).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_rows(
        ...     pw.schema_from_types(k=str, vs=list),
        ...     [("a", [1, 2]), ("b", [3])],
        ... )
        >>> r = t.flatten(pw.this.vs).select(pw.this.k, pw.this.vs)
        >>> pw.debug.compute_and_print(r, include_id=False)
        k | vs
        a | 2
        a | 1
        b | 3
        """
        ref = desugar(to_flatten, self._mapping())
        if not isinstance(ref, ColumnReference):
            raise TypeError("flatten expects a column reference")
        flat_name = ref.name
        flat_idx = self.column_names().index(flat_name)
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.exchange import exchange_by_key
            from pathway_tpu_torch.engine.vector_flatten import make_flatten_node

            # multi-worker: flattened keys hash (row, pos) — re-own them
            return exchange_by_key(
                ctx.engine, make_flatten_node(ctx.engine, ctx.node(self_), flat_idx)
            )

        schema_cols = {}
        for name in self.column_names():
            dtype = self._schema[name].dtype
            if name == flat_name:
                core = dt.unoptionalize(dtype)
                if isinstance(core, dt.ListDType):
                    dtype = core.arg
                elif isinstance(core, dt.TupleDType):
                    out = core.args[0] if core.args else dt.ANY
                    for a in core.args[1:]:
                        out = dt.types_lca(out, a)
                    dtype = out
                elif core is dt.STR:
                    dtype = dt.STR
                elif core is dt.JSON:
                    # a Json array flattens to Json elements (reference:
                    # test_json.py test_json_flatten)
                    dtype = dt.JSON
                elif isinstance(core, dt.ArrayDType) or core is dt.ANY:
                    dtype = dt.ANY
                else:
                    # scalars are not flattenable — refuse at build time
                    # (reference: test_common.py test_flatten_incorrect_type)
                    raise TypeError(
                        f"flatten: column {flat_name!r} of type {core} "
                        "is not a sequence"
                    )
            schema_cols[name] = ColumnSchema(name=name, dtype=dtype)
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=Universe(),
                build=build,
            ),
            "flatten",
            (self,),
            {"expr": ref},
        )

    def sort(self, key, instance=None) -> "Table":
        """prev/next pointers in key order (reference: table.py sort,
        operators/prev_next.rs).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... v
        ... 30
        ... 10
        ... 20
        ... ''')
        >>> s = t.sort(pw.this.v)
        >>> r = t.select(pw.this.v, has_next=s.next.is_not_none())
        >>> pw.debug.compute_and_print(r, include_id=False)
        v  | has_next
        20 | True
        30 | False
        10 | True
        """
        mapping = self._mapping()
        key_expr = desugar(key, mapping)
        instance_expr = desugar(instance, mapping) if instance is not None else None
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import SortNode

            node = ctx.node(self_)
            key_prog = _compile_on(ctx, [self_], key_expr)
            inst_prog = (
                _compile_on(ctx, [self_], instance_expr)
                if instance_expr is not None
                else None
            )
            from pathway_tpu_torch.engine.exchange import exchange_by_key

            # multi-worker: output rows keep their original keys — re-own
            return exchange_by_key(
                ctx.engine, SortNode(ctx.engine, node, key_prog, inst_prog)
            )

        schema = schema_from_columns(
            {
                "prev": ColumnSchema(name="prev", dtype=dt.Optionalize(dt.POINTER)),
                "next": ColumnSchema(name="next", dtype=dt.Optionalize(dt.POINTER)),
            }
        )
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=schema, universe=self._universe, build=build),
            "sort",
            (self,),
            {"key": key_expr, "instance": instance_expr},
        )

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column,
        value_column,
        upper_column,
    ) -> "Table":
        """Attach `apx_value` interpolated between lower/upper per the
        threshold's progress (reference: table.py _gradual_broadcast:637,
        operators/gradual_broadcast.rs)."""
        apx = self.__gradual_broadcast(
            threshold_table, lower_column, value_column, upper_column
        )
        cols = {name: self[name] for name in self.column_names()}
        cols["apx_value"] = apx.apx_value
        return self._select_impl(cols)

    def __gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column,
        value_column,
        upper_column,
    ) -> "Table":
        self_ = self
        lower_expr = smart_wrap(lower_column)
        value_expr = smart_wrap(value_column)
        upper_expr = smart_wrap(upper_column)

        def build(ctx):
            from pathway_tpu_torch.engine.operators import GradualBroadcastNode

            return GradualBroadcastNode(
                ctx.engine,
                ctx.node(self_),
                ctx.node(threshold_table),
                _compile_on(ctx, [threshold_table], lower_expr),
                _compile_on(ctx, [threshold_table], value_expr),
                _compile_on(ctx, [threshold_table], upper_expr),
            )

        schema = schema_from_columns(
            {
                "apx_value": ColumnSchema(
                    name="apx_value", dtype=dt.Optionalize(dt.ANY)
                )
            }
        )
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=schema, universe=self._universe, build=build),
            "gradual_broadcast",
            (self, threshold_table),
        )

    # -- stream shaping ----------------------------------------------------
    def _clocked(self, node_cls, time_column, threshold, **node_kwargs) -> "Table":
        """Wrap with a clocked temporal node whose per-row threshold is
        ``time_column + threshold`` (reference: time_column.rs — row acts
        when max(time) so far reaches its event time plus the threshold)."""
        mapping = self._mapping()
        time_expr = desugar(time_column, mapping)
        threshold_expr = BinaryOpExpression("+", time_expr, threshold)
        self_ = self

        def build(ctx):
            node = ctx.node(self_)
            return node_cls(
                ctx.engine,
                node,
                _compile_on(ctx, [self_], threshold_expr),
                _compile_on(ctx, [self_], time_expr),
                **node_kwargs,
            )

        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=self._schema,
                universe=self._universe.subset(),
                build=build,
            ),
            "clocked",
            (self,),
            {"time": time_expr},
            node_cls=node_cls.__name__,
        )

    def forget(
        self,
        time_column,
        threshold,
        mark_forgetting_records: bool = False,
    ) -> "Table":
        """Retract entries once ``time_column <= max(time_column) - threshold``
        (reference: internals/table.py forget:670, time_column.rs forget:536).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... t | v
        ... 1 | 1
        ... 9 | 2
        ... ''')
        >>> res = t.forget(pw.this.t, 3)
        >>> pw.debug.compute_and_print(res, include_id=False)
        t | v
        9 | 2
        """
        from pathway_tpu_torch.engine.temporal_nodes import ForgetNode

        return self._clocked(
            ForgetNode,
            time_column,
            threshold,
            mark_forgetting_records=mark_forgetting_records,
        )

    def ignore_late(self, time_column, threshold) -> "Table":
        """Drop entries already satisfying ``time_column <= max(time_column)
        - threshold`` on arrival; stores nothing but the clock (reference:
        internals/table.py ignore_late:777, time_column.rs ignore_late:673)."""
        from pathway_tpu_torch.engine.temporal_nodes import FreezeNode

        return self._clocked(FreezeNode, time_column, threshold)

    def buffer(self, time_column, threshold) -> "Table":
        """Hold entries until ``time_column <= max(time_column) - threshold``,
        then release (reference: internals/table.py buffer:846,
        time_column.rs postpone_core:302)."""
        from pathway_tpu_torch.engine.temporal_nodes import BufferNode

        return self._clocked(BufferNode, time_column, threshold)

    def to_stream(self, upsert_column_name: str = "is_upsert") -> "Table":
        """Convert a changing table into an append-only stream of events with
        a boolean action column (reference: internals/table.py
        to_stream:2782)."""
        if upsert_column_name in self.column_names():
            raise ValueError(
                f"to_stream: column {upsert_column_name!r} already exists"
            )
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import ToStreamNode

            # events keep their original row keys — already worker-owned
            return ToStreamNode(ctx.engine, ctx.node(self_))

        schema_cols = {
            name: ColumnSchema(
                name=name, dtype=self._schema[name].dtype, append_only=True
            )
            for name in self.column_names()
        }
        schema_cols[upsert_column_name] = ColumnSchema(
            name=upsert_column_name, dtype=dt.BOOL, append_only=True
        )
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=Universe(multiset=True),
                build=build,
            ),
            "to_stream",
            (self,),
        )

    def stream_to_table(self, is_upsert) -> "Table":
        """Replay a stream of upsert/delete events into the current table
        state (reference: internals/table.py stream_to_table:2836)."""
        expr = desugar(is_upsert, self._mapping())
        if self._infer(expr) not in (dt.BOOL, dt.ANY):
            raise TypeError(
                "stream_to_table: 'is_upsert' must evaluate to bool"
            )
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import StreamToTableNode

            return StreamToTableNode(
                ctx.engine,
                ctx.node(self_),
                _compile_on(ctx, [self_], expr),
            )

        # replayed state is a proper keyed table again, never a multiset
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=self._schema, universe=Universe(), build=build),
            "stream_to_table",
            (self,),
            {"expr": expr},
        )

    def from_streams(self, deletion_stream: "Table") -> "Table":
        """Merge an updates stream (``self``) and a deletion stream into
        table state (reference: internals/table.py from_streams:2891)."""
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import MergeStreamsNode

            return MergeStreamsNode(
                ctx.engine, ctx.node(self_), ctx.node(deletion_stream)
            )

        # replayed state is a proper keyed table again, never a multiset
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(schema=self._schema, universe=Universe(), build=build),
            "merge_streams",
            (self, deletion_stream),
        )

    def remove_errors(self) -> "Table":
        """Filter out rows containing Error values (reference:
        internals/table.py remove_errors:2678)."""
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import FilterNode
            from pathway_tpu_torch.engine.value import Error as EngineErrorValue

            def pred(keys, rows):
                return [
                    not any(isinstance(v, EngineErrorValue) for v in row)
                    for row in rows[0]
                ]

            return FilterNode(ctx.engine, ctx.node(self_), pred)

        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=self._schema,
                universe=self._universe.subset(),
                build=build,
            ),
            "remove_errors",
            (self,),
        )

    def await_futures(self) -> "Table":
        """Keep only rows whose fully-async UDF results arrived; strips the
        ``Future`` wrapper from column dtypes (reference: internals/table.py
        await_futures:2704)."""
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import FilterNode
            from pathway_tpu_torch.engine.value import Pending

            def pred(keys, rows):
                return [
                    not any(v is Pending for v in row) for row in rows[0]
                ]

            return FilterNode(ctx.engine, ctx.node(self_), pred)

        schema_cols = {}
        for name in self.column_names():
            dtype = self._schema[name].dtype
            if isinstance(dtype, dt.FutureDType):
                dtype = dtype.wrapped
            schema_cols[name] = ColumnSchema(name=name, dtype=dtype)
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=self._universe.subset(),
                build=build,
            ),
            "await_futures",
            (self,),
        )

    @property
    def is_append_only(self) -> bool:
        """True when every column is known append-only (reference:
        internals/table.py is_append_only:195)."""
        cols = self._schema.columns()
        return bool(cols) and all(
            c.append_only for c in cols.values()
        )

    def assert_append_only(self) -> "Table":
        """Declare the table append-only; verified at runtime (reference:
        internals/table.py assert_append_only:2941)."""
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.operators import AssertAppendOnlyNode

            return AssertAppendOnlyNode(ctx.engine, [ctx.node(self_)])

        schema_cols = {
            name: ColumnSchema(
                name=name, dtype=self._schema[name].dtype, append_only=True
            )
            for name in self.column_names()
        }
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=self._universe,
                build=build,
            ),
            "assert_append_only",
            (self,),
        )

    def update_id_type(self, id_type, *, id_append_only: bool | None = None) -> "Table":
        """Declare the id column's pointer type (reference: internals/table.py
        update_id_type:2180). Our untyped-pointer engine keeps ids as raw
        128-bit keys, so this is a schema-level declaration only."""
        wrapped = dt.wrap(id_type)
        core = dt.unoptionalize(wrapped)
        if not isinstance(core, type(dt.POINTER)):
            raise TypeError("update_id_type: id_type must be a Pointer type")
        return self.copy()

    def with_prefix(self, prefix: str) -> "Table":
        """Rename all columns with a prefix (reference: internals/table.py
        with_prefix:2027).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... age | owner
        ... 10  | Alice
        ... ''')
        >>> t.with_prefix("u_").column_names()
        ['u_age', 'u_owner']
        """
        return self.rename_by_dict(
            {name: prefix + name for name in self.column_names()}
        )

    def with_suffix(self, suffix: str) -> "Table":
        """Rename all columns with a suffix (reference: internals/table.py
        with_suffix:2049).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... age | owner
        ... 10  | Alice
        ... ''')
        >>> t.with_suffix("_cur").column_names()
        ['age_cur', 'owner_cur']
        """
        return self.rename_by_dict(
            {name: name + suffix for name in self.column_names()}
        )

    def eval_type(self, expression) -> dt.DType:
        """Inferred dtype of an expression over this table (reference:
        internals/table.py eval_type:3005).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... a
        ... 1
        ... ''')
        >>> t.eval_type(pw.this.a * 2)
        int
        """
        return self._infer(desugar(expression, self._mapping()))

    def debug(self, name: str) -> "Table":
        """Print every change flowing through this table at runtime,
        prefixed with ``name`` (reference: internals/table.py debug:2533,
        DebugOperator)."""
        from pathway_tpu_torch.io._subscribe import subscribe

        names = self.column_names()

        def on_change(key, row, time, is_addition):
            sign = "+" if is_addition else "-"
            cols = ", ".join(f"{c}={row[c]!r}" for c in names)
            print(f"[debug {name}] {sign} @{time} {key!r}: {cols}")

        subscribe(self, on_change=on_change)
        return self

    def to(self, sink) -> None:
        """Write this table to a data sink object (reference:
        internals/table.py to:2540, table_io.table_to_datasink). A sink is
        anything exposing ``write(table)`` — e.g. a thin wrapper binding
        one of the module-level ``pw.io.*.write`` functions to its
        destination arguments."""
        write = getattr(sink, "write", None)
        if write is None:
            raise TypeError(
                f"{type(sink).__name__} is not a data sink "
                "(expected a .write(table) method)"
            )
        write(self)

    # -- lookup -----------------------------------------------------------
    def ix(self, expression, *, optional: bool = False, context=None, allow_misses: bool = False) -> "Table":
        """`target.ix(keys)` — row lookup by pointer (reference: table.py ix,
        ix_table in graph.rs).

        >>> import pathway_tpu_torch as pw
        >>> people = pw.debug.table_from_markdown('''
        ... name | boss
        ... Abe  | Abe
        ... Bea  | Abe
        ... ''').with_id_from(pw.this.name)
        >>> refs = people.select(b=people.pointer_from(pw.this.boss))
        >>> r = refs.select(boss_name=people.ix(refs.b).name)
        >>> pw.debug.compute_and_print(r, include_id=False)
        boss_name
        Abe
        Abe
        """
        expr = smart_wrap(expression)
        if context is not None:
            source = context
        else:
            src_tables = [
                t for t in collect_tables(expr, set()) if t is not self
            ]
            if not src_tables:
                src_tables = list(collect_tables(expr, set()))
            if len(src_tables) != 1:
                raise ValueError(
                    "ix() key expression must reference exactly one table"
                )
            source = src_tables[0]
        optional = optional or allow_misses
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.exchange import exchange_by_key
            from pathway_tpu_torch.engine.operators import IxNode

            src_node = ctx.node(source)
            target_node = ctx.node(self_)
            key_prog = _compile_on(ctx, [source], expr)
            # multi-worker: lookups compute on the target's owner; results
            # keyed by the source row go home afterwards
            return exchange_by_key(ctx.engine, IxNode(
                ctx.engine,
                src_node,
                target_node,
                key_prog,
                target_width=len(self_.column_names()),
                optional=optional,
            ))

        schema_cols = {}
        for name in self.column_names():
            dtype = self._schema[name].dtype
            if optional:
                dtype = dt.Optionalize(dtype)
            schema_cols[name] = ColumnSchema(name=name, dtype=dtype)
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=source._universe,
                build=build,
            ),
            "ix",
            (self, source),
            {"key": expr},
        )

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None):
        exprs = [smart_wrap(a) for a in args]
        ptr = PointerExpression(self, *exprs, optional=optional, instance=instance)
        if context is None:
            arg_tables: set = set()
            for e in exprs:
                collect_tables(e, arg_tables)
            if instance is not None:
                collect_tables(smart_wrap(instance), arg_tables)
            if not arg_tables:
                # constant-only key (incl. the zero-arg broadcast form):
                # the lookup's row set is the ENCLOSING select/reduce
                # table, only known at desugar time (reference: table.py
                # ix context=thisclass.this delayed op)
                from pathway_tpu_torch.internals.expression import _DelayedIxTable

                return _DelayedIxTable(self, ptr, optional)
        return self.ix(ptr, optional=optional, context=context)

    # -- misc -------------------------------------------------------------
    @staticmethod
    def empty(**kwargs) -> "Table":
        schema = schema_from_types(**kwargs)

        def build(ctx):
            from pathway_tpu_torch.engine.engine import StaticSource

            return StaticSource(ctx.engine, {})

        return Table(schema=schema, universe=Universe(), build=build)

    @staticmethod
    def from_columns(*args, **kwargs) -> "Table":
        """Build a table from columns sharing one universe (reference:
        internals/table.py from_columns:271).

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... age | pet
        ... 10  | dog
        ... ''')
        >>> t2 = pw.Table.from_columns(t1.pet, qux=t1.age)
        >>> t2.column_names()
        ['pet', 'qux']
        """
        refs = [*args, *kwargs.values()]
        if not refs:
            raise ValueError(
                "Table.from_columns() cannot have empty arguments list"
            )
        names = [r.name for r in args] + list(kwargs.keys())
        if len(set(names)) != len(names):
            raise ValueError(
                "Table.from_columns() got duplicate output column names"
            )
        tables = {id(r._table): r._table for r in refs}
        base = refs[0]._table
        for other in tables.values():
            if other is not base and not solver.query_are_equal(
                base._universe, other._universe
            ):
                raise ValueError(
                    "Universes of all arguments of Table.from_columns() "
                    "have to be equal. Consider using "
                    "Table.unsafe_promise_universes_are_equal() to assert it."
                )
        return base.select(*args, **kwargs)

    def _materialize_build(self, record_stream: bool = False):
        """Build closure attaching a CaptureNode (used by runner/debug)."""
        self_ = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import CaptureNode

            return CaptureNode(
                ctx.engine,
                ctx.node(self_),
                record_stream=record_stream,
                multiset=self_._event_stream,
            )

        return build


class ColumnNamespace:
    """`t.C.colname` (reference: internals/column_namespace.py)."""

    def __init__(self, table: Table):
        object.__setattr__(self, "_table", table)

    def __getattr__(self, name):
        return self._table[name]

    def __getitem__(self, name):
        return self._table[name]


class TableSlice:
    """`t.slice[...]` (reference: internals/table_slice.py:16)."""

    def __init__(self, table: Table, columns: List[str]):
        self._table = table
        self._columns = columns

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            names = [a if isinstance(a, str) else a.name for a in arg]
            return TableSlice(self._table, names)
        name = arg if isinstance(arg, str) else arg.name
        return self._table[name]

    def __iter__(self):
        return iter(self._table[c] for c in self._columns)

    def without(self, *cols):
        drop = {c if isinstance(c, str) else c.name for c in cols}
        return TableSlice(
            self._table, [c for c in self._columns if c not in drop]
        )

    def rename(self, mapping):
        raise NotImplementedError

    def keys(self):
        return list(self._columns)

    def _table_slice_columns(self):
        return [(c, self._table[c]) for c in self._columns]


# ---------------------------------------------------------------------------
# build helpers
# ---------------------------------------------------------------------------


def make_resolver(tables: List[Table]):
    """Map ColumnReference -> (input idx, column idx) over an ordered table
    list (the reference's column-path computation, graph_runner/path_evaluator)."""
    locations: Dict[tuple, tuple] = {}
    for ti, t in enumerate(tables):
        for ci, name in enumerate(t.column_names()):
            locations[(id(t), name)] = (ti, ci)

    def resolve(ref: ColumnReference):
        if isinstance(ref, IdReference):
            return ("id",)
        return locations.get((id(ref._table), ref.name))

    return resolve


def _compile_on(ctx, tables: List[Table], expr: ColumnExpression):
    """Compile an expression against an ordered input-table list."""
    from pathway_tpu_torch.engine.expression_eval import EvalContext, compile_batch

    ectx = EvalContext(make_resolver(tables))
    ectx.error_logger = ctx.engine.log_error
    return compile_batch(expr, ectx)


def _ordered_tables(primary: Table, exprs: Iterable[ColumnExpression]) -> List[Table]:
    tables = [primary]
    seen = {id(primary)}
    for e in exprs:
        for t in collect_tables_ordered(e):
            if id(t) not in seen:
                tables.append(t)
                seen.add(id(t))
    return tables


def _rowwise_build(primary: Table, cols: Dict[str, ColumnExpression]):
    tables = _ordered_tables(primary, cols.values())

    def build(ctx):
        from pathway_tpu_torch.engine.engine import RowwiseNode
        from pathway_tpu_torch.engine.expression_eval import EvalContext, compile_batch

        nodes = [ctx.node(t) for t in tables]
        ectx = EvalContext(make_resolver(tables))
        ectx.error_logger = ctx.engine.log_error
        progs = [compile_batch(e, ectx) for e in cols.values()]
        n_cols = len(progs)

        def batch_fn(keys, rows):
            if n_cols == 0:
                return [() for _ in keys]
            columns = [p(keys, rows) for p in progs]
            return list(zip(*columns))

        deterministic = all(_expr_deterministic(e) for e in cols.values())
        # pure column projection off the primary input compiles to one
        # C-speed itemgetter pass instead of per-column programs + rezip
        projection = None
        if n_cols and len(nodes) == 1:
            idxs = []
            for e in cols.values():
                if type(e) is ColumnReference and not isinstance(e, IdReference):
                    loc = ectx.resolve(e)
                    if loc is not None and loc != ("id",) and loc[0] == 0:
                        idxs.append(loc[1])
                        continue
                idxs = None
                break
            if idxs is not None:
                projection = tuple(idxs)
        return RowwiseNode(
            ctx.engine,
            nodes,
            batch_fn,
            deterministic=deterministic,
            projection=projection,
        )

    return build


def _expr_deterministic(expr: ColumnExpression) -> bool:
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ApplyExpression) and not node._deterministic:
            return False
        stack.extend(node._deps())
        for attr in ("_left", "_right", "_arg", "_expr", "_if", "_then", "_else"):
            child = getattr(node, attr, None)
            if isinstance(child, ColumnExpression):
                stack.append(child)
    return True


def _fused_map_stage(progs, n_cols: int, projection):
    """One select stage of a fused chain: values -> values, mirroring
    RowwiseNode's batch/projection fast paths (same programs, same
    itemgetter shortcut) so fused and classic outputs cannot differ."""
    if projection is not None:
        if len(projection) == 1:
            idx = projection[0]
            return lambda keys, values, _i=idx: [(v[_i],) for v in values]
        import operator as _op

        getter = _op.itemgetter(*projection)
        return lambda keys, values, _g=getter: [_g(v) for v in values]

    def run(keys, values):
        if n_cols == 0:
            return [()] * len(keys)
        columns = [p(keys, (values,)) for p in progs]
        return list(zip(*columns))

    return run


def build_fused_chain(ctx, chain):
    """Compile a planned FusionChain (analysis/fusion.py) into ONE
    FusedChainNode.  Each stage's expressions compile against that
    stage's own input table — exactly the resolver the classic per-op
    build would have used — so the only difference from the classic path
    is the number of engine nodes, never the computed rows."""
    from pathway_tpu_torch.engine.expression_eval import EvalContext, compile_batch
    from pathway_tpu_torch.engine.operators import FusedChainNode

    head = chain.tables[0]
    prev = head._op.inputs[0]
    input_node = ctx.node(prev)
    stages = []
    for t in chain.tables:
        op = t._op
        if op.kind == "filter":
            stages.append(("filter", _compile_on(ctx, [prev], op.exprs["expr"])))
        else:
            cols = op.exprs["cols"]
            ectx = EvalContext(make_resolver([prev]))
            ectx.error_logger = ctx.engine.log_error
            progs = [compile_batch(e, ectx) for e in cols.values()]
            projection = None
            if progs:
                idxs = []
                for e in cols.values():
                    if type(e) is ColumnReference and not isinstance(
                        e, IdReference
                    ):
                        loc = ectx.resolve(e)
                        if loc is not None and loc != ("id",) and loc[0] == 0:
                            idxs.append(loc[1])
                            continue
                    idxs = None
                    break
                if idxs is not None:
                    projection = tuple(idxs)
            stages.append(
                ("map", _fused_map_stage(progs, len(progs), projection))
            )
        prev = t
    node = FusedChainNode(
        ctx.engine,
        input_node,
        stages,
        op_ids=chain.op_ids,
        kinds=chain.kinds,
    )
    fused = getattr(ctx.engine, "fused_chains", None)
    if fused is not None:
        fused.append(node)
    return node


def _semijoin(
    table: Table,
    other: Table,
    *,
    keep_present: bool,
    filter_expr: ColumnExpression | None = None,
) -> Table:
    def build(ctx):
        from pathway_tpu_torch.engine.operators import SemijoinNode

        filter_key_fn = None
        if filter_expr is not None:
            filter_key_fn = _compile_on(ctx, [other], filter_expr)
        return SemijoinNode(
            ctx.engine,
            ctx.node(table),
            ctx.node(other),
            keep_present=keep_present,
            filter_key_fn=filter_key_fn,
        )

    from pathway_tpu_torch.internals.parse_graph import record_op

    return record_op(
        Table(
            schema=table._schema, universe=table._universe.subset(), build=build
        ),
        "semijoin",
        (table, other),
    )
