"""Join desugaring (reference: python/pathway/internals/joins.py,
src/engine/dataflow.rs join_tables:2691).

`pw.left` / `pw.right` disambiguate columns present on both sides:

>>> import pathway_tpu_torch as pw
>>> orders = pw.debug.table_from_markdown('''
... item | qty
... pen  | 2
... ''')
>>> prices = pw.debug.table_from_markdown('''
... item | price
... pen  | 3
... ''')
>>> r = orders.join(prices, pw.left.item == pw.right.item).select(
...     pw.left.item, cost=pw.left.qty * pw.right.price
... )
>>> pw.debug.compute_and_print(r, include_id=False)
item | cost
pen  | 6
"""

from __future__ import annotations

import copy
import enum
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar, expand_select_args
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    IdReference,
    collect_tables,
    smart_wrap,
)
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.internals.universe import Universe


def split_equality_condition(cond, left, right):
    """A desugared join condition must be `left_expr == right_expr`;
    returns (left_side, right_side) regardless of written order. Shared
    by JoinResult and the temporal joins so validation cannot drift."""
    if not (isinstance(cond, BinaryOpExpression) and cond._op == "=="):
        raise TypeError(
            "join conditions must be equalities like t1.a == t2.b"
        )
    a, b = cond._left, cond._right
    a_tables = collect_tables(a, set())
    b_tables = collect_tables(b, set())
    if a_tables <= {left} and b_tables <= {right}:
        return a, b
    if a_tables <= {right} and b_tables <= {left}:
        return b, a
    raise ValueError(
        "each join condition side must reference only one table"
    )


class JoinMode(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class JoinResult:
    """Intermediate of t.join(other, ...) supporting select/filter/reduce
    (reference: joins.py JoinResult)."""

    def __init__(
        self,
        left,
        right,
        on: tuple,
        *,
        id_expr=None,
        mode: JoinMode = JoinMode.INNER,
        remap=None,
    ):
        self._left = left
        self._right = right
        self._mode = mode
        self._filters: List[ColumnExpression] = []
        # chained joins: references to tables absorbed by an earlier join
        # in the chain resolve through this map (original table, column)
        # -> column of the materialized left side
        self._remap: Dict = dict(remap or {})
        mapping = {
            thisclass.left: left,
            thisclass.right: right,
            thisclass.this: left,
        }
        self._on_left: List[ColumnExpression] = []
        self._on_right: List[ColumnExpression] = []
        for cond in on:
            cond = self._apply_remap(desugar(cond, mapping))
            a, b = split_equality_condition(cond, left, right)
            self._on_left.append(a)
            self._on_right.append(b)
        # id= parameter: result rows keyed by one side's id
        self._id_mode = "both"
        if id_expr is not None:
            id_expr = desugar(id_expr, mapping)
            if isinstance(id_expr, IdReference):
                if id_expr._table is left:
                    self._id_mode = "left"
                elif id_expr._table is right:
                    self._id_mode = "right"
                else:
                    raise ValueError("join id= must be pw.left.id or pw.right.id")
            else:
                raise ValueError("join id= must be pw.left.id or pw.right.id")

    # -- chained joins ----------------------------------------------------
    def _apply_remap(self, expr: ColumnExpression) -> ColumnExpression:
        if not self._remap:
            return expr
        from pathway_tpu_torch.internals.expression import map_refs

        def sub(node):
            if isinstance(node, IdReference):
                return node
            hit = self._remap.get((id(node._table), node._name))
            return hit if hit is not None else node

        return map_refs(expr, sub)

    def _materialize_all(self):
        """Flatten this join into a Table holding every column of both
        sides under unique names; returns (table, remap) where remap sends
        (original table, column) to the flattened column reference."""
        cols: Dict[str, ColumnExpression] = {}
        pending = []
        for tbl in (self._left, self._right):
            for n in tbl.column_names():
                pending.append((tbl, n))
        names: Dict[Tuple[int, str], str] = {}
        for tbl, n in pending:
            out_name = n
            while out_name in cols:
                out_name = "_pw_j_" + out_name
            cols[out_name] = tbl[n]
            names[(id(tbl), n)] = out_name
        tab = self.select(**cols)
        remap = {key: tab[name] for key, name in names.items()}
        # compose with the chain so far: tables absorbed two joins ago
        # still resolve
        for key, ref in self._remap.items():
            inner = names.get((id(ref._table), ref._name))
            if inner is not None:
                remap[key] = tab[inner]
        return tab, remap

    def join(self, other, *on, id=None, how=None, **kwargs):
        """Chain another join onto this one (reference: test_common.py
        test_join_chain_1/2 — conditions and later selects may keep
        referencing the original tables)."""
        if how is None:
            how = JoinMode.INNER
        if isinstance(how, str):
            how = JoinMode[how.upper()]
        tab, remap = self._materialize_all()
        return JoinResult(
            tab, other, on, id_expr=id, mode=how, remap=remap
        )

    def join_inner(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how=JoinMode.INNER)

    def join_left(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how=JoinMode.LEFT)

    def join_right(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how=JoinMode.RIGHT)

    def join_outer(self, other, *on, id=None, **kwargs):
        return self.join(other, *on, id=id, how=JoinMode.OUTER)

    # -- combined-storage helpers ----------------------------------------
    def _resolve_this(self, name: str) -> ColumnReference:
        if name in self._left.column_names():
            if name in self._right.column_names():
                raise ValueError(
                    f"column {name!r} exists on both join sides; "
                    "use pw.left/pw.right"
                )
            return self._left[name]
        if name in self._right.column_names():
            return self._right[name]
        raise KeyError(f"no column {name!r} on either join side")

    def _mapping(self) -> dict:
        return {
            thisclass.left: self._left,
            thisclass.right: self._right,
            thisclass.this: _JoinThisProxy(self),
        }

    # join-value dtypes the columnar node may key its code dict on: scalar,
    # hashable, and `_freeze`-stable (freezing is the identity for these, so
    # skipping it in the vector node cannot change match semantics). Mirrors
    # _CACHEABLE_GROUP_DTYPES in groupbys.py.
    _HASHABLE_JOIN_DTYPES = (
        dt.STR, dt.INT, dt.FLOAT, dt.BOOL, dt.BYTES, dt.POINTER,
        dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC, dt.DURATION,
    )

    def _join_keys_hashable(self) -> bool:
        """Static gate for the columnar join path: every condition
        expression must have a hashable scalar dtype (Optionalized
        allowed — None keys hash and compare exactly like the classic
        buckets). Json/arrays/tuples/ANY fall back to the classic node."""
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        def resolve(ref: ColumnReference) -> dt.DType:
            if isinstance(ref, IdReference):
                return dt.POINTER
            return ref._table._schema[ref.name].dtype

        for expr in self._on_left + self._on_right:
            try:
                d = infer_dtype(expr, resolve)
            except Exception:  # noqa: BLE001 — unknown dtype: stay classic
                return False
            if isinstance(d, dt.Optionalized):
                d = dt.unoptionalize(d)
            if d not in self._HASHABLE_JOIN_DTYPES:
                return False
        return True

    def _columnar_reasons(self) -> list:
        """Reason strings for every way this join fails the columnar
        gate — the analyzer-facing twin of `_join_keys_hashable`, kept
        next to it so the two can't drift.  Empty list == eligible."""
        from pathway_tpu_torch.engine import vector_join
        from pathway_tpu_torch.internals.expression_printer import print_expression
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        reasons = []
        if not vector_join.vector_join_supported():
            reasons.append("vector join disabled by configuration")

        def resolve(ref: ColumnReference) -> dt.DType:
            if isinstance(ref, IdReference):
                return dt.POINTER
            return ref._table._schema[ref.name].dtype

        for expr in self._on_left + self._on_right:
            try:
                d = infer_dtype(expr, resolve)
            except Exception:  # noqa: BLE001 — mirror the gate's fallback
                reasons.append(
                    f"join key {print_expression(expr)} has "
                    "uninferable dtype"
                )
                continue
            base = d
            if isinstance(base, dt.Optionalized):
                base = dt.unoptionalize(base)
            if base not in self._HASHABLE_JOIN_DTYPES:
                reasons.append(
                    f"join key {print_expression(expr)} has unhashable "
                    f"dtype {d}"
                )
        return reasons

    def _join_node(self, ctx):
        """Build (or reuse) the engine join node for this join; picks the
        columnar VectorJoinNode when the join-key dtypes statically allow
        it (mirroring how groupbys.py picks VectorReduceNode)."""
        from pathway_tpu_torch.engine.operators import JoinNode
        from pathway_tpu_torch.engine import vector_join
        from pathway_tpu_torch.internals.table import _compile_on

        cached = ctx.join_nodes.get(id(self))
        if cached is not None:
            return cached
        from pathway_tpu_torch.internals.expression import MakeTupleExpression

        left_node = ctx.node(self._left)
        right_node = ctx.node(self._right)
        left_prog = _compile_on(
            ctx, [self._left], MakeTupleExpression(*self._on_left)
        )
        right_prog = _compile_on(
            ctx, [self._right], MakeTupleExpression(*self._on_right)
        )
        from pathway_tpu_torch.engine.exchange import exchange_by_key

        node_cls = JoinNode
        if vector_join.vector_join_supported() and self._join_keys_hashable():
            node_cls = vector_join.VectorJoinNode
        node = node_cls(
            ctx.engine,
            left_node,
            right_node,
            left_prog,
            right_prog,
            left_width=len(self._left.column_names()),
            right_width=len(self._right.column_names()),
            left_outer=self._mode in (JoinMode.LEFT, JoinMode.OUTER),
            right_outer=self._mode in (JoinMode.RIGHT, JoinMode.OUTER),
            id_mode=self._id_mode,
        )
        # multi-worker: joined rows (keyed by pair/side ids) go to their
        # owning worker so downstream keyed operators compose
        node = exchange_by_key(ctx.engine, node)
        ctx.join_nodes[id(self)] = node
        return node

    def _combined_resolver(self):
        left, right = self._left, self._right
        nl = len(left.column_names())
        left_idx = {n: i for i, n in enumerate(left.column_names())}
        right_idx = {n: i for i, n in enumerate(right.column_names())}

        def resolve(ref: ColumnReference):
            if isinstance(ref, IdReference):
                if ref._table is left:
                    return (0, 0)
                if ref._table is right:
                    return (0, 1)
                return ("id",)
            if ref._table is left:
                return (0, 2 + left_idx[ref.name])
            if ref._table is right:
                return (0, 2 + nl + right_idx[ref.name])
            return None

        return resolve

    def _compile_combined(self, ctx, expr: ColumnExpression):
        from pathway_tpu_torch.engine.expression_eval import EvalContext, compile_batch

        ectx = EvalContext(self._combined_resolver())
        ectx.error_logger = ctx.engine.log_error
        return compile_batch(expr, ectx)

    def _expand_args(self, args) -> Dict[str, ColumnExpression]:
        out: Dict[str, ColumnExpression] = {}
        mapping = self._mapping()
        for arg in args:
            if arg is thisclass.left:
                for n in self._left.column_names():
                    out[n] = self._left[n]
            elif arg is thisclass.right:
                for n in self._right.column_names():
                    out[n] = self._right[n]
            elif arg is thisclass.this:
                for n in self._left.column_names():
                    out[n] = self._left[n]
                for n in self._right.column_names():
                    if n not in out:
                        out[n] = self._right[n]
            else:
                sub = expand_select_args([arg], self._left, mapping)
                out.update(sub)
        return {n: self._apply_remap(e) for n, e in out.items()}

    def filter(self, expression) -> "JoinResult":
        out = copy.copy(self)
        out._filters = self._filters + [
            self._apply_remap(desugar(expression, self._mapping()))
        ]
        return out

    def select(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table

        cols = self._expand_args(args)
        mapping = self._mapping()
        for name, e in kwargs.items():
            cols[name] = self._apply_remap(desugar(e, mapping))
        jr = self

        def build(ctx):
            from pathway_tpu_torch.engine.engine import FilterNode, RowwiseNode

            node = jr._join_node(ctx)
            for f in jr._filters:
                node = FilterNode(ctx.engine, node, jr._compile_combined(ctx, f))
            progs = [jr._compile_combined(ctx, e) for e in cols.values()]

            def batch_fn(keys, rows):
                if not progs:
                    return [() for _ in keys]
                columns = [p(keys, rows) for p in progs]
                return list(zip(*columns))

            return RowwiseNode(ctx.engine, [node], batch_fn)

        schema_cols = {}
        for name, e in cols.items():
            schema_cols[name] = ColumnSchema(
                name=name, dtype=self._infer_joined(e)
            )
        from pathway_tpu_torch.internals.parse_graph import record_op

        return record_op(
            Table(
                schema=schema_from_columns(schema_cols),
                universe=Universe(),
                build=build,
            ),
            "join",
            (self._left, self._right),
            {
                "on_left": list(self._on_left),
                "on_right": list(self._on_right),
                "cols": dict(cols),
                "filters": list(self._filters),
            },
            mode=self._mode.name,
            join_result=self,
        )

    def _infer_joined(self, expr: ColumnExpression) -> dt.DType:
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        left, right = self._left, self._right
        optional_left = self._mode in (JoinMode.RIGHT, JoinMode.OUTER)
        optional_right = self._mode in (JoinMode.LEFT, JoinMode.OUTER)

        def resolve(ref: ColumnReference) -> dt.DType:
            if isinstance(ref, IdReference):
                return dt.POINTER
            base = ref._table._schema[ref.name].dtype
            if ref._table is left and optional_left:
                return dt.Optionalize(base)
            if ref._table is right and optional_right:
                return dt.Optionalize(base)
            return base

        return infer_dtype(expr, resolve)

    def reduce(self, *args, **kwargs):
        return self._grouped([]).reduce(*args, **kwargs)

    def groupby(self, *args, id=None, instance=None):
        mapping = self._mapping()
        grouping = [desugar(a, mapping) for a in args]
        return self._grouped(
            grouping,
            id_expr=desugar(id, mapping) if id is not None else None,
            instance=desugar(instance, mapping) if instance is not None else None,
        )

    def _grouped(self, grouping, id_expr=None, instance=None):
        """Materialize the combined row as a table, then group it."""
        cols: Dict[str, ColumnExpression] = {}
        for n in self._left.column_names():
            cols[f"_l_{n}"] = self._left[n]
        for n in self._right.column_names():
            cols[f"_r_{n}"] = self._right[n]
        cols["_pw_left_id"] = self._left.id
        cols["_pw_right_id"] = self._right.id
        combined = self.select(**cols)
        return _RemappedGroupBy(
            combined,
            self._left,
            self._right,
            grouping,
            id_expr=id_expr,
            instance=instance,
        )


class _RemappedGroupBy:
    """groupby over a join: grouping/reducer expressions referencing the
    original sides are rewritten onto the combined table."""

    def __init__(self, combined, left, right, grouping, id_expr=None, instance=None):
        self._combined = combined
        self._left = left
        self._right = right
        self._grouping = [self._remap(g) for g in grouping]
        self._id_expr = self._remap(id_expr) if id_expr is not None else None
        self._instance = self._remap(instance) if instance is not None else None

    def _remap(self, expr: ColumnExpression) -> ColumnExpression:
        left, right, combined = self._left, self._right, self._combined

        def rec(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, IdReference):
                if e._table is left:
                    return combined["_pw_left_id"]
                if e._table is right:
                    return combined["_pw_right_id"]
                return IdReference(combined)
            if isinstance(e, ColumnReference):
                if e._table is left:
                    return combined[f"_l_{e.name}"]
                if e._table is right:
                    return combined[f"_r_{e.name}"]
                return e
            out = copy.copy(e)
            for attr, value in list(vars(e).items()):
                if isinstance(value, ColumnExpression):
                    setattr(out, attr, rec(value))
                elif isinstance(value, tuple) and any(
                    isinstance(v, ColumnExpression) for v in value
                ):
                    setattr(
                        out,
                        attr,
                        tuple(
                            rec(v) if isinstance(v, ColumnExpression) else v
                            for v in value
                        ),
                    )
            return out

        return rec(expr)

    def reduce(self, *args, **kwargs):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        args = [self._remap(desugar(a, self._join_mapping())) for a in args]
        kwargs = {
            k: self._remap(desugar(v, self._join_mapping()))
            for k, v in kwargs.items()
        }
        gt = GroupedTable(
            self._combined,
            self._grouping,
            id_expr=self._id_expr,
            instance=self._instance,
        )
        result = gt.reduce(
            **{self._strip(a): a for a in args},
            **kwargs,
        )
        return result

    def _strip(self, ref) -> str:
        name = ref.name
        if name.startswith("_l_") or name.startswith("_r_"):
            return name[3:]
        return name

    def _join_mapping(self):
        return {
            thisclass.left: self._left,
            thisclass.right: self._right,
            thisclass.this: self._combined,
        }


class _JoinThisProxy:
    """Resolution target for pw.this inside join select: picks the side
    that has the column."""

    def __init__(self, jr: JoinResult):
        self._jr = jr

    def __getitem__(self, name: str):
        return self._jr._resolve_this(name)

    def column_names(self):
        seen = dict.fromkeys(
            self._jr._left.column_names() + self._jr._right.column_names()
        )
        return list(seen)


# flattened-hierarchy aliases (reference: joins.py Joinable:46 is the base
# of Table and JoinResult; table_like.py TableLike. Here the classes are
# independent, so the exported names point at the primary types.)
OuterJoinResult = JoinResult
GroupedJoinResult = _RemappedGroupBy


def join(left, right, *on, id=None, how=JoinMode.INNER, **kwargs):
    """Free-function form of ``left.join(right, ...)`` (reference:
    joins.py join:1161)."""
    return left.join(right, *on, id=id, how=how, **kwargs)


def join_inner(left, right, *on, **kwargs):
    return left.join_inner(right, *on, **kwargs)


def join_left(left, right, *on, **kwargs):
    return left.join_left(right, *on, **kwargs)


def join_right(left, right, *on, **kwargs):
    return left.join_right(right, *on, **kwargs)


def join_outer(left, right, *on, **kwargs):
    return left.join_outer(right, *on, **kwargs)


def groupby(grouped, *args, **kwargs):
    """Free-function form of ``grouped.groupby(...)`` over a Table or a
    JoinResult (reference: table.py groupby:3048)."""
    return grouped.groupby(*args, **kwargs)
