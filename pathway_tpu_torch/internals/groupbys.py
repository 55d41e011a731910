"""groupby().reduce() desugaring (reference:
python/pathway/internals/groupbys.py).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... g | h | v
... a | x | 1
... a | y | 2
... a | x | 3
... ''')
>>> r = t.groupby(pw.this.g, pw.this.h).reduce(
...     pw.this.g, pw.this.h, s=pw.reducers.sum(pw.this.v)
... )
>>> pw.debug.compute_and_print(r, include_id=False)
g | h | s
a | y | 2
a | x | 4
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    IdReference,
    ReducerExpression,
    collect_tables,
    smart_wrap,
)
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.internals.type_interpreter import infer_dtype
from pathway_tpu_torch.internals.universe import Universe


class GroupedTable:
    """Intermediate of t.groupby(...) (reference: groupbys.py GroupedTable)."""

    def __init__(
        self,
        table,
        grouping: List[ColumnExpression],
        *,
        instance: ColumnExpression | None = None,
        id_expr: ColumnExpression | None = None,
        sort_by: ColumnExpression | None = None,
    ):
        self._table = table
        self._grouping = grouping
        self._instance = instance
        self._id_expr = id_expr
        self._sort_by = sort_by

    def reduce(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table, _compile_on

        source = self._table
        mapping = {thisclass.this: source}
        cols: Dict[str, ColumnExpression] = {}
        for arg in args:
            resolved = desugar(arg, mapping)
            if not isinstance(resolved, ColumnReference):
                raise TypeError(
                    "positional reduce arguments must be column references"
                )
            cols[resolved.name] = resolved
        for name, e in kwargs.items():
            cols[name] = desugar(e, mapping)

        # harvest reducers from the output expressions
        reducers: List[ReducerExpression] = []

        def harvest(expr: ColumnExpression) -> ColumnExpression:
            if isinstance(expr, ReducerExpression):
                reducers.append(expr)
                return _ReducerSlot(len(reducers) - 1, expr)
            out = copy.copy(expr)
            changed = False
            for attr, value in list(vars(expr).items()):
                if isinstance(value, ColumnExpression):
                    setattr(out, attr, harvest(value))
                    changed = True
                elif isinstance(value, tuple) and any(
                    isinstance(v, ColumnExpression) for v in value
                ):
                    setattr(
                        out,
                        attr,
                        tuple(
                            harvest(v) if isinstance(v, ColumnExpression) else v
                            for v in value
                        ),
                    )
                    changed = True
            return out if changed else expr

        cols = {name: harvest(e) for name, e in cols.items()}

        grouping = self._grouping
        instance = self._instance
        id_expr = self._id_expr
        sort_by = self._sort_by

        # absorb same-universe foreign columns: the reference lets
        # reducers read other tables sharing the groupby's universe
        # (test_common.py test_groupby_foreign_column). Select them onto
        # the source first, then reduce single-table.
        from pathway_tpu_torch.internals.expression import map_refs
        from pathway_tpu_torch.internals.universe import solver

        all_exprs = (
            [a for r in reducers for a in r._args]
            + list(cols.values())
            + grouping
            + [e for e in (instance, id_expr, sort_by) if e is not None]
        )
        foreign: Dict[int, ColumnReference] = {}
        for e in all_exprs:
            for tbl in collect_tables(e, set()):
                if tbl is not source and isinstance(tbl, Table):
                    foreign[id(tbl)] = tbl
        if foreign:
            for tbl in foreign.values():
                if not solver.query_are_equal(
                    tbl._universe, source._universe
                ):
                    raise ValueError(
                        "reduce() may only reference the grouped table "
                        "or tables sharing its universe"
                    )
            helper_cols = {c: source[c] for c in source.column_names()}
            gen: Dict[Tuple[int, str], str] = {}

            def note(ref):
                key = (id(ref._table), ref._name)
                if key not in gen:
                    name = f"_pw_fx{len(gen)}"
                    while name in helper_cols:  # user column collision
                        name = "_" + name
                    gen[key] = name
                    helper_cols[name] = ref
                return gen[key]

            # first pass registers every foreign ref on the helper
            def scan(node):
                if (
                    isinstance(node, ColumnReference)
                    and not isinstance(node, IdReference)
                    and node._table is not source
                ):
                    note(node)
                return node

            for e in all_exprs:
                map_refs(e, scan)
            helper = source._select_impl(helper_cols)

            def retable(node):
                if node._table is helper:
                    return node  # idempotent: slots share reducer exprs
                if isinstance(node, IdReference):
                    return IdReference(helper)
                if node._table is source:
                    return helper[node._name]
                return helper[gen[(id(node._table), node._name)]]

            for r in reducers:
                r._args = tuple(map_refs(a, retable) for a in r._args)
            cols = {n: map_refs(e, retable) for n, e in cols.items()}
            grouping = [map_refs(g, retable) for g in grouping]
            if instance is not None:
                instance = map_refs(instance, retable)
            if id_expr is not None:
                id_expr = map_refs(id_expr, retable)
            if sort_by is not None:
                sort_by = map_refs(sort_by, retable)
            source = helper
        n_group = len(grouping)

        # group-key caching (and the fused raw-value code map) relies on
        # dict equality agreeing with ref_scalar's key derivation.  Python
        # dicts equate True == 1 == 1.0 while ref_scalar separates bool
        # from numbers, so caching is only sound when the group column
        # dtypes preclude mixed bool/number values — i.e. concrete
        # non-ANY dtypes.  (int vs float is safe: ref_scalar hashes
        # integral floats and ints identically, matching dict equality.)
        _CACHEABLE_GROUP_DTYPES = (
            dt.STR, dt.INT, dt.FLOAT, dt.BOOL, dt.BYTES, dt.POINTER,
            dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC, dt.DURATION,
        )

        def _cacheable_dtype(d) -> bool:
            if isinstance(d, dt.Optionalized):
                d = dt.unoptionalize(d)
            return d in _CACHEABLE_GROUP_DTYPES

        group_keys_cacheable = True
        for g in grouping:
            try:
                if not _cacheable_dtype(self._infer_on_source(g)):
                    group_keys_cacheable = False
                    break
            except Exception:  # noqa: BLE001
                group_keys_cacheable = False
                break

        # static gate for the columnar reduce path (engine/vector_reduce.py):
        # vector reducers only, deterministic args (retractions recompute
        # them from the retraction row), default grouping keys, no ordering
        # dependence.  Argument dtypes: numeric for the lane reducers —
        # Optionalized numeric admitted only for sum/avg, which carry None
        # multiplicities columnar-ly; min/max stay classic on optional
        # columns (the classic accumulator's None-death is path-dependent).
        # `any` never compares values, so it takes any argument dtype.
        # Reasons are collected (not short-circuited) so the analyzer can
        # report every disqualifier; `use_vector` stays exactly
        # "no reasons", which the build closure below captures — the
        # analyzer's prediction and the selected node cannot disagree.
        vector_reasons: List[str] = []
        if sort_by is not None:
            vector_reasons.append(
                "sort_by makes accumulation order-dependent"
            )
        if id_expr is not None:
            vector_reasons.append("explicit id= keying bypasses group keys")
        from pathway_tpu_torch.engine.vector_reduce import VECTOR_REDUCERS
        from pathway_tpu_torch.internals.table import _expr_deterministic

        for red in reducers:
            name = red._reducer.name
            if name not in VECTOR_REDUCERS:
                vector_reasons.append(
                    f"reducer {name!r} has no vector implementation"
                )
                continue
            if not all(_expr_deterministic(a) for a in red._args):
                vector_reasons.append(
                    f"reducer {name!r} has a non-deterministic argument"
                )
                continue
            if red._args and name != "any":
                try:
                    adt = self._infer_on_source(red._args[0])
                except Exception:  # noqa: BLE001
                    vector_reasons.append(
                        f"reducer {name!r} argument dtype is uninferable"
                    )
                    continue
                opt = isinstance(adt, dt.Optionalized)
                base = dt.unoptionalize(adt) if opt else adt
                if base not in (dt.INT, dt.FLOAT, dt.BOOL):
                    vector_reasons.append(
                        f"reducer {name!r} argument dtype {adt} is not "
                        "numeric"
                    )
                    continue
                if opt and name not in ("sum", "avg"):
                    vector_reasons.append(
                        f"reducer {name!r} does not accept optional "
                        f"dtype {adt}"
                    )
        use_vector = not vector_reasons

        def build(ctx):
            from pathway_tpu_torch.engine.operators import ReduceNode
            from pathway_tpu_torch.engine.value import ERROR, Error, Pointer, ref_scalar

            node = ctx.node(source)
            group_progs = [_compile_on(ctx, [source], g) for g in grouping]
            instance_prog = (
                _compile_on(ctx, [source], instance) if instance is not None else None
            )
            id_prog = (
                _compile_on(ctx, [source], id_expr) if id_expr is not None else None
            )
            sort_prog = (
                _compile_on(ctx, [source], sort_by) if sort_by is not None else None
            )

            # (gvals, instance) -> (gkey, gvals): streams revisit the same
            # groups every batch, and the 128-bit blake2b in ref_scalar is
            # ~10x a dict hit.  Bounded: cleared when it outgrows the cap.
            key_cache: dict = {}
            _CACHE_CAP = 1 << 20

            def group_fn(keys, rows):
                gcols = [p(keys, rows) for p in group_progs]
                instances = (
                    instance_prog(keys, rows) if instance_prog is not None else None
                )
                ids = id_prog(keys, rows) if id_prog is not None else None
                out = []
                if len(key_cache) > _CACHE_CAP:
                    key_cache.clear()
                for i in range(len(keys)):
                    gvals = tuple(c[i] for c in gcols)
                    if ids is not None:
                        if isinstance(gvals, tuple) and any(
                            isinstance(v, Error) for v in gvals
                        ):
                            out.append((ERROR, gvals))
                            continue
                        out.append((ids[i], gvals))
                        continue
                    inst = instances[i] if instances is not None else None
                    if group_keys_cacheable:
                        try:
                            cached = key_cache.get((gvals, inst))
                        except TypeError:
                            cached = None
                            gvals_key = None
                        else:
                            gvals_key = (gvals, inst)
                        if cached is not None:
                            out.append((cached, gvals))
                            continue
                    else:
                        gvals_key = None
                    if any(isinstance(v, Error) for v in gvals):
                        # an Error grouping value must exclude the row (and
                        # log), not silently form its own Error-group
                        # (reference: group_by error handling, reduce.rs)
                        out.append((ERROR, gvals))
                        continue
                    gkey = ref_scalar(*gvals, instance=inst)
                    if gvals_key is not None:
                        key_cache[gvals_key] = gkey
                    out.append((gkey, gvals))
                return out

            if use_vector:
                from pathway_tpu_torch.engine.vector_reduce import VectorReduceNode

                arg_col_fns = []
                arg_kinds = []
                arg_optionals = []
                for red in reducers:
                    if red._args:
                        prog = _compile_on(ctx, [source], red._args[0])
                        arg_col_fns.append(prog)
                        adt = self._infer_on_source(red._args[0])
                        opt = isinstance(adt, dt.Optionalized)
                        if opt:
                            adt = dt.unoptionalize(adt)
                        arg_kinds.append("f" if adt == dt.FLOAT else "i")
                        arg_optionals.append(opt)
                    else:
                        arg_col_fns.append(None)
                        arg_kinds.append("i")
                        arg_optionals.append(False)
                return VectorReduceNode(
                    ctx.engine,
                    node,
                    group_fn,
                    [r._reducer for r in reducers],
                    arg_col_fns,
                    gval_width=n_group,
                    arg_kinds=arg_kinds,
                    arg_optionals=arg_optionals,
                    # fused raw-value -> group-code mapping works only for
                    # default-keyed grouping without instances, and (like
                    # key_cache) only when dict equality over the group
                    # values cannot alias distinct ref_scalar keys
                    group_col_progs=(
                        group_progs
                        if instance is None
                        and group_progs
                        and group_keys_cacheable
                        else None
                    ),
                )

            args_fns = []
            for red in reducers:
                arg_progs = [_compile_on(ctx, [source], a) for a in red._args]

                def make_fn(arg_progs=arg_progs):
                    def fn(keys, rows):
                        if not arg_progs:
                            return [() for _ in keys]
                        acols = [p(keys, rows) for p in arg_progs]
                        return [tuple(c[i] for c in acols) for i in range(len(keys))]

                    return fn

                args_fns.append(make_fn())

            return ReduceNode(
                ctx.engine,
                node,
                group_fn,
                [r._reducer for r in reducers],
                args_fns,
                gval_width=n_group,
                sort_fn=sort_prog,
            )

        # the raw reduce output: grouping values then reducer results
        raw_cols: Dict[str, ColumnSchema] = {}
        for i, g in enumerate(grouping):
            raw_cols[f"_g{i}"] = ColumnSchema(
                name=f"_g{i}", dtype=self._infer_on_source(g)
            )
        for j, red in enumerate(reducers):
            raw_cols[f"_r{j}"] = ColumnSchema(
                name=f"_r{j}", dtype=self._infer_on_source(red)
            )
        from pathway_tpu_torch.internals.parse_graph import record_op

        raw = record_op(
            Table(
                schema=schema_from_columns(raw_cols),
                universe=Universe(),
                build=build,
            ),
            "reduce",
            (source,),
            {
                "grouping": list(grouping),
                "reducers": list(reducers),
                "instance": instance,
                "id_expr": id_expr,
                "sort_by": sort_by,
            },
            use_vector=use_vector,
            vector_reasons=list(vector_reasons),
        )

        # rewrite output expressions against the raw table
        group_index: Dict[tuple, int] = {}
        expr_group_index: Dict[tuple, int] = {}

        def _fingerprint(e) -> tuple:
            """Structural identity of an expression, strict enough that
            two different lambdas never collide (functions compare by
            object identity, tables by object identity)."""
            if isinstance(e, IdReference):
                return ("id", id(e._table))
            if isinstance(e, ColumnReference):
                return ("col", id(e._table), e._name)
            parts = [type(e).__name__]
            for attr, value in sorted(vars(e).items()):
                if isinstance(value, ColumnExpression):
                    parts.append((attr, _fingerprint(value)))
                elif isinstance(value, tuple):
                    parts.append(
                        (
                            attr,
                            tuple(
                                _fingerprint(v)
                                if isinstance(v, ColumnExpression)
                                else repr(v)
                                for v in value
                            ),
                        )
                    )
                elif callable(value):
                    parts.append((attr, id(value)))
                else:
                    parts.append((attr, repr(value)))
            return tuple(parts)

        for i, g in enumerate(grouping):
            if isinstance(g, ColumnReference) and not isinstance(g, IdReference):
                group_index[(id(g._table), g.name)] = i
            elif isinstance(g, IdReference):
                group_index[(id(g._table), "id")] = i
            else:
                # expression grouping key (e.g. t.v % 2): outputs equal to
                # it (structurally) read the group value
                expr_group_index[_fingerprint(g)] = i

        def rewrite(expr: ColumnExpression) -> ColumnExpression:
            if isinstance(expr, _ReducerSlot):
                return raw[f"_r{expr.index}"]
            if expr_group_index and not isinstance(expr, ColumnReference):
                loc = expr_group_index.get(_fingerprint(expr))
                if loc is not None:
                    return raw[f"_g{loc}"]
            if isinstance(expr, IdReference):
                loc = group_index.get((id(expr._table), "id"))
                if loc is not None:
                    return raw[f"_g{loc}"]
                return IdReference(raw)
            if isinstance(expr, ColumnReference):
                loc = group_index.get((id(expr._table), expr.name))
                if loc is None:
                    raise ValueError(
                        f"column {expr.name!r} used in reduce() is neither a "
                        "grouping column nor inside a reducer"
                    )
                return raw[f"_g{loc}"]
            out = copy.copy(expr)
            for attr, value in list(vars(expr).items()):
                if isinstance(value, ColumnExpression):
                    setattr(out, attr, rewrite(value))
                elif isinstance(value, tuple) and any(
                    isinstance(v, ColumnExpression) for v in value
                ):
                    setattr(
                        out,
                        attr,
                        tuple(
                            rewrite(v) if isinstance(v, ColumnExpression) else v
                            for v in value
                        ),
                    )
            return out

        final_cols = {name: rewrite(e) for name, e in cols.items()}
        return raw._select_impl(final_cols)

    def _infer_on_source(self, expr: ColumnExpression) -> dt.DType:
        def resolve(ref: ColumnReference) -> dt.DType:
            if isinstance(ref, IdReference):
                return dt.POINTER
            return ref._table._schema[ref.name].dtype

        return infer_dtype(expr, resolve)


class _ReducerSlot(ColumnExpression):
    def __init__(self, index: int, original: ReducerExpression):
        self.index = index
        self.original = original

    def _deps(self):
        return ()
