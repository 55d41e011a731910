"""Desugaring: resolve pw.this / pw.left / pw.right placeholders to concrete
tables (reference: python/pathway/internals/desugaring.py)."""

from __future__ import annotations

import copy
from typing import Any, Dict

from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    DelayedIxRef,
    IdReference,
    PointerExpression,
    ThisColumnReference,
    smart_wrap,
)


def _substitute_table(table, mapping: Dict[Any, Any]):
    for placeholder, concrete in mapping.items():
        if table is placeholder:
            return concrete
    return table


def desugar(expr: Any, mapping: Dict[Any, Any]) -> ColumnExpression:
    """Return a copy of `expr` with this/left/right references bound to the
    concrete tables given in `mapping` (e.g. {pw.this: t, pw.left: a})."""
    expr = smart_wrap(expr)

    def rec(node: ColumnExpression) -> ColumnExpression:
        if isinstance(node, DelayedIxRef):
            # const-keyed ix: the lookup row set is this context's table
            context = _substitute_table(thisclass.this, mapping)
            if context is thisclass.this:
                raise ValueError(
                    "ix_ref with constant keys needs an enclosing "
                    "select/reduce to provide its row context"
                )
            if not hasattr(context, "_universe"):
                # join/grouped contexts resolve `this` to a proxy, not a
                # Table — fail clearly instead of crashing downstream
                raise ValueError(
                    "ix_ref with constant keys is not supported inside "
                    "join or groupby expressions; select the looked-up "
                    "value onto a table first"
                )
            ptr = node._ptr
            bound = PointerExpression(
                node._target,
                *(rec(a) for a in ptr._args),
                optional=ptr._optional,
                instance=(
                    rec(ptr._instance) if ptr._instance is not None else None
                ),
            )
            resolved = node._target.ix(
                bound, optional=node._optional, context=context
            )
            return resolved[node._name]
        if isinstance(node, ThisColumnReference):
            concrete = _substitute_table(node._this, mapping)
            if concrete is node._this:
                raise ValueError(
                    f"cannot resolve {node._this!r} reference in this context"
                )
            if node._name == thisclass.KEY_ID:
                return IdReference(concrete)
            return concrete[node._name]
        if isinstance(node, IdReference):
            return node
        if isinstance(node, ColumnReference):
            return node
        out = copy.copy(node)
        for attr, value in list(vars(node).items()):
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
            elif isinstance(value, dict) and any(
                isinstance(v, ColumnExpression) for v in value.values()
            ):
                setattr(
                    out,
                    attr,
                    {
                        k: rec(v) if isinstance(v, ColumnExpression) else v
                        for k, v in value.items()
                    },
                )
        if isinstance(node, PointerExpression):
            out._table = _substitute_table(node._table, mapping)
        return out

    return rec(expr)


def expand_select_args(args, this_table, mapping) -> Dict[str, ColumnExpression]:
    """Positional select arguments: column references keep their names;
    pw.this.without(...) and pw.this[...] slices expand."""
    out: Dict[str, ColumnExpression] = {}
    for arg in args:
        if isinstance(arg, thisclass._ThisAll):
            concrete = _substitute_table(arg.this_cls, mapping)
            for name in concrete.column_names():
                out[name] = concrete[name]
        elif isinstance(arg, thisclass._ThisWithout):
            concrete = _substitute_table(arg.this_cls, mapping)
            for name in concrete.column_names():
                if name not in arg.columns:
                    out[name] = concrete[name]
        elif isinstance(arg, thisclass._ThisSlice):
            for ref in arg.refs:
                resolved = desugar(ref, mapping)
                out[resolved.name] = resolved
        elif isinstance(arg, (ThisColumnReference, ColumnReference)):
            resolved = desugar(arg, mapping)
            if isinstance(resolved, IdReference):
                raise ValueError("cannot select id positionally; use a kwarg")
            out[resolved.name] = resolved
        elif hasattr(arg, "_table_slice_columns"):  # TableSlice
            for name, ref in arg._table_slice_columns():
                out[name] = desugar(ref, mapping)
        else:
            raise TypeError(
                f"positional select arguments must be column references, "
                f"got {arg!r}"
            )
    return out
