"""Static type inference over expression trees (reference:
python/pathway/internals/type_interpreter.py + operator_mapping.py)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    BinaryOpExpression,
    CastExpression,
    CoalesceExpression,
    ColumnConstExpression,
    ColumnExpression,
    ColumnReference,
    ConvertExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    GetExpression,
    IdReference,
    IfElseExpression,
    IsNoneExpression,
    MakeTupleExpression,
    MethodCallExpression,
    PointerExpression,
    ReducerExpression,
    RequireExpression,
    ThisColumnReference,
    UnaryOpExpression,
    UnwrapExpression,
)

_ARITH = {"+", "-", "*", "**"}
_COMPARE = {"==", "!=", "<", "<=", ">", ">="}
_BOOL_OPS = {"&", "|", "^"}


def const_dtype(value: Any) -> dt.DType:
    if value is None:
        return dt.NONE
    if isinstance(value, bool):
        return dt.BOOL
    if isinstance(value, int):
        return dt.INT
    if isinstance(value, float):
        return dt.FLOAT
    if isinstance(value, str):
        return dt.STR
    if isinstance(value, bytes):
        return dt.BYTES
    if isinstance(value, tuple):
        return dt.TupleDType(tuple(const_dtype(v) for v in value))
    from pathway_tpu_torch.engine.value import Json, Pointer

    if isinstance(value, Pointer):
        return dt.POINTER
    if isinstance(value, Json):
        return dt.JSON
    import datetime

    import numpy as np

    if isinstance(value, datetime.datetime):
        return dt.DATE_TIME_UTC if value.tzinfo else dt.DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return dt.DURATION
    if isinstance(value, np.ndarray):
        return dt.ANY_ARRAY
    return dt.ANY


def infer_dtype(
    expr: ColumnExpression,
    resolve: Callable[[ColumnReference], dt.DType],
) -> dt.DType:
    def rec(e: ColumnExpression) -> dt.DType:
        if isinstance(e, ColumnConstExpression):
            return const_dtype(e._value)
        if isinstance(e, IdReference):
            return dt.POINTER
        if isinstance(e, ColumnReference):
            return resolve(e)
        if isinstance(e, ThisColumnReference):
            raise RuntimeError("undesugared this-reference in type inference")
        if isinstance(e, BinaryOpExpression):
            lt, rt = rec(e._left), rec(e._right)
            op = e._op
            if op in _COMPARE:
                return dt.BOOL
            if op in _BOOL_OPS:
                if dt.unoptionalize(lt) is dt.INT:
                    return dt.INT
                return dt.BOOL
            lt_core, rt_core = dt.unoptionalize(lt), dt.unoptionalize(rt)
            optional = dt.is_optional(lt) or dt.is_optional(rt)

            def opt(d: dt.DType) -> dt.DType:
                return dt.Optionalize(d) if optional and d is not dt.ANY else d

            if op == "/":
                if lt_core in (dt.INT, dt.FLOAT) and rt_core in (dt.INT, dt.FLOAT):
                    return opt(dt.FLOAT)
            if op in _ARITH or op in {"//", "%"}:
                if lt_core is dt.FLOAT or rt_core is dt.FLOAT:
                    if lt_core in (dt.INT, dt.FLOAT, dt.BOOL) and rt_core in (
                        dt.INT,
                        dt.FLOAT,
                        dt.BOOL,
                    ):
                        return opt(dt.FLOAT)
                if lt_core is dt.INT and rt_core is dt.INT:
                    return opt(dt.INT)
                if op == "+" and lt_core is dt.STR and rt_core is dt.STR:
                    return opt(dt.STR)
                if op == "*" and {lt_core, rt_core} <= {dt.STR, dt.INT}:
                    return opt(dt.STR)
                # datetime arithmetic
                if lt_core in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                    if rt_core is dt.DURATION:
                        return opt(lt_core)
                    if rt_core is lt_core and op == "-":
                        return opt(dt.DURATION)
                if lt_core is dt.DURATION:
                    if rt_core in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and op == "+":
                        return opt(rt_core)
                    if rt_core is dt.DURATION and op in {"+", "-"}:
                        return opt(dt.DURATION)
                    if rt_core is dt.INT and op == "*":
                        return opt(dt.DURATION)
                if op == "+" and isinstance(lt_core, (dt.TupleDType, dt.ListDType)):
                    return dt.ANY_TUPLE
            if op == "@":
                return dt.ANY_ARRAY
            if op in {"<<", ">>"}:
                return opt(dt.INT)
            return dt.ANY
        if isinstance(e, UnaryOpExpression):
            at = rec(e._arg)
            if e._op == "~":
                return at
            return at
        if isinstance(e, IsNoneExpression):
            return dt.BOOL
        if isinstance(e, IfElseExpression):
            return dt.types_lca(rec(e._then), rec(e._else))
        if isinstance(e, CoalesceExpression):
            out = rec(e._args[-1])
            for a in reversed(e._args[:-1]):
                at = dt.unoptionalize(rec(a))
                out = dt.types_lca(at, dt.unoptionalize(out))
            # result optional only if every arg optional
            if all(dt.is_optional(rec(a)) for a in e._args):
                return dt.Optionalize(out)
            return out
        if isinstance(e, RequireExpression):
            return dt.Optionalize(rec(e._val))
        if isinstance(e, CastExpression):
            inner = rec(e._expr)
            if dt.is_optional(inner) and not isinstance(e._target, dt.Optionalized):
                return dt.Optionalize(e._target)
            return e._target
        if isinstance(e, ConvertExpression):
            if e._unwrap:
                return e._target
            return dt.Optionalize(e._target)
        if isinstance(e, DeclareTypeExpression):
            return e._target
        if isinstance(e, ApplyExpression):
            return e._return_type
        if isinstance(e, MakeTupleExpression):
            return dt.TupleDType(tuple(rec(a) for a in e._args))
        if isinstance(e, GetExpression):
            ot = dt.unoptionalize(rec(e._obj))
            if isinstance(ot, dt.TupleDType):
                idx = e._index
                if (
                    isinstance(idx, ColumnConstExpression)
                    and isinstance(idx._value, int)
                    and -len(ot.args) <= idx._value < len(ot.args)
                ):
                    return ot.args[idx._value]
                out = ot.args[0] if ot.args else dt.ANY
                for a in ot.args[1:]:
                    out = dt.types_lca(out, a)
                return out
            if isinstance(ot, dt.ListDType):
                base = ot.arg
                return base if e._check_if_exists else dt.Optionalize(base)
            if ot is dt.JSON:
                return dt.JSON
            return dt.ANY
        if isinstance(e, UnwrapExpression):
            return dt.unoptionalize(rec(e._expr))
        if isinstance(e, FillErrorExpression):
            return dt.types_lca(rec(e._expr), rec(e._replacement))
        if isinstance(e, PointerExpression):
            return dt.Optionalize(dt.POINTER) if e._optional else dt.POINTER
        if isinstance(e, MethodCallExpression):
            base = e._return_type
            if base is not None and not isinstance(base, dt.DType) and callable(base):
                # dtype-dependent return (e.g. num.abs: int->int,
                # float->float)
                base = base(rec(e._args[0]) if e._args else dt.ANY)
            if base is None:
                base = dt.ANY
            if e._propagate_none and e._args and dt.is_optional(rec(e._args[0])):
                return dt.Optionalize(base)
            return base
        if isinstance(e, ReducerExpression):
            from pathway_tpu_torch.internals.reducers import infer_reducer_dtype

            return infer_reducer_dtype(e, rec)
        return dt.ANY

    return rec(expr)
