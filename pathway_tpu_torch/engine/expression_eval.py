"""Columnar expression compiler.

TPU-native rebuild of the reference's typed expression interpreter (reference:
src/engine/expression.rs — batch-at-a-time `eval(&[&[Value]])`). Expressions
compile to batch programs `(keys, rows_per_input) -> column list`; scalar ops
run elementwise with per-row error isolation (errors become the Error value
and are logged, as in the reference), and `if_else` / `coalesce` / `require`
evaluate their branches lazily on row subsets so guarded expressions like
`if_else(d != 0, n / d, 0)` never fault.

Numeric full-column fast paths lower onto numpy (and, transitively, XLA when
the engine hands whole columns to the ops/ package).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

from pathway_tpu_torch.engine.value import ERROR, Error, Json, Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.device_pipeline import (
    pipeline_enabled as _pipeline_enabled,
)
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import sanitizer as _sanitizer
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
    FullyAsyncApplyExpression,
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

# Rows = per-input list of row tuples; a compiled program returns one column.
Rows = Tuple[List[tuple], ...]
BatchProgram = Callable[[List[Pointer], Rows], List[Any]]


class EvalContext:
    """Resolver from ColumnReference to (input index, column index)."""

    def __init__(self, resolve: Callable[[ColumnReference], Tuple[int, int] | None]):
        self.resolve = resolve
        self.error_logger: Callable[[str], None] = lambda msg: None


def _is_err(v: Any) -> bool:
    return isinstance(v, Error)


def _div(a, b):
    return a / b


def _floordiv(a, b):
    return a // b


def _mod(a, b):
    return a % b


def _matmul(a, b):
    import numpy as np

    return np.matmul(a, b)


def _and(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a and b
    return a & b


def _or(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a or b
    return a | b


def _xor(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a != b
    return a ^ b


_BINARY_IMPL: dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": _div,
    "//": _floordiv,
    "%": _mod,
    "**": lambda a, b: a**b,
    "@": _matmul,
    "<<": lambda a, b: a << b,
    ">>": lambda a, b: a >> b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&": _and,
    "|": _or,
    "^": _xor,
}


def _not(a):
    if isinstance(a, bool):
        return not a
    return ~a


_UNARY_IMPL: dict[str, Callable[[Any], Any]] = {
    "-": lambda a: -a,
    "~": _not,
    "abs": abs,
}


def compile_batch(expr: ColumnExpression, ctx: EvalContext) -> BatchProgram:
    """Compile an expression tree to a batch program."""
    if isinstance(expr, ColumnConstExpression):
        value = expr._value
        return lambda keys, rows: [value] * len(keys)

    if isinstance(expr, IdReference):
        loc = ctx.resolve(expr)
        if loc is None or loc == ("id",):
            return lambda keys, rows: list(keys)
        input_idx, col_idx = loc
        return lambda keys, rows: [
            r[col_idx] if r is not None else None for r in rows[input_idx]
        ]

    if isinstance(expr, ColumnReference):
        loc = ctx.resolve(expr)
        if loc is None:
            raise KeyError(
                f"column {expr._name!r} of table {expr._table!r} "
                "is not available in this context"
            )
        if loc == ("id",):
            return lambda keys, rows: list(keys)
        input_idx, col_idx = loc
        # a None row means the key is absent from a secondary same-universe
        # input; surface as None values rather than crashing (the runtime
        # counterpart of universe subset promises)
        return lambda keys, rows: [
            r[col_idx] if r is not None else None for r in rows[input_idx]
        ]

    if isinstance(expr, ThisColumnReference):
        raise RuntimeError(
            f"undesugared this-reference {expr._name!r} reached the engine"
        )

    if isinstance(expr, BinaryOpExpression):
        left = compile_batch(expr._left, ctx)
        right = compile_batch(expr._right, ctx)
        impl = _BINARY_IMPL[expr._op]
        op = expr._op
        logger = ctx

        def run_binary(keys, rows):
            lv = left(keys, rows)
            rv = right(keys, rows)
            out = []
            for a, b in zip(lv, rv):
                if _is_err(a) or _is_err(b):
                    out.append(ERROR)
                    continue
                try:
                    out.append(impl(a, b))
                except Exception as exc:  # noqa: BLE001 — per-row isolation
                    logger.error_logger(
                        f"operator {op}: {type(exc).__name__}: {exc}"
                    )
                    out.append(ERROR)
            return out

        return run_binary

    if isinstance(expr, UnaryOpExpression):
        arg = compile_batch(expr._arg, ctx)
        impl = _UNARY_IMPL[expr._op]
        logger = ctx

        def run_unary(keys, rows):
            out = []
            for a in arg(keys, rows):
                if _is_err(a):
                    out.append(ERROR)
                    continue
                try:
                    out.append(impl(a))
                except Exception as exc:  # noqa: BLE001
                    logger.error_logger(f"{type(exc).__name__}: {exc}")
                    out.append(ERROR)
            return out

        return run_unary

    if isinstance(expr, IsNoneExpression):
        arg = compile_batch(expr._arg, ctx)
        positive = expr._positive

        def run_isnone(keys, rows):
            return [
                ERROR if _is_err(v) else ((v is None) == positive)
                for v in arg(keys, rows)
            ]

        return run_isnone

    if isinstance(expr, IfElseExpression):
        cond = compile_batch(expr._if, ctx)
        then = compile_batch(expr._then, ctx)
        else_ = compile_batch(expr._else, ctx)

        def run_ifelse(keys, rows):
            cv = cond(keys, rows)
            out: List[Any] = [None] * len(keys)
            t_idx = [i for i, c in enumerate(cv) if c is True]
            f_idx = [i for i, c in enumerate(cv) if c is False]
            e_idx = [i for i, c in enumerate(cv) if not isinstance(c, bool)]
            for idx, prog in ((t_idx, then), (f_idx, else_)):
                if not idx:
                    continue
                sub_keys = [keys[i] for i in idx]
                sub_rows = tuple([inp[i] for i in idx] for inp in rows)
                for i, v in zip(idx, prog(sub_keys, sub_rows)):
                    out[i] = v
            for i in e_idx:
                out[i] = ERROR
            return out

        return run_ifelse

    if isinstance(expr, CoalesceExpression):
        progs = [compile_batch(a, ctx) for a in expr._args]

        def run_coalesce(keys, rows):
            out: List[Any] = [None] * len(keys)
            remaining = list(range(len(keys)))
            for prog in progs:
                if not remaining:
                    break
                sub_keys = [keys[i] for i in remaining]
                sub_rows = tuple([inp[i] for i in remaining] for inp in rows)
                vals = prog(sub_keys, sub_rows)
                next_remaining = []
                for i, v in zip(remaining, vals):
                    if v is None:
                        next_remaining.append(i)
                    else:
                        out[i] = v
                remaining = next_remaining
            return out

        return run_coalesce

    if isinstance(expr, RequireExpression):
        val = compile_batch(expr._val, ctx)
        args = [compile_batch(a, ctx) for a in expr._args]

        def run_require(keys, rows):
            n = len(keys)
            ok = [True] * n
            for prog in args:
                for i, v in enumerate(prog(keys, rows)):
                    if v is None:
                        ok[i] = False
            out: List[Any] = [None] * n
            idx = [i for i in range(n) if ok[i]]
            if idx:
                sub_keys = [keys[i] for i in idx]
                sub_rows = tuple([inp[i] for i in idx] for inp in rows)
                for i, v in zip(idx, val(sub_keys, sub_rows)):
                    out[i] = v
            return out

        return run_require

    if isinstance(expr, CastExpression):
        arg = compile_batch(expr._expr, ctx)
        target = expr._target
        caster = _make_caster(target)
        logger = ctx

        def run_cast(keys, rows):
            out = []
            for v in arg(keys, rows):
                if v is None or _is_err(v):
                    out.append(v)
                    continue
                try:
                    out.append(caster(v))
                except Exception as exc:  # noqa: BLE001
                    logger.error_logger(f"cast: {type(exc).__name__}: {exc}")
                    out.append(ERROR)
            return out

        return run_cast

    if isinstance(expr, ConvertExpression):
        arg = compile_batch(expr._expr, ctx)
        default = compile_batch(expr._default, ctx)
        target = expr._target
        unwrap = expr._unwrap
        logger = ctx

        def run_convert(keys, rows):
            vals = arg(keys, rows)
            defaults = default(keys, rows)
            out = []
            for v, d in zip(vals, defaults):
                out.append(_convert_one(v, d, target, unwrap, logger))
            return out

        return run_convert

    if isinstance(expr, DeclareTypeExpression):
        return compile_batch(expr._expr, ctx)

    if isinstance(expr, FullyAsyncApplyExpression):
        # handled by the async-transformer machinery; in the direct evaluator
        # fall back to synchronous semantics (results are immediately final)
        return _compile_apply(expr, ctx)

    if isinstance(expr, ApplyExpression):
        return _compile_apply(expr, ctx)

    if isinstance(expr, MakeTupleExpression):
        progs = [compile_batch(a, ctx) for a in expr._args]

        def run_make_tuple(keys, rows):
            cols = [p(keys, rows) for p in progs]
            return [tuple(vals) for vals in zip(*cols)] if cols else [
                () for _ in keys
            ]

        return run_make_tuple

    if isinstance(expr, GetExpression):
        obj = compile_batch(expr._obj, ctx)
        index = compile_batch(expr._index, ctx)
        default = compile_batch(expr._default, ctx)
        checked = expr._check_if_exists
        logger = ctx

        def run_get(keys, rows):
            ovs = obj(keys, rows)
            ivs = index(keys, rows)
            dvs = default(keys, rows)
            out = []
            for o, i, d in zip(ovs, ivs, dvs):
                if _is_err(o) or _is_err(i):
                    out.append(ERROR)
                    continue
                try:
                    if isinstance(o, Json):
                        got = o.get(i, _SENTINEL)
                        if got is _SENTINEL:
                            raise KeyError(i)
                        out.append(got)
                    else:
                        out.append(o[i])
                except Exception as exc:  # noqa: BLE001
                    if checked:
                        logger.error_logger(f"get: {type(exc).__name__}: {exc}")
                        out.append(ERROR)
                    else:
                        out.append(d)
            return out

        return run_get

    if isinstance(expr, UnwrapExpression):
        arg = compile_batch(expr._expr, ctx)
        logger = ctx

        def run_unwrap(keys, rows):
            out = []
            for v in arg(keys, rows):
                if v is None:
                    logger.error_logger("unwrap: value is None")
                    out.append(ERROR)
                else:
                    out.append(v)
            return out

        return run_unwrap

    if isinstance(expr, FillErrorExpression):
        arg = compile_batch(expr._expr, ctx)
        repl = compile_batch(expr._replacement, ctx)

        def run_fill_error(keys, rows):
            vals = arg(keys, rows)
            idx = [i for i, v in enumerate(vals) if _is_err(v)]
            if idx:
                sub_keys = [keys[i] for i in idx]
                sub_rows = tuple([inp[i] for i in idx] for inp in rows)
                for i, v in zip(idx, repl(sub_keys, sub_rows)):
                    vals[i] = v
            return vals

        return run_fill_error

    if isinstance(expr, PointerExpression):
        progs = [compile_batch(a, ctx) for a in expr._args]
        instance_prog = (
            compile_batch(expr._instance, ctx) if expr._instance is not None else None
        )
        optional = expr._optional

        def run_pointer(keys, rows):
            cols = [p(keys, rows) for p in progs]
            instances = (
                instance_prog(keys, rows) if instance_prog is not None else None
            )
            out = []
            for i, vals in enumerate(zip(*cols) if cols else [()] * len(keys)):
                inst = instances[i] if instances is not None else None
                out.append(ref_scalar(*vals, optional=optional, instance=inst))
            return out

        return run_pointer

    if isinstance(expr, MethodCallExpression):
        progs = [compile_batch(a, ctx) for a in expr._args]
        fun = expr._fun
        propagate_none = expr._propagate_none
        logger = ctx
        name = expr._method

        def run_method(keys, rows):
            cols = [p(keys, rows) for p in progs]
            out = []
            for vals in zip(*cols):
                if any(_is_err(v) for v in vals):
                    out.append(ERROR)
                    continue
                if propagate_none and vals and vals[0] is None:
                    out.append(None)
                    continue
                try:
                    out.append(fun(*vals))
                except Exception as exc:  # noqa: BLE001
                    logger.error_logger(f"{name}: {type(exc).__name__}: {exc}")
                    out.append(ERROR)
            return out

        return run_method

    if isinstance(expr, ReducerExpression):
        raise TypeError(
            "a reducer can only be used inside groupby(...).reduce(...)"
        )

    raise TypeError(f"cannot compile expression of type {type(expr).__name__}")


_SENTINEL = object()


def _compile_apply(expr: ApplyExpression, ctx: EvalContext) -> BatchProgram:
    progs = [compile_batch(a, ctx) for a in expr._args]
    kwarg_names = list(expr._kwargs.keys())
    kwarg_progs = [compile_batch(v, ctx) for v in expr._kwargs.values()]
    fun = expr._fun
    propagate_none = expr._propagate_none
    max_batch_size = expr._max_batch_size
    is_async = expr._is_async
    logger = ctx

    def run_apply(keys, rows):
        n = len(keys)
        arg_cols = [p(keys, rows) for p in progs]
        kwarg_cols = [p(keys, rows) for p in kwarg_progs]
        out: List[Any] = [None] * n
        live: List[int] = []
        for i in range(n):
            vals = [c[i] for c in arg_cols] + [c[i] for c in kwarg_cols]
            if any(_is_err(v) for v in vals):
                out[i] = ERROR
            elif propagate_none and any(v is None for v in vals):
                out[i] = None
            else:
                live.append(i)
        if not live:
            return out

        if is_async:
            results = _run_async_batch(
                fun,
                [
                    (
                        tuple(c[i] for c in arg_cols),
                        {k: c[i] for k, c in zip(kwarg_names, kwarg_cols)},
                    )
                    for i in live
                ],
                logger,
            )
            for i, r in zip(live, results):
                out[i] = r
            return out

        if max_batch_size is not None:
            if _qtrace.ENABLED:
                # query spans through a batched UDF (an LLM's generate
                # calls on /v2/answer): the batch's first start, and
                # below its last end
                _qtrace.tracker().mark_keys(keys, "udf_start", latest=True)
            chunks = [
                live[start : start + max_batch_size]
                for start in range(0, len(live), max_batch_size or len(live))
            ]

            def _chunk_inputs(chunk):
                return (
                    [[c[i] for i in chunk] for c in arg_cols],
                    {
                        k: [c[i] for i in chunk]
                        for k, c in zip(kwarg_names, kwarg_cols)
                    },
                )

            def _assign(chunk, res):
                if len(res) != len(chunk):
                    raise ValueError(
                        f"batched UDF returned {len(res)} results "
                        f"for {len(chunk)} rows"
                    )
                for i, r in zip(chunk, res):
                    out[i] = r

            def _chunk_error(chunk, exc):
                logger.error_logger(_udf_error_message(exc))
                for i in chunk:
                    out[i] = ERROR

            submit = getattr(fun, "submit_batch", None)
            awaitf = getattr(fun, "await_batch", None)
            if (
                submit is not None
                and awaitf is not None
                and len(chunks) > 1
                and _pipeline_enabled()
            ):
                # two-phase async batched UDF (device-pipelined embedders):
                # submit every chunk first — each submit tokenizes and
                # enqueues an async device dispatch — then await in order,
                # overlapping chunk i+1's host prep with chunk i's device
                # execution. Same chunk boundaries and same computation as
                # the sync loop below, so results are identical.
                handles = []
                for chunk in chunks:
                    batch_args, batch_kwargs = _chunk_inputs(chunk)
                    try:
                        handles.append(
                            (chunk, submit(*batch_args, **batch_kwargs), None)
                        )
                    except Exception as exc:  # noqa: BLE001
                        handles.append((chunk, None, exc))
                for chunk, handle, exc in handles:
                    if exc is None:
                        try:
                            _assign(chunk, awaitf(handle))
                            continue
                        except Exception as a_exc:  # noqa: BLE001
                            exc = a_exc
                    _chunk_error(chunk, exc)
                if _qtrace.ENABLED:
                    _qtrace.tracker().mark_keys(keys, "udf_end", latest=True)
                return out

            # batched sync UDF: fun receives column lists, returns a column
            for chunk in chunks:
                batch_args, batch_kwargs = _chunk_inputs(chunk)
                try:
                    _assign(chunk, fun(*batch_args, **batch_kwargs))
                except Exception as exc:  # noqa: BLE001
                    _chunk_error(chunk, exc)
            if _qtrace.ENABLED:
                _qtrace.tracker().mark_keys(keys, "udf_end", latest=True)
            return out

        for i in live:
            args = tuple(c[i] for c in arg_cols)
            kwargs = {k: c[i] for k, c in zip(kwarg_names, kwarg_cols)}
            try:
                out[i] = fun(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001
                logger.error_logger(_udf_error_message(exc))
                out[i] = ERROR
        return out

    if _sanitizer.ACTIVE:
        # arming happens in runner.run before node build, so every apply
        # program of a sanitized run compiles through here.  The wrapper
        # re-checks the hashing flag at call time: it only turns on when
        # operator snapshots are configured (nothing replays otherwise).
        udf_name = getattr(fun, "__qualname__", None) or getattr(
            fun, "__name__", repr(fun)
        )

        def run_apply_sanitized(keys, rows):
            out = run_apply(keys, rows)
            t = _sanitizer.tracker()
            if t.hashing:
                t.note_udf_batch(udf_name, keys, out)
            return out

        return run_apply_sanitized

    return run_apply


def _run_async_batch(fun, calls, logger) -> List[Any]:
    """Run async UDF calls concurrently within the batch (reference:
    async UDF executor, internals/udfs/executors.py)."""
    import asyncio

    async def runner():
        async def one(args, kwargs):
            try:
                return await fun(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001
                logger.error_logger(f"async udf: {type(exc).__name__}: {exc}")
                return ERROR

        return await asyncio.gather(*(one(a, k) for a, k in calls))

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop is not None:
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            return pool.submit(lambda: asyncio.run(runner())).result()
    return asyncio.run(runner())


def _make_caster(target: dt.DType) -> Callable[[Any], Any]:
    target = dt.unoptionalize(target)
    if target is dt.INT:
        return int
    if target is dt.FLOAT:
        return float
    if target is dt.BOOL:
        return bool
    if target is dt.STR:
        from pathway_tpu_torch.internals.expression import _to_string

        return _to_string
    return lambda v: v


def _convert_one(v, default, target: dt.DType, unwrap: bool, logger) -> Any:
    if _is_err(v):
        return ERROR
    target = dt.unoptionalize(target)
    if isinstance(v, Json):
        if v.value is None:
            return default
        if target is dt.INT:
            r = v.as_int()
        elif target is dt.FLOAT:
            r = v.as_float()
        elif target is dt.STR:
            r = v.as_str()
        elif target is dt.BOOL:
            r = v.as_bool()
        else:
            r = v
        if r is None:
            if default is not None or not unwrap:
                return default
            logger.error_logger(f"cannot convert {v!r} to {target!r}")
            return ERROR
        return r
    if v is None:
        return default
    try:
        return _make_caster(target)(v)
    except Exception as exc:  # noqa: BLE001
        logger.error_logger(f"convert: {type(exc).__name__}: {exc}")
        return ERROR


def _udf_error_message(exc: BaseException) -> str:
    """Error text citing the user's own source line (reference:
    internals/trace.py re-attachment of user frames to engine errors)."""
    msg = f"udf: {type(exc).__name__}: {exc}"
    try:
        from pathway_tpu_torch.internals.trace import trace_from_exception

        tr = trace_from_exception(exc)
        if tr is not None:
            msg += f" (at {tr})"
    except Exception:  # noqa: BLE001
        pass
    return msg
