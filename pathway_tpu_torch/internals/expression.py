"""Column expression trees.

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... a
... 5
... ''')
>>> pw.debug.compute_and_print(
...     t.select(b=(pw.this.a * 2 + 1) % 4), include_id=False
... )
b
3

TPU-native rebuild of the reference expression DSL (reference:
python/pathway/internals/expression.py, src/engine/expression.rs). Expressions
are built lazily from column references and constants; the engine compiles
them either to vectorized numpy/JAX column programs (numeric hot path) or to
per-row python closures (general path). See
pathway_tpu_torch/engine/expression_eval.py.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Iterable, Mapping, Optional, Tuple

from pathway_tpu_torch.internals import dtype as dt


class ColumnExpression:
    """Base class of all expressions (reference: expression.py
    ColumnExpression)."""

    _dtype_hint: dt.DType | None = None

    # -- arithmetic -------------------------------------------------------
    def __add__(self, other):
        return BinaryOpExpression("+", self, other)

    def __radd__(self, other):
        return BinaryOpExpression("+", other, self)

    def __sub__(self, other):
        return BinaryOpExpression("-", self, other)

    def __rsub__(self, other):
        return BinaryOpExpression("-", other, self)

    def __mul__(self, other):
        return BinaryOpExpression("*", self, other)

    def __rmul__(self, other):
        return BinaryOpExpression("*", other, self)

    def __truediv__(self, other):
        return BinaryOpExpression("/", self, other)

    def __rtruediv__(self, other):
        return BinaryOpExpression("/", other, self)

    def __floordiv__(self, other):
        return BinaryOpExpression("//", self, other)

    def __rfloordiv__(self, other):
        return BinaryOpExpression("//", other, self)

    def __mod__(self, other):
        return BinaryOpExpression("%", self, other)

    def __rmod__(self, other):
        return BinaryOpExpression("%", other, self)

    def __pow__(self, other):
        return BinaryOpExpression("**", self, other)

    def __rpow__(self, other):
        return BinaryOpExpression("**", other, self)

    def __matmul__(self, other):
        return BinaryOpExpression("@", self, other)

    def __rmatmul__(self, other):
        return BinaryOpExpression("@", other, self)

    def __lshift__(self, other):
        return BinaryOpExpression("<<", self, other)

    def __rshift__(self, other):
        return BinaryOpExpression(">>", self, other)

    def __neg__(self):
        return UnaryOpExpression("-", self)

    def __abs__(self):
        return UnaryOpExpression("abs", self)

    # -- comparisons ------------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return BinaryOpExpression("==", self, other)

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOpExpression("!=", self, other)

    def __lt__(self, other):
        return BinaryOpExpression("<", self, other)

    def __le__(self, other):
        return BinaryOpExpression("<=", self, other)

    def __gt__(self, other):
        return BinaryOpExpression(">", self, other)

    def __ge__(self, other):
        return BinaryOpExpression(">=", self, other)

    # -- boolean ----------------------------------------------------------
    def __and__(self, other):
        return BinaryOpExpression("&", self, other)

    def __rand__(self, other):
        return BinaryOpExpression("&", other, self)

    def __or__(self, other):
        return BinaryOpExpression("|", self, other)

    def __ror__(self, other):
        return BinaryOpExpression("|", other, self)

    def __xor__(self, other):
        return BinaryOpExpression("^", self, other)

    def __rxor__(self, other):
        return BinaryOpExpression("^", other, self)

    def __invert__(self):
        return UnaryOpExpression("~", self)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "Cannot use a ColumnExpression in a boolean context; "
            "use & | ~ instead of and/or/not, and pw.if_else for branching"
        )

    # -- item access ------------------------------------------------------
    def __getitem__(self, item):
        return GetExpression(self, item, check_if_exists=True)

    def get(self, item, default=None):
        return GetExpression(self, item, default=default, check_if_exists=False)

    # -- misc methods (parity with reference ColumnExpression methods) ----
    def is_none(self):
        return IsNoneExpression(self, positive=True)

    def is_not_none(self):
        return IsNoneExpression(self, positive=False)

    def to_string(self):
        return MethodCallExpression("to_string", self)

    def as_int(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(dt.INT, self, default=default, unwrap=unwrap)

    def as_float(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(dt.FLOAT, self, default=default, unwrap=unwrap)

    def as_str(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(dt.STR, self, default=default, unwrap=unwrap)

    def as_bool(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(dt.BOOL, self, default=default, unwrap=unwrap)

    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions_dt import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions_str import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions_num import NumericalNamespace

        return NumericalNamespace(self)

    def _deps(self) -> tuple["ColumnExpression", ...]:
        return ()

    def __repr__(self):
        from pathway_tpu_torch.internals.expression_printer import print_expression

        return print_expression(self)


ColumnExpressionOrValue = Any


def smart_wrap(arg: Any) -> ColumnExpression:
    if isinstance(arg, ColumnExpression):
        return arg
    from pathway_tpu_torch.internals.table import Table

    if isinstance(arg, Table):
        raise TypeError(
            "a Table cannot be used as an expression; use a column reference"
        )
    return ColumnConstExpression(arg)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def _deps(self):
        return ()


class ColumnReference(ColumnExpression):
    """Reference to a column of a concrete table: `t.colname` (reference:
    expression.py ColumnReference)."""

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def _deps(self):
        return ()

    def __call__(self, *args, **kwargs):
        # method columns (row transformers' @method) hold a callable per
        # row; `t.c(10)` applies it row-wise (reference:
        # row_transformer.py method_call_transformer). Any other column
        # keeps the build-time misuse error.
        col = self._table._schema.columns().get(self._name)
        col_dtype = dt.unoptionalize(col.dtype) if col is not None else None
        if not isinstance(col_dtype, dt.CallableDType):
            raise TypeError(
                f"column {self._name!r} is not callable; "
                "did you mean pw.apply(fun, ...)?"
            )
        if kwargs:
            raise TypeError("method columns take positional arguments only")
        from pathway_tpu_torch.internals.api import apply_with_type

        return apply_with_type(
            lambda f, *a: f(*a), col_dtype.return_type, self, *args
        )


class ThisColumnReference(ColumnExpression):
    """`pw.this.colname` — bound to a concrete table at desugaring time."""

    def __init__(self, this, name: str):
        self._this = this
        self._name = name

    @property
    def name(self) -> str:
        return self._name


class IdReference(ColumnReference):
    """`t.id` — the key column."""

    def __init__(self, table):
        super().__init__(table, "id")


class BinaryOpExpression(ColumnExpression):
    def __init__(self, op: str, left, right):
        self._op = op
        self._left = smart_wrap(left)
        self._right = smart_wrap(right)

    def _deps(self):
        return (self._left, self._right)


class UnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, arg):
        self._op = op
        self._arg = smart_wrap(arg)

    def _deps(self):
        return (self._arg,)


class IsNoneExpression(ColumnExpression):
    def __init__(self, arg, positive: bool):
        self._arg = smart_wrap(arg)
        self._positive = positive

    def _deps(self):
        return (self._arg,)


class IfElseExpression(ColumnExpression):
    def __init__(self, if_, then, else_):
        self._if = smart_wrap(if_)
        self._then = smart_wrap(then)
        self._else = smart_wrap(else_)

    def _deps(self):
        return (self._if, self._then, self._else)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        if not args:
            raise TypeError("coalesce requires at least one argument")
        self._args = tuple(smart_wrap(a) for a in args)

    def _deps(self):
        return self._args


class RequireExpression(ColumnExpression):
    """Evaluates val only if all args are not-None, else None."""

    def __init__(self, val, *args):
        self._val = smart_wrap(val)
        self._args = tuple(smart_wrap(a) for a in args)

    def _deps(self):
        return (self._val, *self._args)


class CastExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr):
        self._target = target
        self._expr = smart_wrap(expr)

    def _deps(self):
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    """Json <-> scalar conversion with optional default (reference:
    engine.pyi `convert`)."""

    def __init__(self, target: dt.DType, expr, default=None, unwrap: bool = False):
        self._target = target
        self._expr = smart_wrap(expr)
        self._default = smart_wrap(default)
        self._unwrap = unwrap

    def _deps(self):
        return (self._expr, self._default)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, target: dt.DType, expr):
        self._target = target
        self._expr = smart_wrap(expr)

    def _deps(self):
        return (self._expr,)


class ApplyExpression(ColumnExpression):
    """pw.apply / UDF call (reference: expression.py ApplyExpression)."""

    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        *args,
        propagate_none: bool = False,
        deterministic: bool = False,
        max_batch_size: int | None = None,
        is_async: bool = False,
        executor=None,
        **kwargs,
    ):
        self._fun = fun
        self._return_type = dt.wrap(return_type)
        self._args = tuple(smart_wrap(a) for a in args)
        self._kwargs = {k: smart_wrap(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._max_batch_size = max_batch_size
        self._is_async = is_async
        self._executor = executor

    def _deps(self):
        return (*self._args, *self._kwargs.values())


class FullyAsyncApplyExpression(ApplyExpression):
    """pw.apply_fully_async — results arrive later as Pending→value upserts."""

    autocommit_duration_ms: int | None = 100


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(smart_wrap(a) for a in args)

    def _deps(self):
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, check_if_exists: bool = True):
        self._obj = smart_wrap(obj)
        self._index = smart_wrap(index)
        self._default = smart_wrap(default)
        self._check_if_exists = check_if_exists

    def _deps(self):
        return (self._obj, self._index, self._default)


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = smart_wrap(expr)

    def _deps(self):
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr, replacement):
        self._expr = smart_wrap(expr)
        self._replacement = smart_wrap(replacement)

    def _deps(self):
        return (self._expr, self._replacement)


class PointerExpression(ColumnExpression):
    """pw.this.pointer_from(...) — key derivation (reference: expression.py
    PointerExpression, Key::for_values)."""

    def __init__(self, table, *args, optional: bool = False, instance=None):
        self._table = table
        self._args = tuple(smart_wrap(a) for a in args)
        self._optional = optional
        self._instance = smart_wrap(instance) if instance is not None else None

    def _deps(self):
        extra = (self._instance,) if self._instance is not None else ()
        return (*self._args, *extra)


class DelayedIxRef(ColumnExpression):
    """`target.ix_ref(<consts>).col` outside any select context: the row
    set the lookup runs over is only known at desugar time (the enclosing
    select/reduce table), so the reference defers resolution via
    `thisclass.this` (reference: table.py ix — `context._delayed_op`).
    Desugaring rewrites this node into a concrete `target.ix(...)` column
    reference."""

    def __init__(self, target, ptr, optional: bool, name: str):
        self._target = target
        self._ptr = ptr
        self._optional = optional
        self._name = name

    def _deps(self):
        return ()


class _DelayedIxTable:
    """Proxy returned by `ix`/`ix_ref` with constant-only keys; column
    access produces DelayedIxRef expressions resolved during select
    desugaring."""

    def __init__(self, target, ptr, optional: bool):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_ptr", ptr)
        object.__setattr__(self, "_optional", optional)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return DelayedIxRef(self._target, self._ptr, self._optional, name)

    def __getitem__(self, name):
        return DelayedIxRef(self._target, self._ptr, self._optional, name)


class MethodCallExpression(ColumnExpression):
    """Namespace method call (`.dt.year()`, `.str.lower()`, ...). Carries its
    scalar implementation; the engine vectorizes it over batches."""

    def __init__(
        self,
        method: str,
        *args,
        fun: Callable | None = None,
        return_type: dt.DType | None = None,
        propagate_none: bool = True,
    ):
        self._method = method
        if fun is None:
            fun = _BUILTIN_METHODS[method]
        self._fun = fun
        self._args = tuple(smart_wrap(a) for a in args)
        self._return_type = return_type
        self._propagate_none = propagate_none

    def _deps(self):
        return self._args


def _to_string(v):
    if v is None:
        return "None"
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, float) and v.is_integer():
        return str(v)
    return str(v)


_BUILTIN_METHODS: dict[str, Callable] = {"to_string": _to_string}


class ReducerExpression(ColumnExpression):
    """Application of a reducer inside groupby().reduce() (reference:
    expression.py ReducerExpression, src/engine/reduce.rs)."""

    def __init__(self, reducer, *args, **kwargs):
        self._reducer = reducer
        self._args = tuple(smart_wrap(a) for a in args)
        self._kwargs = kwargs

    def _deps(self):
        return self._args


def map_refs(expr: ColumnExpression, fn):
    """Structurally copy `expr`, replacing every ColumnReference /
    IdReference node by `fn(node)` (returning the node unchanged is
    fine)."""
    import copy as _copy

    if isinstance(expr, (ColumnReference, IdReference)):
        return fn(expr)
    out = _copy.copy(expr)
    for attr, value in list(vars(expr).items()):
        if isinstance(value, ColumnExpression):
            setattr(out, attr, map_refs(value, fn))
        elif isinstance(value, tuple) and any(
            isinstance(v, ColumnExpression) for v in value
        ):
            setattr(
                out,
                attr,
                tuple(
                    map_refs(v, fn) if isinstance(v, ColumnExpression) else v
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
                    k: map_refs(v, fn) if isinstance(v, ColumnExpression) else v
                    for k, v in value.items()
                },
            )
    return out


def collect_tables_ordered(expr: ColumnExpression) -> list:
    """All concrete tables referenced by an expression tree, in
    deterministic discovery order.  Use this variant wherever the
    result feeds recorded op inputs or build operands: iterating the
    set variant below hands back id-hash order, which varies between
    otherwise identical runs and would break byte-identical builds."""
    from pathway_tpu_torch.internals.table import Table

    out: list = []
    seen: set = set()

    def _add(t):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ColumnReference):
            _add(node._table)
        if isinstance(node, PointerExpression) and node._table is not None:
            if isinstance(node._table, Table):
                _add(node._table)
        stack.extend(node._deps())
        for attr in ("_left", "_right", "_arg", "_expr", "_if", "_then", "_else"):
            child = getattr(node, attr, None)
            if isinstance(child, ColumnExpression):
                stack.append(child)
    return out


def collect_tables(expr: ColumnExpression, out: set) -> set:
    """All concrete tables referenced by an expression tree."""
    out.update(collect_tables_ordered(expr))
    return out
