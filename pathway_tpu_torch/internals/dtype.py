"""Data type lattice for the Table DSL.

>>> from pathway_tpu_torch.internals import dtype as dt
>>> dt.wrap(int)
int
>>> dt.types_lca(dt.INT, dt.FLOAT)
float

TPU-native rebuild of the reference's dtype system (reference:
python/pathway/internals/dtype.py, src/engine/value.rs:510). Types map 1:1 onto
engine value representations; numeric columns additionally carry a numpy/JAX
dtype so the columnar engine and the XLA data plane can exchange buffers
without conversion.
"""

from __future__ import annotations

import datetime
import typing
from typing import Any, Callable, Iterable, Mapping, Optional, Tuple, Union

import numpy as np


class DType:
    """Base of all Pathway-TPU dtypes. Instances are interned singletons."""

    _name: str

    def __repr__(self) -> str:
        return self._name

    def is_value_compatible(self, value: Any) -> bool:
        raise NotImplementedError

    @property
    def typehint(self) -> Any:
        return Any

    # numpy dtype for columnar storage; None => object column
    @property
    def np_dtype(self) -> Optional[np.dtype]:
        return None

    def equivalent_to(self, other: "DType") -> bool:
        return self is other or other is ANY


class _SimpleDType(DType):
    def __init__(self, name: str, py_types: tuple, typehint: Any, np_dtype=None):
        self._name = name
        self._py_types = py_types
        self._typehint = typehint
        self._np = np.dtype(np_dtype) if np_dtype is not None else None

    def is_value_compatible(self, value: Any) -> bool:
        if self is FLOAT and isinstance(value, int) and not isinstance(value, bool):
            return True
        if self is INT and isinstance(value, bool):
            return False
        if isinstance(value, np.generic):
            value = value.item()
        return isinstance(value, self._py_types)

    @property
    def typehint(self) -> Any:
        return self._typehint

    @property
    def np_dtype(self) -> Optional[np.dtype]:
        return self._np


class _AnyDType(DType):
    _name = "Any"

    def is_value_compatible(self, value: Any) -> bool:
        return True

    def equivalent_to(self, other: DType) -> bool:
        return True


class _NoneDType(DType):
    _name = "None"

    def is_value_compatible(self, value: Any) -> bool:
        return value is None

    @property
    def typehint(self) -> Any:
        return type(None)


ANY = _AnyDType()
NONE = _NoneDType()
INT = _SimpleDType("int", (int,), int, np.int64)
FLOAT = _SimpleDType("float", (int, float), float, np.float64)
BOOL = _SimpleDType("bool", (bool,), bool, np.bool_)
STR = _SimpleDType("str", (str,), str)
BYTES = _SimpleDType("bytes", (bytes,), bytes)
DATE_TIME_NAIVE = _SimpleDType("DateTimeNaive", (datetime.datetime,), datetime.datetime)
DATE_TIME_UTC = _SimpleDType("DateTimeUtc", (datetime.datetime,), datetime.datetime)
DURATION = _SimpleDType("Duration", (datetime.timedelta,), datetime.timedelta)


class _PointerDType(DType):
    _name = "Pointer"

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.engine.value import Pointer

        return isinstance(value, Pointer)


POINTER = _PointerDType()


class _JsonDType(DType):
    _name = "Json"

    def is_value_compatible(self, value: Any) -> bool:
        return True


JSON = _JsonDType()


class _ErrorDType(DType):
    _name = "Error"

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.engine.value import Error

        return isinstance(value, Error)


ERROR = _ErrorDType()


class Optionalized(DType):
    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        self._name = f"Optional({wrapped!r})"

    def is_value_compatible(self, value: Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)

    @property
    def typehint(self) -> Any:
        return Optional[self.wrapped.typehint]

    def equivalent_to(self, other: DType) -> bool:
        if other is ANY:
            return True
        return isinstance(other, Optionalized) and self.wrapped.equivalent_to(
            other.wrapped
        )


_optional_cache: dict = {}


def Optionalize(dtype: DType) -> DType:
    """Optional(T). Optional(Any) == Any, Optional(Optional(T)) == Optional(T)."""
    if dtype is ANY or isinstance(dtype, Optionalized) or dtype is NONE:
        return dtype
    if dtype not in _optional_cache:
        _optional_cache[dtype] = Optionalized(dtype)
    return _optional_cache[dtype]


def unoptionalize(dtype: DType) -> DType:
    return dtype.wrapped if isinstance(dtype, Optionalized) else dtype


def is_optional(dtype: DType) -> bool:
    return isinstance(dtype, Optionalized) or dtype is ANY or dtype is NONE


class TupleDType(DType):
    def __init__(self, args: Tuple[DType, ...]):
        self.args = args
        self._name = f"tuple[{', '.join(map(repr, args))}]"

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, tuple) or len(value) != len(self.args):
            return False
        return all(a.is_value_compatible(v) for a, v in zip(self.args, value))


class ListDType(DType):
    def __init__(self, arg: DType):
        self.arg = arg
        self._name = f"list[{arg!r}]"

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list)) and all(
            self.arg.is_value_compatible(v) for v in value
        )


ANY_TUPLE = ListDType(ANY)


class ArrayDType(DType):
    """N-dimensional numeric array (numpy on host, torch on device)."""

    def __init__(self, n_dim: Optional[int] = None, wrapped: DType = ANY):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, np.ndarray) or hasattr(value, "__array__")


ANY_ARRAY = ArrayDType()
INT_ARRAY = ArrayDType(wrapped=INT)
FLOAT_ARRAY = ArrayDType(wrapped=FLOAT)


class CallableDType(DType):
    def __init__(self, arg_types, return_type):
        self.arg_types = arg_types
        self.return_type = return_type
        self._name = f"Callable(..., {return_type!r})"

    def is_value_compatible(self, value: Any) -> bool:
        return callable(value)


class PyObjectWrapperDType(DType):
    _name = "PyObjectWrapper"

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.engine.value import PyObjectWrapper

        return isinstance(value, PyObjectWrapper)


PY_OBJECT_WRAPPER = PyObjectWrapperDType()


class FutureDType(DType):
    """Column whose values may still be Pending (fully-async UDF results)."""

    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        self._name = f"Future({wrapped!r})"

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.engine.value import Pending

        return value is Pending or self.wrapped.is_value_compatible(value)


def Future(dtype: DType) -> DType:
    if isinstance(dtype, FutureDType):
        return dtype
    return FutureDType(dtype)


def wrap(input_type: Any) -> DType:
    """Map a python typehint (or dtype) to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type is None or input_type is type(None):
        return NONE
    if input_type is int:
        return INT
    if input_type is float:
        return FLOAT
    if input_type is bool:
        return BOOL
    if input_type is str:
        return STR
    if input_type is bytes:
        return BYTES
    if input_type is Any or input_type is typing.Any:
        return ANY
    if input_type is datetime.datetime:
        return DATE_TIME_NAIVE
    if input_type is datetime.timedelta:
        return DURATION
    if input_type is np.ndarray:
        return ANY_ARRAY
    from pathway_tpu_torch.engine.value import Json, Pointer, PyObjectWrapper

    if isinstance(input_type, type):
        if issubclass(input_type, Pointer):
            return POINTER
        if issubclass(input_type, Json):
            return JSON
        if issubclass(input_type, PyObjectWrapper):
            return PY_OBJECT_WRAPPER
        if issubclass(input_type, np.ndarray):
            return ANY_ARRAY
        if issubclass(input_type, datetime.datetime):
            return DATE_TIME_NAIVE
        if issubclass(input_type, datetime.timedelta):
            return DURATION
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    if origin is Union:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == len(args):
            return ANY
        if len(non_none) == 1:
            return Optionalize(wrap(non_none[0]))
        return ANY
    if origin in (tuple, typing.Tuple):
        if len(args) == 2 and args[1] is Ellipsis:
            return ListDType(wrap(args[0]))
        if args:
            return TupleDType(tuple(wrap(a) for a in args))
        return ANY_TUPLE
    if origin in (list, typing.List):
        return ListDType(wrap(args[0])) if args else ANY_TUPLE
    if origin is typing.Callable or origin is getattr(
        __import__("collections.abc", fromlist=["Callable"]), "Callable", None
    ):
        if args:
            return CallableDType(
                tuple(wrap(a) for a in args[:-1]) if args[:-1] else (),
                wrap(args[-1]),
            )
        return CallableDType((), ANY)
    if origin is np.ndarray:
        return ANY_ARRAY
    return ANY


def unwrap_hint(dtype: DType) -> Any:
    return dtype.typehint


_NUMERIC_ORDER = {BOOL: 0, INT: 1, FLOAT: 2}


def types_lca(a: DType, b: DType) -> DType:
    """Least common ancestor in the dtype lattice (used by if_else, concat,
    coalesce). Mirrors reference dtype.py types_lca semantics."""
    if a is b:
        return a
    if a is ANY or b is ANY:
        return ANY
    if a is NONE:
        return Optionalize(b)
    if b is NONE:
        return Optionalize(a)
    if isinstance(a, Optionalized) or isinstance(b, Optionalized):
        core = types_lca(unoptionalize(a), unoptionalize(b))
        return Optionalize(core)
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        if {a, b} == {INT, FLOAT}:
            return FLOAT
        return ANY if a is not b else a
    if isinstance(a, (TupleDType, ListDType)) and isinstance(
        b, (TupleDType, ListDType)
    ):
        return ANY_TUPLE
    if isinstance(a, ArrayDType) and isinstance(b, ArrayDType):
        return ANY_ARRAY
    return ANY


def coerce_value(value: Any, dtype: DType) -> Any:
    """Best-effort runtime coercion used by connectors and static tables."""
    if value is None:
        return None
    if dtype is FLOAT and isinstance(value, int):
        return float(value)
    if isinstance(dtype, Optionalized):
        return coerce_value(value, dtype.wrapped)
    return value
