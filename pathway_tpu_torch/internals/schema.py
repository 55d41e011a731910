"""Schema: typed column layout of a Table.

>>> import pathway_tpu_torch as pw
>>> S = pw.schema_from_types(name=str, age=int)
>>> S.column_names()
['name', 'age']
>>> S.typehints()["age"]
<class 'int'>

TPU-native rebuild of the reference schema system (reference:
python/pathway/internals/schema.py). Schemas are declared with class syntax::

    class InputSchema(pw.Schema):
        name: str
        age: int = pw.column_definition(primary_key=True)

or built programmatically with `schema_from_types` / `schema_builder`.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Type

from pathway_tpu_torch.internals import dtype as dt

_no_default = object()


@dataclass(frozen=True)
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = _no_default
    dtype: Any = None
    name: str | None = None
    append_only: bool | None = None

    @property
    def has_default(self) -> bool:
        return self.default_value is not _no_default


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _no_default,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    """Column properties inside a Schema class (reference: schema.py
    column_definition)."""
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=default_value,
        dtype=dtype,
        name=name,
        append_only=append_only,
    )


@dataclass
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = _no_default
    append_only: bool = False

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _no_default


class SchemaProperties:
    def __init__(self, append_only: bool = False):
        self.append_only = append_only


class SchemaMetaclass(type):
    __columns__: Dict[str, ColumnSchema]
    __universe_properties__: SchemaProperties

    def __new__(
        mcls,
        name,
        bases,
        namespace,
        append_only: bool | None = None,
        primary_key=None,
    ):
        return super().__new__(mcls, name, bases, namespace)

    def __init__(
        cls,
        name,
        bases,
        namespace,
        append_only: bool | None = None,
        primary_key=None,
    ):
        super().__init__(name, bases, namespace)
        # class-level primary_key=["col", ...] kwarg (reference:
        # pw.Schema class syntax, internals/schema.py)
        pk_cols = set(primary_key or ())
        columns: Dict[str, ColumnSchema] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = {}
        for klass in reversed(cls.__mro__):
            hints.update(getattr(klass, "__annotations__", {}) or {})
        localns = dict(vars(typing))
        for col_name, hint in hints.items():
            if col_name.startswith("__"):
                continue
            if isinstance(hint, str):
                try:
                    hint = eval(hint, globals(), localns)  # noqa: S307
                except Exception:
                    hint = Any
            definition = namespace.get(col_name, None)
            if not isinstance(definition, ColumnDefinition):
                for base in bases:
                    maybe = getattr(base, "__column_definitions__", {}).get(col_name)
                    if maybe is not None:
                        definition = maybe
                        break
            if not isinstance(definition, ColumnDefinition):
                definition = ColumnDefinition()
            dtype = (
                dt.wrap(definition.dtype)
                if definition.dtype is not None
                else dt.wrap(hint)
            )
            out_name = definition.name or col_name
            columns[out_name] = ColumnSchema(
                name=out_name,
                dtype=dtype,
                primary_key=definition.primary_key or out_name in pk_cols,
                default_value=definition.default_value,
                append_only=bool(
                    definition.append_only
                    if definition.append_only is not None
                    else append_only
                ),
            )
        unknown_pk = pk_cols - set(columns)
        if unknown_pk:
            raise ValueError(
                f"primary_key columns {sorted(unknown_pk)} are not columns "
                f"of schema {name} (has {sorted(columns)})"
            )
        cls.__columns__ = columns
        cls.__column_definitions__ = {
            k: v for k, v in namespace.items() if isinstance(v, ColumnDefinition)
        }
        cls.__universe_properties__ = SchemaProperties(append_only=bool(append_only))

    def columns(cls) -> Dict[str, ColumnSchema]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def keys(cls):
        return cls.__columns__.keys()

    def __getitem__(cls, name: str) -> ColumnSchema:
        return cls.__columns__[name]

    def typehints(cls) -> Dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls.__columns__.items()}

    def dtypes(cls) -> Dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pk = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pk or None

    def default_values(cls) -> Dict[str, Any]:
        return {
            n: c.default_value
            for n, c in cls.__columns__.items()
            if c.has_default_value
        }

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = {**cls.__columns__, **other.__columns__}
        return schema_from_columns(columns, name=f"{cls.__name__}|{other.__name__}")

    def with_types(cls, **kwargs) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, hint in kwargs.items():
            if name not in columns:
                raise ValueError(f"column {name!r} not present in schema")
            old = columns[name]
            columns[name] = ColumnSchema(
                name=name,
                dtype=dt.wrap(hint),
                primary_key=old.primary_key,
                default_value=old.default_value,
                append_only=old.append_only,
            )
        return schema_from_columns(columns, name=cls.__name__)

    def without(cls, *names) -> "SchemaMetaclass":
        drop = {n if isinstance(n, str) else n.name for n in names}
        columns = {k: v for k, v in cls.__columns__.items() if k not in drop}
        return schema_from_columns(columns, name=cls.__name__)

    def update_properties(cls, **kwargs) -> "SchemaMetaclass":
        out = schema_from_columns(dict(cls.__columns__), name=cls.__name__)
        if "append_only" in kwargs:
            out.__universe_properties__ = SchemaProperties(
                append_only=kwargs["append_only"]
            )
        return out

    def universe_properties(cls) -> SchemaProperties:
        return cls.__universe_properties__

    def __repr__(cls):
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({cols})>"

    def assert_matches_schema(
        cls,
        other: "SchemaMetaclass",
        *,
        allow_superset: bool = True,
        ignore_primary_keys: bool = True,
    ) -> None:
        for name, col in cls.__columns__.items():
            if name not in other.__columns__:
                raise AssertionError(f"column {name!r} missing")
            if not col.dtype.equivalent_to(other.__columns__[name].dtype):
                raise AssertionError(
                    f"column {name!r}: {col.dtype!r} != "
                    f"{other.__columns__[name].dtype!r}"
                )
        if not allow_superset:
            extra = set(other.__columns__) - set(cls.__columns__)
            if extra:
                raise AssertionError(f"unexpected columns: {extra}")


class Schema(metaclass=SchemaMetaclass):
    """Base class for user schemas (reference: pw.Schema)."""

    def __init_subclass__(cls, **kwargs):
        # class kwargs (append_only, primary_key) are consumed by the
        # metaclass; swallow them here so type.__init_subclass__ is happy
        super().__init_subclass__()


def schema_from_columns(
    columns: Mapping[str, ColumnSchema], name: str = "AnonymousSchema"
) -> Type[Schema]:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "AnonymousSchema", **kwargs: Any) -> Type[Schema]:
    """schema_from_types(x=int, y=str) (reference: schema.py
    schema_from_types)."""
    columns = {
        n: ColumnSchema(name=n, dtype=dt.wrap(hint)) for n, hint in kwargs.items()
    }
    return schema_from_columns(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str = "AnonymousSchema"
) -> Type[Schema]:
    out: Dict[str, ColumnSchema] = {}
    for col_name, spec in columns.items():
        if isinstance(spec, ColumnDefinition):
            out[col_name] = ColumnSchema(
                name=col_name,
                dtype=dt.wrap(spec.dtype) if spec.dtype is not None else dt.ANY,
                primary_key=spec.primary_key,
                default_value=spec.default_value,
            )
        elif isinstance(spec, dict):
            out[col_name] = ColumnSchema(
                name=col_name,
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _no_default),
            )
        else:
            out[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(spec))
    return schema_from_columns(out, name=name)


class SchemaBuilderSentinel:
    pass


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str = "AnonymousSchema",
    properties: SchemaProperties | None = None,
) -> Type[Schema]:
    out: Dict[str, ColumnSchema] = {}
    for col_name, definition in columns.items():
        out[col_name] = ColumnSchema(
            name=definition.name or col_name,
            dtype=dt.wrap(definition.dtype) if definition.dtype is not None else dt.ANY,
            primary_key=definition.primary_key,
            default_value=definition.default_value,
        )
    schema = schema_from_columns(out, name=name)
    if properties is not None:
        schema.__universe_properties__ = properties
    return schema


def schema_from_pandas(
    df, *, id_from: list[str] | None = None, name: str = "PandasSchema"
) -> Type[Schema]:
    import numpy as np
    import pandas as pd

    columns: Dict[str, ColumnSchema] = {}
    for col in df.columns:
        series = df[col]
        kind = series.dtype.kind
        if kind == "i":
            dtype: dt.DType = dt.INT
        elif kind == "f":
            dtype = dt.FLOAT
        elif kind == "b":
            dtype = dt.BOOL
        elif kind == "M":
            dtype = (
                dt.DATE_TIME_UTC
                if getattr(series.dtype, "tz", None) is not None
                else dt.DATE_TIME_NAIVE
            )
        elif kind == "m":
            dtype = dt.DURATION
        elif kind == "O":
            # the NaN check (v == v) is only valid for scalars; ndarray
            # cells (e.g. embedding columns) are never NaN-markers
            def _not_nan(v):
                if v is None:
                    return False
                try:
                    return bool(v == v)
                except (ValueError, TypeError):
                    return True

            non_null = [v for v in series if _not_nan(v)]
            py_types = {type(v) for v in non_null}
            if py_types == {str}:
                dtype = dt.STR
            elif py_types == {bytes}:
                dtype = dt.BYTES
            elif py_types <= {int, bool}:
                dtype = dt.INT if py_types == {int} else dt.BOOL
            elif py_types <= {int, float}:
                dtype = dt.FLOAT
            else:
                dtype = dt.ANY
            if len(non_null) < len(series):
                dtype = dt.Optionalize(dtype)
        else:
            dtype = dt.ANY
        columns[str(col)] = ColumnSchema(
            name=str(col),
            dtype=dtype,
            primary_key=bool(id_from and col in id_from),
        )
    return schema_from_columns(columns, name=name)


def schema_from_csv(
    path: str,
    *,
    name: str = "CsvSchema",
    properties: SchemaProperties | None = None,
    delimiter: str = ",",
    comment_character: str | None = None,
    escape: str | None = None,
    quote: str = '"',
    enforce_dtypes: bool = True,
    num_parsed_rows: int | None = None,
) -> Type[Schema]:
    import pandas as pd

    df = pd.read_csv(
        path,
        sep=delimiter,
        comment=comment_character,
        escapechar=escape,
        quotechar=quote,
        nrows=num_parsed_rows,
    )
    return schema_from_pandas(df, name=name)


def is_subschema(left: Type[Schema], right: Type[Schema]) -> bool:
    for name, col in left.__columns__.items():
        if name not in right.__columns__:
            return False
    return True
