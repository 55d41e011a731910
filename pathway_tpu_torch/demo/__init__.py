"""pw.demo — synthetic demo streams (reference:
python/pathway/demo/__init__.py: generate_custom_stream:28,
noisy_linear_stream:117, range_stream:164, replay_csv:211,
replay_csv_with_time:256)."""

from __future__ import annotations

import csv as csv_mod
import random
import time as time_mod
from typing import Any, Callable, Dict, Optional, Type

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
    schema_from_types,
)
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _GeneratorSubject(ConnectorSubjectBase):
    def __init__(self, value_generators, nb_rows, input_rate, autocommit_ms):
        super().__init__()
        self.value_generators = value_generators
        self.nb_rows = nb_rows
        self.input_rate = input_rate

    def run(self) -> None:
        i = 0
        while self.nb_rows is None or i < self.nb_rows:
            row = {
                name: gen(i) for name, gen in self.value_generators.items()
            }
            self.next(**row)
            self.commit()
            i += 1
            if self.input_rate:
                time_mod.sleep(1.0 / self.input_rate)


def generate_custom_stream(
    value_generators: Dict[str, Callable[[int], Any]],
    *,
    schema: Type[Schema],
    nb_rows: int | None = None,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_id: str | None = None,
    name: str | None = None,
):
    """reference: demo/__init__.py generate_custom_stream:28."""
    return connector_table(
        schema,
        lambda: _GeneratorSubject(
            value_generators, nb_rows, input_rate, autocommit_duration_ms
        ),
        mode="streaming",
        name=name,
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0, **kwargs):
    """y ≈ x with noise (reference: demo/__init__.py:117)."""
    rng = random.Random(0)
    schema = schema_from_types(x=float, y=float)
    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + rng.uniform(-1, 1),
        },
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0, **kwargs
):
    """values offset..offset+nb_rows (reference: demo/__init__.py:164)."""
    schema = schema_from_types(value=float)
    return generate_custom_stream(
        {"value": lambda i: float(i + offset)},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


class _CsvReplaySubject(ConnectorSubjectBase):
    def __init__(self, path, schema, input_rate, time_column, unit, speedup=1.0):
        super().__init__()
        self.path = path
        self.schema = schema
        self.input_rate = input_rate
        self.time_column = time_column
        self.unit = unit
        self.speedup = speedup or 1.0

    def run(self) -> None:
        div = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}.get(self.unit, 1.0)
        dtypes = self.schema.dtypes()
        prev_t = None
        with open(self.path, newline="") as fh:
            for rec in csv_mod.DictReader(fh):
                row = {}
                for name, dtype in dtypes.items():
                    raw = rec.get(name)
                    core = dt.unoptionalize(dtype)
                    if raw is None:
                        row[name] = None
                    elif core is dt.INT:
                        row[name] = int(raw)
                    elif core is dt.FLOAT:
                        row[name] = float(raw)
                    elif core is dt.BOOL:
                        row[name] = raw.lower() in ("true", "1")
                    else:
                        row[name] = raw
                if self.time_column is not None:
                    t = float(rec[self.time_column]) / div
                    if prev_t is not None and t > prev_t:
                        time_mod.sleep(min((t - prev_t) / self.speedup, 5.0))
                    prev_t = t
                elif self.input_rate:
                    time_mod.sleep(1.0 / self.input_rate)
                self.next(**row)
                self.commit()


def replay_csv(path: str, *, schema: Type[Schema], input_rate: float = 1.0):
    """reference: demo/__init__.py replay_csv:211."""
    return connector_table(
        schema,
        lambda: _CsvReplaySubject(path, schema, input_rate, None, "s"),
        mode="streaming",
    )


def replay_csv_with_time(
    path: str,
    *,
    schema: Type[Schema],
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1,
):
    """reference: demo/__init__.py replay_csv_with_time:256."""
    return connector_table(
        schema,
        lambda: _CsvReplaySubject(
            path, schema, None, time_column, unit, speedup=speedup
        ),
        mode="streaming",
    )
