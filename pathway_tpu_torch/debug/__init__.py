"""pw.debug — static tables, printing, equality assertions.

TPU-native rebuild of the reference debug utilities (reference:
python/pathway/debug/__init__.py: table_from_markdown:446,
table_from_pandas:358, compute_and_print:222,
compute_and_print_update_stream:250, table_to_pandas).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Type

from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.runner import run_tables
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
    schema_from_pandas,
)
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

_SPECIAL_TIME = "__time__"
_SPECIAL_DIFF = "__diff__"


def _parse_value(text: str):
    text = text.strip()
    if text == "" or text == "None":
        return None
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    return text


def table_from_markdown(
    table_def: str,
    *,
    id_from: List[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Type[Schema] | None = None,
    _stream: bool = False,
) -> Table:
    """Parse a markdown-ish table (reference: debug/__init__.py:446).

    Special columns: `id` fixes row keys; `__time__`/`__diff__` make the
    table a stream of timed insertions/retractions.

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... owner | pet
    ... Alice | dog
    ... Bob   | cat
    ... ''')
    >>> pw.debug.compute_and_print(t, include_id=False)
    owner | pet
    Alice | dog
    Bob   | cat
    """
    lines = [ln.strip() for ln in table_def.strip().splitlines()]
    lines = [ln for ln in lines if ln and set(ln) - set("|- ")]
    bordered = lines[0].startswith("|")
    header = [h.strip() for h in lines[0].split("|")]
    header = [h for h in header if h]
    rows = []
    for ln in lines[1:]:
        cells = [c for c in ln.split("|")]
        if bordered:
            if ln.startswith("|"):
                cells = cells[1:]
            if ln.endswith("|"):
                cells = cells[:-1]
        values = [_parse_value(c) for c in cells]
        if len(values) != len(header):
            raise ValueError(
                f"row {ln!r} has {len(values)} cells for {len(header)} columns"
            )
        rows.append(dict(zip(header, values)))
    data_cols = [
        h for h in header if h not in ("id", _SPECIAL_TIME, _SPECIAL_DIFF)
    ]
    if schema is not None:
        out_schema = schema
        dtypes = schema.dtypes()
    else:
        # infer dtypes per column from the values
        cols_schema: Dict[str, ColumnSchema] = {}
        for name in data_cols:
            col_dtype: dt.DType | None = None
            for r in rows:
                v = r[name]
                vd = _value_dtype(v)
                col_dtype = vd if col_dtype is None else dt.types_lca(col_dtype, vd)
            cols_schema[name] = ColumnSchema(name=name, dtype=col_dtype or dt.ANY)
        out_schema = schema_from_columns(cols_schema)
        dtypes = out_schema.dtypes()

    events = []
    # without explicit ids, a `-1` line must cancel the key of an earlier
    # identical `+1` line (the connector sinks match retractions the same
    # way, _connector_runtime.push_row)
    keys_by_values: Dict[tuple, list] = {}
    for i, r in enumerate(rows):
        values = tuple(
            dt.coerce_value(r.get(c), dtypes.get(c, dt.ANY)) for c in out_schema.keys()
        )
        time = int(r.get(_SPECIAL_TIME, 0) or 0)
        diff = int(r.get(_SPECIAL_DIFF, 1) or 1)
        if "id" in r:
            key = ref_scalar(r["id"])
        elif id_from:
            key = ref_scalar(*(r[c] for c in id_from))
        elif schema is not None and schema.primary_key_columns():
            key = ref_scalar(*(r[c] for c in schema.primary_key_columns()))
        elif diff < 0 and keys_by_values.get(values):
            key = keys_by_values[values].pop()
        else:
            key = ref_scalar(i)
            keys_by_values.setdefault(values, []).append(key)
        events.append((time, (key, values, diff)))

    return table_from_events(out_schema, events)


def table_from_parquet(path, id_from=None, unsafe_trusted_ids=False):
    """Read a Parquet file into a table via pandas (reference:
    debug/__init__.py table_from_parquet:476)."""
    import pandas as pd

    df = pd.read_parquet(path)
    return table_from_pandas(
        df, id_from=id_from, unsafe_trusted_ids=unsafe_trusted_ids
    )


def table_to_parquet(table, filename):
    """Write a table to a Parquet file via pandas (reference:
    debug/__init__.py table_to_parquet:493)."""
    df = table_to_pandas(table, include_id=False)
    return df.to_parquet(filename)


parse_to_table = table_from_markdown


def table_from_events(schema: Type[Schema], events) -> Table:
    def build(ctx):
        from pathway_tpu_torch.engine.engine import StaticSource, TimedSource

        if all(t == 0 for t, _ in events):
            rows = {}
            for _, (key, values, diff) in events:
                if diff > 0:
                    rows[key] = values
                else:
                    rows.pop(key, None)
            return StaticSource(ctx.engine, rows)
        return TimedSource(ctx.engine, list(events))

    return Table(schema=schema, universe=Universe(), build=build)


def table_from_rows(
    schema: Type[Schema],
    rows: list,
    is_stream: bool = False,
) -> Table:
    """rows: tuples matching schema; with is_stream, tuples end with
    (time, diff) (reference: debug/__init__.py table_from_rows)."""
    names = list(schema.keys())
    pk = schema.primary_key_columns()
    events = []
    for i, row in enumerate(rows):
        if is_stream:
            *vals, time, diff = row
        else:
            vals, time, diff = list(row), 0, 1
        if pk:
            key = ref_scalar(*(vals[names.index(c)] for c in pk))
        else:
            key = ref_scalar(i)
        events.append((time, (key, tuple(vals), diff)))
    return table_from_events(schema, events)


def table_from_pandas(
    df,
    *,
    id_from: List[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Type[Schema] | None = None,
) -> Table:
    if schema is None:
        schema = schema_from_pandas(df, id_from=id_from)
    names = list(schema.keys())
    dtypes = schema.dtypes()
    events = []
    for i, (idx, row) in enumerate(df.iterrows()):
        if id_from:
            key = ref_scalar(*(row[c] for c in id_from))
        else:
            key = ref_scalar(i)
        values = tuple(
            dt.coerce_value(_from_pandas_value(row[c]), dtypes[c]) for c in names
        )
        events.append((0, (key, values, 1)))
    return table_from_events(schema, events)


def _from_pandas_value(v):
    import numpy as np
    import pandas as pd

    if v is pd.NaT:
        return None
    if isinstance(v, float) and v != v:
        return None
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, pd.Timestamp):
        return v.to_pydatetime()
    if isinstance(v, pd.Timedelta):
        return v.to_pytimedelta()
    return v


def _value_dtype(v) -> dt.DType:
    from pathway_tpu_torch.internals.type_interpreter import const_dtype

    return const_dtype(v)


def table_to_pandas(table: Table, *, include_id: bool = True):
    import pandas as pd

    (capture,) = run_tables(table)
    names = table.column_names()
    rows = capture.state.rows
    keys = sorted(rows.keys())
    data = {n: [rows[k][i] for k in keys] for i, n in enumerate(names)}
    if include_id:
        return pd.DataFrame(data, index=[repr(k) for k in keys])
    return pd.DataFrame(data)


def table_to_dicts(table: Table):
    (capture,) = run_tables(table)
    names = table.column_names()
    keys = list(capture.state.rows.keys())
    columns = {
        n: {k: capture.state.rows[k][i] for k in keys}
        for i, n in enumerate(names)
    }
    return keys, columns


def _format_value(v) -> str:
    if isinstance(v, str):
        return v
    return repr(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    terminate_on_error: bool = True,
) -> None:
    """Run the graph and print the table (reference:
    debug/__init__.py:222).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... g | v
    ... a | 1
    ... a | 2
    ... b | 3
    ... ''')
    >>> res = t.groupby(pw.this.g).reduce(
    ...     g=pw.this.g, total=pw.reducers.sum(pw.this.v)
    ... )
    >>> pw.debug.compute_and_print(res, include_id=False)
    g | total
    b | 3
    a | 3
    """
    (capture,) = run_tables(table)
    names = table.column_names()
    items = sorted(capture.state.rows.items(), key=lambda kv: kv[0])
    if n_rows is not None:
        items = items[:n_rows]
    header = (["id"] if include_id else []) + names
    rows_txt = []
    for k, vals in items:
        cells = ([repr(k)] if include_id else []) + [
            _format_value(v) for v in vals
        ]
        rows_txt.append(cells)
    widths = [
        max(len(h), *(len(r[i]) for r in rows_txt)) if rows_txt else len(h)
        for i, h in enumerate(header)
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for cells in rows_txt:
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs,
) -> None:
    """Run and print the change stream incl. retractions (reference:
    debug/__init__.py:250)."""
    (capture,) = run_tables(table, record_stream=True)
    names = table.column_names()
    header = (["id"] if include_id else []) + names + ["__time__", "__diff__"]
    rows_txt = []
    stream = capture.stream
    if n_rows is not None:
        stream = stream[:n_rows]
    for time, (key, vals, diff) in stream:
        cells = ([repr(key)] if include_id else []) + [
            _format_value(v) for v in vals
        ] + [str(time), str(diff)]
        rows_txt.append(cells)
    widths = [
        max(len(h), *(len(r[i]) for r in rows_txt)) if rows_txt else len(h)
        for i, h in enumerate(header)
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for cells in rows_txt:
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip())


def _as_table_list(x):
    if isinstance(x, Table):
        return [x]
    return list(x)


def _runs(actual, expected):
    from pathway_tpu_torch.engine.engine import Engine

    actual_list = _as_table_list(actual)
    expected_list = _as_table_list(expected)
    engine = Engine()
    captures = run_tables(*actual_list, *expected_list, engine=engine)
    n = len(actual_list)
    return actual_list, expected_list, captures[:n], captures[n:]


def assert_table_equality(actual, expected, **kwargs) -> None:
    """Full equality including row ids (reference: tests/utils.py
    assert_table_equality)."""
    actual_list, expected_list, a_caps, e_caps = _runs(actual, expected)
    for at, et, ac, ec in zip(actual_list, expected_list, a_caps, e_caps):
        a_rows = {k: _norm_row(v) for k, v in ac.state.rows.items()}
        e_rows = {k: _norm_row(v) for k, v in ec.state.rows.items()}
        assert set(at.column_names()) == set(et.column_names()), (
            f"column sets differ: {at.column_names()} vs {et.column_names()}"
        )
        assert a_rows == e_rows, _diff_message(a_rows, e_rows)


def assert_table_equality_wo_index(actual, expected, **kwargs) -> None:
    actual_list, expected_list, a_caps, e_caps = _runs(actual, expected)
    for at, et, ac, ec in zip(actual_list, expected_list, a_caps, e_caps):
        assert set(at.column_names()) == set(et.column_names()), (
            f"column sets differ: {at.column_names()} vs {et.column_names()}"
        )
        # align column order by expected's names
        a_order = [at.column_names().index(c) for c in et.column_names()]
        a_multi = Counter(
            tuple(_norm_row(v)[i] for i in a_order) for v in ac.state.rows.values()
        )
        e_multi = Counter(_norm_row(v) for v in ec.state.rows.values())
        assert a_multi == e_multi, _diff_message(a_multi, e_multi)


def assert_stream_equality(actual, expected_stream) -> None:
    """Determinism check on the UPDATE STREAM, not just final state
    (reference: tests/utils.py assert_key_entries_in_stream_consistent /
    DiffEntry — batch-boundary consistency is the differential-dataflow
    guarantee the engine must keep).

    `expected_stream` entries: (time, values_tuple, diff), or
    (time, key, values_tuple, diff) to also pin row keys (key determinism).
    Comparison is per-time multisets so within-batch ordering stays free."""
    from collections import defaultdict

    from pathway_tpu_torch.internals.runner import run_tables

    expected_stream = list(expected_stream)
    with_keys = any(len(e) == 4 for e in expected_stream)
    (cap,) = run_tables(actual, record_stream=True)
    got: dict = defaultdict(Counter)
    for time, (key, values, diff) in cap.stream:
        entry = (key, _norm_row(values), diff) if with_keys else (
            _norm_row(values), diff
        )
        got[time][entry] += 1
    want: dict = defaultdict(Counter)
    for e in expected_stream:
        if with_keys:
            time, key, values, diff = e
            want[time][(key, _norm_row(tuple(values)), diff)] += 1
        else:
            time, values, diff = e
            want[time][(_norm_row(tuple(values)), diff)] += 1
    assert dict(got) == dict(want), _diff_message(dict(got), dict(want))


def assert_stream_equality_wo_index(actual, expected_stream) -> None:
    """Values-only variant (keys ignored even if provided)."""
    assert_stream_equality(
        actual,
        [
            (e[0], e[-2], e[-1])
            for e in expected_stream
        ],
    )


def assert_table_equality_wo_types(actual, expected, **kwargs) -> None:
    assert_table_equality(actual, expected)


def assert_table_equality_wo_index_types(actual, expected, **kwargs) -> None:
    assert_table_equality_wo_index(actual, expected)


def _norm_row(v: tuple) -> tuple:
    return tuple(_norm_value(x) for x in v)


def _norm_value(x):
    import numpy as np

    if isinstance(x, float) and x.is_integer():
        return x  # keep floats as floats
    if isinstance(x, np.ndarray):
        return (x.shape, tuple(x.flatten().tolist()))
    if isinstance(x, tuple):
        return tuple(_norm_value(i) for i in x)
    return x


def _diff_message(a, e) -> str:
    return f"tables differ:\n  actual:   {_show(a)}\n  expected: {_show(e)}"


def _show(rows) -> str:
    if isinstance(rows, Counter):
        return repr(sorted(rows.items(), key=repr))
    return repr(sorted(rows.items(), key=repr))


class StreamGenerator:
    """Per-worker timed batches for streaming tests (reference:
    debug/__init__.py StreamGenerator:508)."""

    def __init__(self):
        self._events: Dict[int, list] = {}
        self._counter = 0

    def table_from_list_of_batches_by_workers(
        self, batches: List[Dict[int, List[dict]]], schema: Type[Schema]
    ) -> Table:
        names = list(schema.keys())
        events = []
        time = 2
        for batch in batches:
            for _worker, rows in batch.items():
                for row in rows:
                    self._counter += 1
                    key = ref_scalar(self._counter)
                    events.append(
                        (time, (key, tuple(row[c] for c in names), 1))
                    )
            time += 2
        return table_from_events(schema, events)

    def table_from_list_of_batches(
        self, batches: List[List[dict]], schema: Type[Schema]
    ) -> Table:
        return self.table_from_list_of_batches_by_workers(
            [{0: batch} for batch in batches], schema
        )
