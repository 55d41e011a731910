"""Column utilities (reference: python/pathway/stdlib/utils/col.py).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_rows(
...     pw.schema_from_types(pair=tuple), [((1, "x"),)]
... )
>>> from pathway_tpu_torch.stdlib.utils.col import unpack_col
>>> r = unpack_col(t.pair, pw.this.num, pw.this.name)
>>> pw.debug.compute_and_print(r, include_id=False)
num | name
1   | x
"""

from __future__ import annotations

from typing import Any, Type

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import desugar
from pathway_tpu_torch.internals.schema import Schema


def unpack_col(column, *unpacked_columns, schema: Type[Schema] | None = None):
    """Expand a tuple column into separate columns (reference:
    utils/col.py unpack_col)."""
    from pathway_tpu_torch.internals.expression import collect_tables

    tables = list(collect_tables(column, set()))
    if len(tables) != 1:
        raise ValueError("unpack_col expects a single-table column")
    table = tables[0]
    if schema is not None:
        names = list(schema.keys())
    else:
        names = [
            c if isinstance(c, str) else c.name for c in unpacked_columns
        ]
    cols = {name: column.get(i) for i, name in enumerate(names)}
    return table.select(**cols)


def flatten_column(column, origin_id: str | None = None):
    from pathway_tpu_torch.internals.expression import collect_tables

    tables = list(collect_tables(column, set()))
    table = tables[0]
    return table.flatten(column)


def multiapply_all_rows(*cols, fun, result_col_names):
    """Apply `fun` over the FULL columns at once; fun receives one list per
    input column and returns one aligned list per result column (reference:
    utils/col.py multiapply_all_rows — whole-column semantics, e.g.
    normalization against global statistics)."""
    from pathway_tpu_torch.engine.value import Pointer, ref_scalar
    from pathway_tpu_torch.internals import api as pw_api
    from pathway_tpu_torch.internals.expression import collect_tables
    from pathway_tpu_torch.internals.reducers import reducers

    tables = set()
    for c in cols:
        tables |= collect_tables(c, set())
    if len(tables) != 1:
        raise ValueError("multiapply_all_rows expects columns of one table")
    (table,) = tables

    packed = table.select(
        _pw_row=pw_api.make_tuple(thisclass.this.id, *cols)
    ).groupby().reduce(rows=reducers.tuple(thisclass.this._pw_row))

    n_out = len(result_col_names)

    def run(rows) -> tuple:
        rows = list(rows or ())
        keys = [r[0] for r in rows]
        columns = [[r[i + 1] for r in rows] for i in range(len(cols))]
        results = fun(*columns)
        if n_out == 1 and not isinstance(results, tuple):
            results = (results,)
        return tuple(
            (k, *(col[i] for col in results)) for i, k in enumerate(keys)
        )

    flat = packed.select(
        pairs=pw_api.apply_with_type(run, tuple, thisclass.this.rows)
    ).flatten(thisclass.this.pairs)
    keyed = flat.with_id(
        pw_api.apply_with_type(
            lambda p: p, Pointer, thisclass.this.pairs.get(0)
        )
    )
    return keyed.select(
        **{
            name: thisclass.this.pairs.get(i + 1)
            for i, name in enumerate(result_col_names)
        }
    )


def apply_all_rows(*cols, fun, result_col_name):
    """Single-result variant of multiapply_all_rows (reference:
    utils/col.py apply_all_rows)."""
    return multiapply_all_rows(
        *cols, fun=fun, result_col_names=[result_col_name]
    )


def groupby_reduce_majority(column, majority_col_name: str = "majority"):
    from pathway_tpu_torch.internals.expression import collect_tables
    from pathway_tpu_torch.internals.reducers import reducers

    tables = list(collect_tables(column, set()))
    table = tables[0]
    counted = table.groupby(column).reduce(
        **{majority_col_name: column, "_pw_count": reducers.count()}
    )
    return counted
