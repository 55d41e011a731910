"""@pw.pandas_transformer — pandas functions as table transformers
(reference: python/pathway/stdlib/utils/pandas_transformer.py:124).

Input tables materialize into pandas DataFrames (row keys become the
index), the wrapped function runs on them, and the returned DataFrame
becomes a table again: index values that are row Pointers keep them,
integer indexes derive fresh stable keys. Recomputed per engine batch —
whole-table semantics by definition (the reference does the same: the
function sees full frames, not deltas)."""

from __future__ import annotations

from typing import Any, Type

from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.engine.value import Pointer, ref_scalar


def _pack_whole_table(table: Table, tag: int):
    cols = [table[c] for c in table.column_names()]
    tagged = table.select(
        _pw_row=pw_api.make_tuple(tag, thisclass.this.id, *cols)
    )
    return tagged


def pandas_transformer(
    output_schema: Type[Schema], output_universe: str | int | None = None
):
    def decorator(func):
        out_names = list(output_schema.keys())

        def wrapper(*tables: Table) -> Table:
            import pandas as pd

            universe_arg: int | None = None
            if output_universe is not None:
                if isinstance(output_universe, int):
                    universe_arg = output_universe
                else:
                    raise NotImplementedError(
                        "output_universe by argument NAME is not supported; "
                        "pass the positional index of the input table"
                    )
                if not 0 <= universe_arg < len(tables):
                    raise ValueError(
                        f"output_universe={universe_arg} out of range for "
                        f"{len(tables)} input tables"
                    )

            column_names = [t.column_names() for t in tables]

            packed_inputs = [
                _pack_whole_table(t, i) for i, t in enumerate(tables)
            ]
            union = packed_inputs[0]
            if len(packed_inputs) > 1:
                union = union.concat_reindex(*packed_inputs[1:])
            packed = union.groupby().reduce(
                rows=reducers.tuple(thisclass.this._pw_row)
            )

            def run(rows) -> tuple:
                per_input: list[list] = [[] for _ in tables]
                for row in rows or ():
                    per_input[row[0]].append(row[1:])
                frames = []
                for names, data in zip(column_names, per_input):
                    frames.append(
                        pd.DataFrame(
                            [r[1:] for r in data],
                            columns=names,
                            index=[r[0] for r in data],
                        )
                    )
                result = func(*frames)
                if universe_arg is not None:
                    # promised universe: every output row must keep a key
                    # of the chosen input table (reference: the output
                    # index IS the output universe)
                    allowed = {r[0] for r in per_input[universe_arg]}
                    stray = [i for i in result.index if i not in allowed]
                    if stray:
                        raise ValueError(
                            "pandas_transformer: output index not in the "
                            f"universe of input {universe_arg}: {stray[:3]}"
                        )
                out = []
                for idx, row in zip(result.index, result.itertuples(index=False)):
                    out.append((idx, *tuple(row)[: len(out_names)]))
                return tuple(out)

            flat = (
                packed.select(
                    pairs=pw_api.apply_with_type(
                        run, tuple, thisclass.this.rows
                    )
                )
                .flatten(thisclass.this.pairs)
            )

            def to_key(v) -> Pointer:
                if isinstance(v, Pointer):
                    return v
                return ref_scalar("__pandas_transformer__", v)

            keyed = flat.with_id(
                pw_api.apply_with_type(
                    to_key, Pointer, thisclass.this.pairs.get(0)
                )
            )
            return keyed.select(
                **{
                    name: thisclass.this.pairs.get(i + 1)
                    for i, name in enumerate(out_names)
                }
            )

        return wrapper

    return decorator
