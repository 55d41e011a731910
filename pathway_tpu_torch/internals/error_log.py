"""pw.global_error_log — errors as a queryable table (reference:
python/pathway/internals/errors.py, Graph::error_log graph.rs:932)."""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

_schema = schema_from_columns(
    {
        "message": ColumnSchema(name="message", dtype=dt.STR),
        "operator": ColumnSchema(name="operator", dtype=dt.STR),
    },
    name="ErrorLogSchema",
)

_global_log_table: Table | None = None


def global_error_log() -> Table:
    global _global_log_table
    if _global_log_table is None:

        def build(ctx):
            from pathway_tpu_torch.engine.engine import ErrorLogNode

            return ErrorLogNode(ctx.engine)

        _global_log_table = Table(
            schema=_schema, universe=Universe(), build=build
        )
    return _global_log_table
