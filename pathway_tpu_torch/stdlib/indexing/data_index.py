"""DataIndex / InnerIndex — the retrieval API (reference:
python/pathway/stdlib/indexing/data_index.py: InnerIndex:206, DataIndex:278,
result repacking :294)."""

from __future__ import annotations

from typing import Any, Callable, Optional

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    collect_tables,
    smart_wrap,
)
from pathway_tpu_torch.internals.parse_graph import record_op
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
)
from pathway_tpu_torch.internals.table import Table, _compile_on
from pathway_tpu_torch.internals.universe import Universe


class IdScoreSchema(Schema):
    _pw_index_reply_id: Any
    _pw_index_reply_score: float


class InnerIndex:
    """Index over a data column (reference: data_index.py InnerIndex:206).

    Subclasses provide `_make_impl()` returning an engine IndexImpl."""

    def __init__(self, data_column: ColumnReference, metadata_column=None):
        self.data_column = data_column
        self.metadata_column = metadata_column
        tables = list(collect_tables(data_column, set()))
        if len(tables) != 1:
            raise ValueError("index data column must reference one table")
        self.data_table: Table = tables[0]

    def _make_impl(self):
        raise NotImplementedError

    def _query_preprocess(self, query_column: ColumnExpression):
        """Hook: e.g. embed query text before KNN search."""
        return query_column

    def _data_preprocess(self, data_column: ColumnExpression):
        return data_column


class DataIndex:
    """A data table + an inner index; answers query tables (reference:
    data_index.py DataIndex:278)."""

    def __init__(
        self,
        data_table: Table,
        inner_index: InnerIndex,
    ):
        self.data_table = data_table
        self.inner = inner_index

    def query_as_of_now(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
            as_of_now=True,
        )

    def query(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
            as_of_now=False,
        )

    def _query(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches,
        collapse_rows,
        metadata_filter,
        as_of_now,
    ) -> Table:
        query_column = self.inner._query_preprocess(smart_wrap(query_column))
        q_tables = list(collect_tables(query_column, set()))
        if len(q_tables) != 1:
            raise ValueError("query column must reference one table")
        query_table = q_tables[0]
        data_table = self.data_table
        inner = self.inner
        data_value_expr = inner._data_preprocess(inner.data_column)
        k_expr = smart_wrap(number_of_matches)
        filter_expr = (
            smart_wrap(metadata_filter) if metadata_filter is not None else None
        )

        def build(ctx):
            from pathway_tpu_torch.engine.exchange import exchange_by_key
            from pathway_tpu_torch.engine.index_node import ExternalIndexNode

            data_node = ctx.node(data_table)
            query_node = ctx.node(query_table)
            return exchange_by_key(ctx.engine, ExternalIndexNode(
                ctx.engine,
                data_node,
                query_node,
                inner._make_impl(),
                _compile_on(ctx, [data_table], data_value_expr),
                (
                    _compile_on(ctx, [data_table], inner.metadata_column)
                    if inner.metadata_column is not None
                    else None
                ),
                _compile_on(ctx, [query_table], query_column),
                _compile_on(ctx, [query_table], k_expr),
                (
                    _compile_on(ctx, [query_table], filter_expr)
                    if filter_expr is not None
                    else None
                ),
                data_width=len(data_table.column_names()),
                as_of_now=as_of_now,
            ))

        cols: dict = {
            "_pw_index_reply_id": ColumnSchema(
                name="_pw_index_reply_id", dtype=dt.ListDType(dt.POINTER)
            ),
            "_pw_index_reply_score": ColumnSchema(
                name="_pw_index_reply_score", dtype=dt.ListDType(dt.FLOAT)
            ),
        }
        for name, c in data_table._schema.columns().items():
            cols[name] = ColumnSchema(
                name=name, dtype=dt.ListDType(dt.Optionalize(c.dtype))
            )
        reply = Table(
            schema=schema_from_columns(cols),
            universe=query_table._universe,
            build=build,
        )
        # capacity annotation for the PWT6xx pass (analysis/capacity.py):
        # the analyzer predicts the device footprint of this index from
        # the same numbers the runtime will allocate with
        record_op(
            reply,
            "external_index",
            (query_table, data_table),
            index=type(inner).__name__,
            dimensions=getattr(inner, "dimensions", None),
            reserved_space=getattr(inner, "reserved_space", None),
            metric=_metric_name(inner),
            encoder=_encoder_info(getattr(inner, "embedder", None)),
        )
        if collapse_rows:
            # zip query columns alongside (same universe)
            out_cols = {}
            for name in query_table.column_names():
                out_cols[name] = query_table[name]
            for name in reply.column_names():
                if name not in out_cols:
                    out_cols[name] = reply[name]
            return reply._select_impl(out_cols)
        # one row per match
        paired = reply._select_impl(
            {
                **{name: query_table[name] for name in query_table.column_names()},
                "_pw_pairs": _zip_pairs_expr(reply),
            }
        )
        flat = paired.flatten(paired._pw_pairs)
        out_cols = {}
        for name in query_table.column_names():
            out_cols[name] = flat[name]
        out_cols["_pw_index_reply_id"] = flat._pw_pairs.get(0)
        out_cols["_pw_index_reply_score"] = flat._pw_pairs.get(1)
        data_names = self.data_table.column_names()
        for i, name in enumerate(data_names):
            out_cols[name] = flat._pw_pairs.get(2 + i)
        return flat._select_impl(out_cols)


def _metric_name(inner: InnerIndex) -> Optional[str]:
    m = getattr(inner, "metric", None)
    return getattr(m, "value", m) if m is not None else None


def _encoder_info(embedder: Any) -> Optional[dict]:
    """Geometry of a local encoder (the fused-path criterion in
    stdlib/indexing/nearest_neighbors._local_jax_encoder), as a plain
    dict the analyzer can price with costmodel.encoder_param_count.
    API-backed embedders (no device-resident params) return None."""
    encoder = getattr(embedder, "encoder", None)
    if encoder is None or not hasattr(encoder, "lm"):
        return None
    cfg = getattr(encoder, "config", None)
    if cfg is None:
        return None
    return {
        "vocab_size": int(getattr(cfg, "vocab_size", 30522)),
        "hidden": int(getattr(cfg, "hidden", 0)),
        "layers": int(getattr(cfg, "layers", 0)),
        "mlp_dim": int(getattr(cfg, "mlp_dim", 0)),
        "max_len": int(getattr(cfg, "max_len", 512)),
    }


def _zip_pairs_expr(reply: Table):
    from pathway_tpu_torch.internals.api import apply_with_type

    data_cols = [
        c
        for c in reply.column_names()
        if c not in ("_pw_index_reply_id", "_pw_index_reply_score")
    ]

    def zipper(ids, scores, *cols):
        return tuple(
            (i, s, *(col[j] for col in cols))
            for j, (i, s) in enumerate(zip(ids, scores))
        )

    return apply_with_type(
        zipper,
        tuple,
        reply._pw_index_reply_id,
        reply._pw_index_reply_score,
        *(reply[c] for c in data_cols),
    )
