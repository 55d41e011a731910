"""PyTorch + CUDA port of pathway_tpu.

A package of its own beside the JAX package: it imports torch, numpy and
the standard library, never JAX and nothing of `pathway_tpu`. It holds

  * the host framework, copied from the JAX package: the engine
    (engine/), the Table DSL (internals/), the fs / csv / jsonlines /
    plaintext / python connectors (io/), persistence and `pw.debug`, and
    the async `DevicePipeline` (internals/device_pipeline.py), which
    waits on the card's stream;
  * UDFs (`pw.udf`, `pw.UDF`; internals/udfs/), the external-index
    operator (engine/index_node.py), `pw.indexing` (stdlib/indexing/:
    brute-force KNN on the card, BM25, hybrid, LSH / IVF) and the LLM
    xpack (`pw.xpacks.llm`): embedders, parsers, splitters,
    `DocumentStore`, prompts, chats (`HFPipelineChat` on the decoder),
    rerankers, RAG question answering, and the REST, vector-store and
    MCP servers over `pw.io.http`;
  * the rest of the stdlib, copied from the JAX package: `pw.temporal`
    (windows, behaviors, asof / asof-now / interval / window joins,
    grafted onto `Table` as there), `pw.ordered` (`Table.diff`),
    `pw.stateful`, `pw.statistical`, `pw.utils`, `pw.ml` (`KNNIndex`
    on the card's knn_topk), `pw.graphs`, `pw.viz` (over
    internals/interactive.py) and `pw.xpacks.connectors` (SharePoint);
  * the operability surface, copied from the JAX package: the static
    analyzer (analysis/: `pw.run(analysis="warn"|"strict")`, whose
    capacity plan predicts the port's own index allocation), the
    on-demand profiler (internals/profiler.py: `torch.profiler` into a
    Chrome trace, behind the monitoring server's /profile and /status)
    and the cli (`pathway-tpu-torch`, or `python -m pathway_tpu_torch.cli`:
    analyze, trace, status, top, profile, restart, explain, spawn,
    airbyte);
  * the MiniLM-class encoder, the cross-encoder and the decoder
    (models/), the device KNN
    index and the fused embed+search object (ops/knn.py), and
    hand-written Hopper kernels for the JAX package's two Pallas kernels
    (ops/kernels/; flash is differentiable, its backward recomputing
    the plain version as the JAX package's does).

Usage mirrors the JAX package::

    import pathway_tpu_torch as pw

    t = pw.debug.table_from_markdown('''
    value
    1
    2
    ''')
    pw.debug.compute_and_print(t.select(doubled=pw.this.value * 2))

Device entry points take ``device=None``, meaning the CUDA card;
``device="cpu"`` runs the plain PyTorch versions of the kernels instead.
Not ported yet: `pw.sql`, `pw.load_yaml`, `pw.demo`, the connectors
other than fs / csv / jsonlines / plaintext / python / null / s3 / http /
airbyte, training and the device mesh.
"""

from __future__ import annotations

import datetime as _datetime

from pathway_tpu_torch._device import resolve_device

# -- core DSL ---------------------------------------------------------------
from pathway_tpu_torch.internals import dtype as _dt
from pathway_tpu_torch.internals.api import (
    apply,
    apply_async,
    apply_fully_async,
    apply_with_type,
    assert_table_has_schema,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    iterate,
    make_tuple,
    require,
    table_transformer,
    unwrap,
)
from pathway_tpu_torch.internals.config import (
    pathway_config,
    set_license_key,
    set_monitoring_config,
)
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
)
from pathway_tpu_torch.internals.joins import (
    GroupedJoinResult,
    JoinMode,
    JoinResult,
    OuterJoinResult,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
)
from pathway_tpu_torch.internals.joins import groupby as groupby  # noqa: PLC0414
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.api import (
    PathwayType as Type,
    PersistenceMode,
)
from pathway_tpu_torch.internals.schema import SchemaProperties
from pathway_tpu_torch.internals.iterate import iterate_universe
from pathway_tpu_torch.internals.parse_graph import G as parse_graph_G
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.reducers import BaseCustomAccumulator, reducers
from pathway_tpu_torch.internals.runner import run, run_all
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.async_transformer import AsyncTransformer
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.table import Table, TableSlice
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.engine.value import (
    Json,
    Pointer,
    PyObjectWrapper,
    ref_scalar,
    wrap_py_object,
)
from pathway_tpu_torch.engine.value import ERROR as Error

# -- type aliases -----------------------------------------------------------
DateTimeNaive = _datetime.datetime
DateTimeUtc = _datetime.datetime
Duration = _datetime.timedelta
Date = _datetime.date

DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
DATE_TIME_UTC = _dt.DATE_TIME_UTC
DURATION = _dt.DURATION


# -- subpackages ------------------------------------------------------------
from pathway_tpu_torch import debug  # noqa: E402
from pathway_tpu_torch import io  # noqa: E402
from pathway_tpu_torch import stdlib  # noqa: E402
from pathway_tpu_torch import universes  # noqa: E402
from pathway_tpu_torch.internals import udfs  # noqa: E402
from pathway_tpu_torch.internals.udfs import UDF, udf  # noqa: E402
from pathway_tpu_torch.stdlib import indexing, ml, ordered, stateful, statistical  # noqa: E402
from pathway_tpu_torch.stdlib import temporal  # noqa: E402
from pathway_tpu_torch.stdlib import utils  # noqa: E402
from pathway_tpu_torch.stdlib import viz  # noqa: E402
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer  # noqa: E402
from pathway_tpu_torch.stdlib.temporal import (  # noqa: E402
    intervals_over,
    session,
    sliding,
    tumbling,
)

# the stdlib entry points grafted onto the pw namespace and onto Table, as
# the JAX package grafts them
windowby = temporal.windowby

Table.diff = ordered.diff

Table.asof_join = temporal.asof_join
Table.asof_join_left = temporal.asof_join_left
Table.asof_join_right = temporal.asof_join_right
Table.asof_join_outer = temporal.asof_join_outer

Table.asof_now_join = temporal.asof_now_join
Table.asof_now_join_inner = temporal.asof_now_join_inner
Table.asof_now_join_left = temporal.asof_now_join_left

Table.window_join = temporal.window_join
Table.window_join_inner = temporal.window_join_inner
Table.window_join_left = temporal.window_join_left
Table.window_join_right = temporal.window_join_right
Table.window_join_outer = temporal.window_join_outer

Table.interval_join = temporal.interval_join
Table.interval_join_inner = temporal.interval_join_inner
Table.interval_join_left = temporal.interval_join_left
Table.interval_join_right = temporal.interval_join_right
Table.interval_join_outer = temporal.interval_join_outer

Table.windowby = temporal.windowby
Table.interpolate = statistical.interpolate
Table.inactivity_detection = temporal.inactivity_detection

# names bound as the JAX package binds them: the pre-rename name of the
# udfs module, and the window types' namespace
asynchronous = udfs
window = temporal
from pathway_tpu_torch.stdlib.temporal import (  # noqa: E402
    AsofJoinResult,
    IntervalJoinResult,
    WindowJoinResult,
)


def __getattr__(name):
    if name == "xpacks":
        import pathway_tpu_torch.xpacks as xp

        return xp
    if name == "persistence":
        import pathway_tpu_torch.persistence as p

        return p
    if name == "graphs":
        from pathway_tpu_torch.stdlib import graphs as g

        return g
    if name in ("enable_interactive_mode", "LiveTable"):
        from pathway_tpu_torch.internals import interactive

        return getattr(interactive, name)
    if name == "MonitoringLevel":
        from pathway_tpu_torch.internals.monitoring import MonitoringLevel as m

        return m
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def global_error_log() -> Table:
    """Error log as a queryable table."""
    from pathway_tpu_torch.internals.error_log import global_error_log as _gel

    return _gel()


local_error_log = global_error_log
