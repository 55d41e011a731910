"""PyTorch + CUDA port of pathway_tpu.

A package of its own beside the JAX package: it imports torch, numpy and
the standard library, never JAX and nothing of `pathway_tpu`. It holds

  * the host framework, copied from the JAX package: the engine
    (engine/), the Table DSL (internals/), the fs / csv / jsonlines /
    plaintext / python connectors (io/), persistence and `pw.debug`, and
    the async `DevicePipeline` (internals/device_pipeline.py), which
    waits on the card's stream;
  * the MiniLM-class encoder and the decoder (models/), the device KNN
    index and the fused embed+search object (ops/knn.py), and
    hand-written Hopper kernels for the JAX package's two Pallas kernels
    (ops/kernels/).

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
The stdlib (temporal, indexing, ml, ...), UDFs, xpacks and the static
analyzer are not ported yet.
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
from pathway_tpu_torch import universes  # noqa: E402


def __getattr__(name):
    if name == "persistence":
        import pathway_tpu_torch.persistence as p

        return p
    if name == "MonitoringLevel":
        from pathway_tpu_torch.internals.monitoring import MonitoringLevel as m

        return m
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def global_error_log() -> Table:
    """Error log as a queryable table."""
    from pathway_tpu_torch.internals.error_log import global_error_log as _gel

    return _gel()


local_error_log = global_error_log
