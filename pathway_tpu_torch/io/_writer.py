"""Shared output-writer machinery for io sinks.

Host-side equivalent of the reference Writer trait + ConsolidateForOutput
(reference: src/connectors/data_storage.rs:660 `trait Writer`,
src/engine/dataflow/operators/output.rs — updates grouped into per-time
batches before hitting the backend). Every DB/MQ writer module builds on
`attach_writer`, which batches the change stream per engine time and hands
`RowEvent` batches to a backend-specific `OutputWriter`.
"""

from __future__ import annotations

import datetime
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np

from pathway_tpu_torch.internals.parse_graph import G


@dataclass
class RowEvent:
    """One change-stream delta (reference: FormatterContext values+diff,
    src/connectors/data_format.rs:474)."""

    key: Any
    values: Dict[str, Any]
    time: int
    diff: int  # +1 insert / -1 delete


class OutputWriter:
    """Backend writer interface (reference: data_storage.rs:660).

    `write_batch` receives all deltas of one closed engine time, in order.

    Transactional contract (exactly-once sinks): a writer that sets
    `transactional = True` and is bound to a `SinkCommitLog` participates
    in the engine's snapshot-aligned two-phase commit.  Output for epoch
    T becomes durable only when the operator-snapshot frontier reaches
    >= T; the streaming driver drives the protocol around each snapshot:

        begin_epoch(T)   before the events of epoch T arrive
        prepare(F)       BEFORE the snapshot manifest is written —
                         durably stage everything <= F
        commit(F)        AFTER the manifest — idempotent finalize
        recover(M)       at (re)start / rollback — discard everything
                         past the restore frontier M (M = -1 on a full
                         replay) and re-run any unfinished finalize

    All defaults are no-ops so existing writers are unaffected.
    """

    transactional = False

    def fork(self, worker_id: int) -> "OutputWriter":
        """Per-worker instance (multi-worker runs attach each worker's
        own session; default: shared instance, as before)."""
        return self

    def bind_commit_log(self, log) -> None:
        """Receive this worker's SinkCommitLog when persistence is on."""

    def begin_epoch(self, time: int) -> None:
        pass

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        raise NotImplementedError

    def prepare(self, frontier: int) -> None:
        pass

    def commit(self, frontier: int) -> None:
        pass

    def recover(self, frontier: int) -> None:
        pass

    def committed_frontier(self) -> int:
        return -1

    def flush(self) -> None:  # called after each time
        pass

    def close(self) -> None:  # called at end of stream
        pass


def attach_writer(table, writer: OutputWriter, *, name: str | None = None) -> None:
    """Route `table`'s change stream into `writer`, batched per engine time
    (reference: ConsolidateForOutput grouping, operators/output.rs)."""
    column_names = table.column_names()

    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import SubscribeNode

        engine = ctx.engine
        (node,) = nodes
        sink_name = name or type(writer).__name__
        w = writer.fork(engine.worker_id)
        if getattr(w, "transactional", False):
            pcfg = getattr(engine, "_persistence_config", None)
            if pcfg is not None and getattr(pcfg, "snapshot_interval_ms", 0) > 0:
                from pathway_tpu_torch.persistence import SinkCommitLog

                w.bind_commit_log(
                    SinkCommitLog(
                        pcfg.backend._backend, sink_name, engine.worker_id
                    )
                )
                engine.register_txn_sink(w)
        pending: List[RowEvent] = []

        def on_change(key, row, time, is_addition):
            pending.append(
                RowEvent(
                    key=key,
                    values={c: row[c] for c in column_names},
                    time=time,
                    diff=1 if is_addition else -1,
                )
            )

        def on_time_end(time):
            w.begin_epoch(time)
            if pending:
                w.write_batch(list(pending))
                pending.clear()
            w.flush()

        def on_end():
            if pending:
                w.write_batch(list(pending))
                pending.clear()
            w.close()

        sub = SubscribeNode(
            ctx.engine,
            node,
            on_change=on_change,
            on_time_end=on_time_end,
            on_end=on_end,
            column_names=column_names,
            # freshness label: explicit sink name, else the writer class
            sink_name=sink_name,
        )
        # failover rollback (Engine.reset_for_rollback): rows buffered for
        # an epoch the rollback abandoned are regenerated by replay — drop
        # them here so they cannot double-write into the new timeline
        sub.on_rollback = pending.clear

    G.add_sink([table], attach)


def jsonable(v):
    """Engine Value -> plain JSON-serializable (reference: JsonLinesFormatter
    value conversion, data_format.rs:2059)."""
    from pathway_tpu_torch.engine.value import Json, Pointer

    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, datetime.timedelta):
        return v.total_seconds()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def format_json_event(event: RowEvent, *, time_name: str = "time", diff_name: str = "diff") -> str:
    obj = {k: jsonable(v) for k, v in event.values.items()}
    obj[time_name] = event.time
    obj[diff_name] = event.diff
    return json.dumps(obj)
