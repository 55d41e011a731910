"""pw.io.fs — filesystem connector (reference: python/pathway/io/fs,
src/connectors/posix_like.rs, scanner/filesystem.rs: glob-pattern polling
scanner with modify/delete detection).
"""

from __future__ import annotations

import csv as csv_mod
import glob as glob_mod
import json
import os
import time as time_mod
import zlib
from typing import Any, Dict, List, Optional

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
)
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


def _plaintext_schema():
    return schema_from_columns(
        {"data": ColumnSchema(name="data", dtype=dt.STR)}, name="PlaintextSchema"
    )


def _binary_schema():
    return schema_from_columns(
        {"data": ColumnSchema(name="data", dtype=dt.BYTES)}, name="BinarySchema"
    )


def _with_metadata(schema):
    cols = dict(schema.columns().items())
    cols["_metadata"] = ColumnSchema(name="_metadata", dtype=dt.JSON)
    return schema_from_columns(cols, name=schema.__name__ + "Meta")


class CsvParserSettings:
    """CSV parser settings (reference: io/_utils.py CsvParserSettings:146).
    ``delimiter``/``quote``/``escape`` map onto the csv module; the
    remaining flags are accepted for config parity."""

    def __init__(
        self,
        delimiter: str = ",",
        quote: str = '"',
        escape: str | None = None,
        enable_double_quote_escapes: bool = True,
        enable_quoting: bool = True,
        comment_character: str | None = None,
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.enable_quoting = enable_quoting
        self.comment_character = comment_character


class _FsSubject(ConnectorSubjectBase):
    def __init__(
        self,
        path: str,
        format: str,
        schema,
        mode: str,
        with_metadata: bool,
        refresh_interval: float = 1.0,
        object_pattern: str = "*",
        batch_per_file: bool = False,
        csv_settings: "CsvParserSettings | None" = None,
        partitioned: bool = False,
        json_field_paths=None,
    ):
        super().__init__()
        self.path = path
        self.format = format
        self.schema = schema
        self.mode = mode
        self.with_metadata = with_metadata
        self.refresh_interval = refresh_interval
        self.object_pattern = object_pattern
        self.batch_per_file = batch_per_file
        self.csv_settings = csv_settings
        self.partitioned = partitioned
        self.json_field_paths = dict(json_field_paths or {})
        from pathway_tpu_torch.io._formats import schema_defaults

        # schema defaults fill columns the payload does not carry
        self._defaults = schema_defaults(schema)
        self._seen: Dict[str, float] = {}

    def _owns(self, f: str) -> bool:
        """Partitioned reads: files are divided among workers by a stable
        name hash, so each worker PARSES a disjoint subset (reference:
        partitioned source mode — kafka consumer groups; for files this
        removes the replicated-parse bottleneck of the default mode)."""
        if not self.partitioned:
            return True
        wc = getattr(self, "_worker_count", 1)
        if wc <= 1:
            return True
        wid = getattr(self, "_worker_id", 0)
        return zlib.crc32(os.path.basename(f).encode()) % wc == wid

    def _list_files(self) -> List[str]:
        p = self.path
        if os.path.isdir(p):
            pattern = os.path.join(p, "**", self.object_pattern)
            files = glob_mod.glob(pattern, recursive=True)
        else:
            files = glob_mod.glob(p, recursive=True)
        return sorted(
            f for f in files if os.path.isfile(f) and self._owns(f)
        )

    def _metadata(self, f: str):
        from pathway_tpu_torch.engine.value import Json

        st = os.stat(f)
        return Json(
            {
                "path": os.path.abspath(f),
                "size": st.st_size,
                "modified_at": int(st.st_mtime),
                "seen_at": int(time_mod.time()),
            }
        )

    def _emit_file(self, f: str) -> None:
        meta = {"_metadata": self._metadata(f)} if self.with_metadata else {}
        if self.format == "binary":
            with open(f, "rb") as fh:
                self.next(data=fh.read(), **meta)
        elif self.format in ("plaintext", "plaintext_by_file"):
            with open(f, "r", errors="replace") as fh:
                if self.format == "plaintext_by_file":
                    self.next(data=fh.read(), **meta)
                else:
                    chunk = [
                        {"data": line.rstrip("\n"), **meta} for line in fh
                    ]
                    if chunk:
                        self.next_batch(chunk)
        elif self.format in ("json", "jsonlines"):
            names = set(self.schema.keys())
            loads = json.loads
            schema = self.schema
            # STR/INT/BOOL json values need no per-value coercion; FLOAT
            # (int -> float promotion) and ANY/Json (dict/list wrapping)
            # must go through coerce_json_value
            plain = all(
                schema[k].dtype in (dt.STR, dt.INT, dt.BOOL) for k in names
            )
            from itertools import islice

            with open(f, "r", errors="replace") as fh:
                while True:
                    lines = list(islice(fh, 65536))
                    if not lines:
                        break
                    try:
                        # one C-level parse for the whole chunk beats
                        # per-line loads() by the per-call scanner setup;
                        # blank lines break the join and fall back below
                        text = ",".join(lines)
                        objs = loads("[%s]" % text)
                    except ValueError:
                        block = [ln for ln in lines if ln.strip()]
                        if not block:
                            continue
                        text = ",".join(block)
                        try:
                            objs = loads("[%s]" % text)
                        except ValueError:
                            objs = [loads(ln) for ln in block]
                            text = None
                    # chunk-level nested-value scan: values contain a
                    # dict/list iff the chunk text holds more '{' than
                    # one per row, or any '[' — two C string passes
                    flat_chunk = text is not None and (
                        text.count("{") == len(objs) and "[" not in text
                    )
                    self._emit_json_objs(
                        objs, names, meta, plain, flat_chunk
                    )
        elif self.format == "csv":
            names = set(self.schema.keys())
            with open(f, "r", newline="", errors="replace") as fh:
                from pathway_tpu_torch.io._formats import build_csv_reader

                reader = build_csv_reader(fh, self.csv_settings)
                chunk = []
                for rec in reader:
                    row = {
                        k: _parse_csv_value(v, self.schema[k].dtype)
                        for k, v in rec.items()
                        if k in names
                    }
                    for k, dflt in self._defaults.items():
                        if k not in row:
                            row[k] = dflt
                    row.update(meta)
                    chunk.append(row)
                    if len(chunk) >= 65536:
                        self.next_batch(chunk)
                        chunk = []
                if chunk:
                    self.next_batch(chunk)
        else:
            raise ValueError(f"unknown format {self.format!r}")


    _TUPLE_COLS = 3  # specialize the no-dict path up to this width

    def _plain_tuples(self, objs, ordered):
        """Schema-ordered tuples straight from parsed flat objects —
        C-speed zip over itemgetter columns; None when any row misses a
        schema field (the row-dict path fills None and filters extras)."""
        from operator import itemgetter

        try:
            cols = [list(map(itemgetter(k), objs)) for k in ordered]
        except KeyError:
            return None
        return list(zip(*cols))

    def _emit_json_objs(self, objs, names, meta, plain, flat_chunk=False):
        schema = self.schema
        coerce = _coerce_json_value
        if self.json_field_paths:
            # field-path extraction: the shared row builder (defaults-only
            # schemas stay on the fast paths below — missing keys fall
            # through to the dict-row path, which default-fills)
            from pathway_tpu_torch.io._formats import json_row

            rows = []
            for obj in objs:
                row = json_row(
                    obj, schema, names, self.json_field_paths,
                    self._defaults,
                )
                row.update(meta)
                rows.append(row)
            if rows:
                self.next_batch(rows)
            return
        if plain and not meta and flat_chunk:
            # fastest path: schema-ordered tuples, no row dicts at all
            # (flat_chunk proves no value anywhere in the chunk is nested)
            ordered = [k for k in schema.keys() if k in names]
            if len(ordered) <= self._TUPLE_COLS:
                vals = self._plain_tuples(objs, ordered)
                if vals is not None:
                    self.next_batch_tuples(vals, ordered)
                    return
        if plain:
            # drop fields outside the schema (incl. _pw_key, which the
            # sink would honor as a raw engine key); schema-violating
            # nested values (dict/list under a scalar dtype) still go
            # through coercion so they reach the engine as hashable Json,
            # as on the non-plain path
            rows = []
            rows_append = rows.append
            for obj in objs:
                if any(
                    type(v) is dict or type(v) is list
                    for v in obj.values()
                ):
                    rows_append(
                        {
                            k: coerce(v, schema[k].dtype)
                            for k, v in obj.items()
                            if k in names
                        }
                    )
                elif obj.keys() == names:
                    rows_append(obj)
                else:
                    rows_append(
                        {k: v for k, v in obj.items() if k in names}
                    )
            if self._defaults:
                for row in rows:
                    for k, dflt in self._defaults.items():
                        if k not in row:
                            row[k] = dflt
            if meta:
                for row in rows:
                    row.update(meta)
            self.next_batch(rows)
        else:
            rows = [
                {
                    k: coerce(v, schema[k].dtype)
                    for k, v in obj.items()
                    if k in names
                }
                for obj in objs
            ]
            if self._defaults:
                for row in rows:
                    for k, dflt in self._defaults.items():
                        if k not in row:
                            row[k] = dflt
            if meta:
                for row in rows:
                    row.update(meta)
            self.next_batch(rows)

    def run(self) -> None:
        while True:
            emitted_any = False
            for f in self._list_files():
                try:
                    mtime = os.stat(f).st_mtime
                except OSError:
                    continue
                if self._seen.get(f) == mtime:
                    continue
                self._seen[f] = mtime
                self._emit_file(f)
                # commit per file: downstream batches pipeline host-side
                # parsing of file N+1 against the (async-dispatched) device
                # work of file N; as a barrier, the batch boundary is
                # deterministic regardless of reader/engine relative speed
                self.commit(barrier=self.batch_per_file)
                emitted_any = True
            if not emitted_any:
                self.commit()
            if self.mode == "static":
                return
            if self._wait_for_run_end(self.refresh_interval):
                return

    def _persisted_state(self):
        return {"seen": dict(self._seen)}

    def _restore_persisted_state(self, state) -> None:
        if state and "seen" in state:
            self._seen.update(state["seen"])


# single shared implementation in _formats (also used by s3/minio)
from pathway_tpu_torch.io._formats import (  # noqa: E402
    coerce_json_value as _coerce_json_value,
    parse_csv_value as _parse_csv_value,
)


def read(
    path: str,
    *,
    format: str = "csv",
    schema=None,
    mode: str = "streaming",
    csv_settings=None,
    json_field_paths=None,
    object_pattern: str = "*",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    refresh_interval: float = 1.0,
    batch_per_file: bool = False,
    partitioned: bool = False,
    **kwargs,
):
    """Read files as a table (reference: io/fs read; StorageType PosixLike /
    CsvFilesystem, data_storage.rs:359).

    ``batch_per_file=True`` (streaming mode, single-worker) makes every
    file its own engine batch — a barrier commit per file, so downstream
    host work on file N+1 pipelines against the async device work of
    file N with deterministic batch shapes. Multi-worker runs keep the
    shared timer ticks (the lockstep agreement cadence must stay
    identical on every worker), so there the flag only gates rows to
    whole-file prefixes without pinning one file per batch."""
    if schema is None:
        if format in ("plaintext", "plaintext_by_file"):
            schema = _plaintext_schema()
        elif format == "binary":
            schema = _binary_schema()
        else:
            raise ValueError(f"schema required for format {format!r}")
    out_schema = _with_metadata(schema) if with_metadata else schema

    def factory():
        return _FsSubject(
            path,
            format,
            schema,
            mode,
            with_metadata,
            refresh_interval=refresh_interval,
            object_pattern=object_pattern,
            batch_per_file=batch_per_file,
            csv_settings=csv_settings,
            partitioned=partitioned,
            json_field_paths=json_field_paths,
        )

    return connector_table(
        out_schema,
        factory,
        mode=mode,
        name=name,
        partitioned=partitioned,
        gated_commits=batch_per_file,
    )


def worker_output_path(filename: str, engine) -> str:
    """Per-worker part file: worker 0 keeps `filename`, worker w>0 writes
    `filename.w` — each worker emits only the rows it owns, so the union of
    part files equals the single-worker output exactly (no duplicates)."""
    if engine.worker_count <= 1 or engine.worker_id == 0:
        return filename
    return f"{filename}.{engine.worker_id}"


class _TxnFileSink:
    """Transactional wrapper around one worker's output file.

    Exactly-once by offset truncation: at every snapshot the driver calls
    `prepare(F)` BEFORE the manifest (fsync + record the byte length of
    everything <= F in the sink commit log) and `commit(F)` after it.  On
    recovery at restore frontier M the file is truncated back to the
    length recorded for M — the entry always exists, because the sink
    record of frontier F precedes the manifest of the same F — and the
    replayed epochs regenerate the tail.  `recover(-1)` (full replay)
    truncates to zero: the whole stream is rewritten, still exactly once.
    """

    transactional = True

    def __init__(self, path: str, commit_log, write_header=None):
        self.path = path
        self.log = commit_log
        self._write_header = write_header
        self.fh = open(path, "a+", newline="")
        self.fh.seek(0, os.SEEK_END)
        if self.fh.tell() == 0 and write_header is not None:
            write_header()

    def prepare(self, frontier: int) -> None:
        self.fh.flush()
        os.fsync(self.fh.fileno())
        self.log.record_offset(frontier, self.fh.tell())

    def commit(self, frontier: int) -> None:
        self.log.mark_committed(frontier)

    def recover(self, frontier: int) -> None:
        offset = self.log.offset_for(frontier) if frontier >= 0 else 0
        if offset is None:
            offset = 0
        self.log.rollback_to(frontier)
        self.fh.flush()
        self.fh.truncate(offset)
        self.fh.seek(offset)
        if offset == 0 and self._write_header is not None:
            self._write_header()

    def committed_frontier(self) -> int:
        return self.log.committed_frontier()


def write(table, filename: str, *, format: str = "json", name: str | None = None, **kwargs) -> None:
    """Write a table's change stream to a file (reference: io/fs write).

    Under a persistent run with operator snapshots enabled the sink is
    exactly-once across crash/failover (see _TxnFileSink); otherwise the
    file is truncated at open and written through, as before."""
    column_names = table.column_names()

    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import SubscribeNode

        engine = ctx.engine
        (node,) = nodes
        path = worker_output_path(filename, engine)
        pcfg = getattr(engine, "_persistence_config", None)
        txn = (
            pcfg is not None
            and getattr(pcfg, "snapshot_interval_ms", 0) > 0
        )
        if txn:
            from pathway_tpu_torch.persistence import SinkCommitLog

            sink_name = name or f"fs:{filename}"
            sink = _TxnFileSink(
                path,
                SinkCommitLog(
                    pcfg.backend._backend, sink_name, engine.worker_id
                ),
                write_header=None,  # bound below for csv
            )
            fh = sink.fh
            engine.register_txn_sink(sink)
        else:
            sink = None
            fh = open(path, "w", newline="")
        if format == "csv":
            writer = csv_mod.writer(fh)
            header_row = column_names + ["time", "diff"]

            def header():
                writer.writerow(header_row)

            if sink is not None:
                sink._write_header = header
                if fh.tell() == 0:
                    header()
            else:
                header()

            def on_change(key, row, time, is_addition):
                writer.writerow(
                    [row[c] for c in column_names] + [time, 1 if is_addition else -1]
                )

        else:

            def on_change(key, row, time, is_addition):
                obj = {c: _jsonable(row[c]) for c in column_names}
                obj["time"] = time
                obj["diff"] = 1 if is_addition else -1
                fh.write(json.dumps(obj) + "\n")

        def on_end():
            fh.flush()
            fh.close()

        SubscribeNode(
            ctx.engine,
            node,
            on_change=on_change,
            on_end=on_end,
            column_names=column_names,
        )

    G.add_sink([table], attach)


def _jsonable(v):
    import numpy as np

    from pathway_tpu_torch.engine.value import Json, Pointer

    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    if isinstance(v, np.ndarray):
        return v.tolist()
    import datetime

    if isinstance(v, (datetime.datetime,)):
        return v.isoformat()
    if isinstance(v, datetime.timedelta):
        return v.total_seconds()
    return v
