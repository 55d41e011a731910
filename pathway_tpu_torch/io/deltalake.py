"""pw.io.deltalake — Delta Lake connector (reference:
python/pathway/io/deltalake read:290, write:466; Rust implementation
src/connectors/data_lake/delta.rs — CDC-style snapshot maintenance, Arrow
conversion, column buffering in data_lake/buffering.rs).

Implemented natively over pyarrow.parquet + the Delta transaction-log
protocol (`_delta_log/<version>.json` with protocol/metaData/add/remove
actions), so tables round-trip without the deltalake crate and simple
append-only tables interoperate with other Delta readers. The change stream
is written with the reference's extra columns `time` and `diff`.
"""

from __future__ import annotations

import json
import time as time_mod
from typing import Any, Dict, List, Optional, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)
from pathway_tpu_torch.io._lake_fs import (
    LakeFS,
    as_fs as _as_fs,
    read_parquet as _read_parquet,
    resolve_lake_fs,
    write_parquet as _write_parquet,
)
from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable

_LOG_DIR = "_delta_log"

_DELTA_TYPES = {
    dt.INT: "long",
    dt.FLOAT: "double",
    dt.STR: "string",
    dt.BOOL: "boolean",
    dt.BYTES: "binary",
}


def _delta_type(dtype) -> str:
    core = dt.unoptionalize(dtype)
    return _DELTA_TYPES.get(core, "string")


def _schema_string(column_types: Dict[str, Any]) -> str:
    return json.dumps(
        {
            "type": "struct",
            "fields": [
                {
                    "name": name,
                    "type": _delta_type(dtype),
                    "nullable": True,
                    "metadata": {},
                }
                for name, dtype in column_types.items()
            ],
        }
    )


def _log_path(version: int) -> str:
    return f"{_LOG_DIR}/{version:020d}.json"


def _list_versions(fs: LakeFS) -> List[int]:
    fs = _as_fs(fs)
    out = []
    for f in fs.listdir(_LOG_DIR):
        if f.endswith(".json"):
            try:
                out.append(int(f[: -len(".json")]))
            except ValueError:
                continue
    return sorted(out)


def _read_actions(fs: LakeFS, version: int) -> List[dict]:
    fs = _as_fs(fs)
    text = fs.read_bytes(_log_path(version)).decode("utf-8")
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _write_commit(fs: LakeFS, actions: List[dict]) -> int:
    versions = _list_versions(fs)
    version = (versions[-1] + 1) if versions else 0
    # every commit carries a timestamp so readers can seek by time
    # (reference: delta.rs:720-733 version_timestamp)
    stamped = [{"commitInfo": {"timestamp": int(time_mod.time() * 1000)}}]
    stamped += [a for a in actions if "commitInfo" not in a]
    payload = "".join(json.dumps(a) + "\n" for a in stamped)
    fs.write_bytes(_log_path(version), payload.encode("utf-8"))
    return version


def _version_timestamp_ms(fs: LakeFS, version: int) -> int | None:
    """Commit timestamp of a version: commitInfo when present, file mtime
    otherwise (reference: snapshot.version_timestamp, delta.rs:708).
    Returns None when the backend has neither (foreign-written table on
    an object store) — callers must NOT treat unknown as epoch 0."""
    try:
        for action in _read_actions(fs, version):
            info = action.get("commitInfo")
            if info and "timestamp" in info:
                return int(info["timestamp"])
    except (OSError, FileNotFoundError):
        pass
    m = fs.mtime(_log_path(version))
    return None if m is None else int(m * 1000)


def _live_files(fs: LakeFS, up_to_version: int | None = None) -> List[str]:
    """Replay the log: the add-minus-remove file set at a version."""
    fs = _as_fs(fs)
    live: Dict[str, bool] = {}
    for v in _list_versions(fs):
        if up_to_version is not None and v > up_to_version:
            break
        for action in _read_actions(fs, v):
            if "add" in action:
                live[action["add"]["path"]] = True
            elif "remove" in action:
                live.pop(action["remove"]["path"], None)
    return list(live)


def _create_table_if_absent(
    fs: LakeFS, column_types: Dict[str, Any], extra_cols: List[tuple]
) -> bool:
    """Version-0 protocol/metaData commit for a fresh table. Returns True
    when the table already existed."""
    fs.makedirs("")
    if _list_versions(fs):
        return True
    _write_commit(
        fs,
        [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            {
                "metaData": {
                    "id": f"pathway-tpu-{int(time_mod.time() * 1000)}",
                    "format": {"provider": "parquet", "options": {}},
                    "schemaString": _schema_string(
                        dict(list(column_types.items()) + extra_cols)
                    ),
                    "partitionColumns": [],
                    "configuration": {},
                    "createdTime": int(time_mod.time() * 1000),
                }
            },
        ],
    )
    return False


class DeltaTableWriter(OutputWriter):
    """Appends one parquet file + one Delta commit per closed engine time
    (reference: data_lake/writer.rs + buffering.rs)."""

    def __init__(
        self,
        uri: str | LakeFS,
        column_types: Dict[str, Any],
        *,
        min_commit_frequency=None,
    ):
        import pyarrow  # noqa: F401  (hard requirement for the lake writers)

        self.fs = uri if isinstance(uri, LakeFS) else resolve_lake_fs(uri)
        self.column_types = dict(column_types)
        _create_table_if_absent(
            self.fs, self.column_types, [("time", dt.INT), ("diff", dt.INT)]
        )
        self._file_counter = 0

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        import pyarrow as pa

        cols: Dict[str, list] = {name: [] for name in self.column_types}
        cols["time"] = []
        cols["diff"] = []
        for ev in events:
            for name in self.column_types:
                cols[name].append(jsonable(ev.values.get(name)))
            cols["time"].append(ev.time)
            cols["diff"].append(ev.diff)
        table = pa.table(cols)
        self._file_counter += 1
        fname = f"part-{int(time_mod.time() * 1e6)}-{self._file_counter:05d}.parquet"
        size = _write_parquet(self.fs, fname, table)
        _write_commit(
            self.fs,
            [
                {
                    "add": {
                        "path": fname,
                        "partitionValues": {},
                        "size": size,
                        "modificationTime": int(time_mod.time() * 1000),
                        "dataChange": True,
                    }
                }
            ],
        )


class DeltaSnapshotWriter(OutputWriter):
    """CDC-style snapshot maintenance: the table always holds the current
    state keyed by ``_id`` (reference: buffering.rs SnapshotColumnBuffer:86,
    delta.rs — append-only batches append a parquet file; any batch with a
    deletion rewrites the full snapshot, removing all prior files in the
    same commit)."""

    def __init__(self, uri: str | LakeFS, column_types: Dict[str, Any]):
        import pyarrow  # noqa: F401

        self.fs = uri if isinstance(uri, LakeFS) else resolve_lake_fs(uri)
        self.column_types = dict(column_types)
        self._file_counter = 0
        # key -> row dict (current table state)
        self.state: Dict[Any, Dict[str, Any]] = {}
        # live parquet files, tracked in memory so a rewrite commit does
        # not replay the whole transaction log (one replay at startup)
        self._live: List[str] = []
        existed = _create_table_if_absent(
            self.fs, self.column_types, [("_id", dt.STR)]
        )
        if existed:
            self._restore_state()

    def _restore_state(self) -> None:
        """Resume onto an existing table: its current content is the
        initial snapshot (reference: buffering.rs new_for_delta_table)."""
        self._live = _live_files(self.fs)
        for fname in self._live:
            try:
                table = _read_parquet(self.fs, fname)
            except FileNotFoundError:
                continue
            for rec in table.to_pylist():
                key = rec.get("_id")
                if key is not None:
                    self.state[key] = rec

    def _new_file(self, rows: List[Dict[str, Any]]) -> tuple[str, int]:
        import pyarrow as pa

        cols: Dict[str, list] = {name: [] for name in self.column_types}
        cols["_id"] = []
        for row in rows:
            for name in self.column_types:
                cols[name].append(jsonable(row.get(name)))
            cols["_id"].append(row["_id"])
        self._file_counter += 1
        fname = (
            f"part-{int(time_mod.time() * 1e6)}-{self._file_counter:05d}"
            ".parquet"
        )
        size = _write_parquet(self.fs, fname, pa.table(cols))
        return fname, size

    @staticmethod
    def _add_action(fname: str, size: int) -> dict:
        return {
            "add": {
                "path": fname,
                "partitionValues": {},
                "size": size,
                "modificationTime": int(time_mod.time() * 1000),
                "dataChange": True,
            }
        }

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        appended: List[Dict[str, Any]] = []
        only_appends = True
        for ev in events:
            key = str(ev.key)
            if ev.diff > 0:
                row = dict(ev.values)
                row["_id"] = key
                self.state[key] = row
                appended.append(row)
            else:
                only_appends = False
                self.state.pop(key, None)
        if not events:
            return
        if only_appends:
            if not appended:
                return
            fname, size = self._new_file(appended)
            self._live.append(fname)
            _write_commit(self.fs, [self._add_action(fname, size)])
            return
        # a deletion occurred: rewrite the whole snapshot in one commit
        actions = [
            {
                "remove": {
                    "path": f,
                    "deletionTimestamp": int(time_mod.time() * 1000),
                    "dataChange": True,
                }
            }
            for f in self._live
        ]
        fname, size = self._new_file(list(self.state.values()))
        self._live = [fname]
        actions.append(self._add_action(fname, size))
        _write_commit(self.fs, actions)


def write(
    table,
    uri: str,
    *,
    schema=None,
    partition_columns=None,
    min_commit_frequency: int | None = 60_000,
    output_table_type: str = "stream_of_changes",
    s3_connection_settings=None,
    name: str | None = None,
    _object_client=None,
    **kwargs,
) -> None:
    """Write to a Delta table (reference: io/deltalake write:466).

    ``output_table_type="stream_of_changes"`` appends the change stream
    with ``time``/``diff`` columns; ``"snapshot"`` maintains the current
    table state keyed by ``_id`` (reference: deltalake/__init__.py:477,
    snapshot_maintenance_on_output). ``uri`` may be a local path or an
    ``s3://`` / ``az://`` object-store location; S3 credentials come from
    ``s3_connection_settings`` (an ``pw.io.s3.AwsS3Settings``), matching
    the reference's storage-options plumbing (delta.rs:215,273)."""
    fs = resolve_lake_fs(
        uri,
        s3_connection_settings=s3_connection_settings,
        _object_client=_object_client,
    )
    column_types = {
        c: table.schema[c].dtype if c in table.schema.keys() else dt.ANY
        for c in table.column_names()
    }
    if output_table_type == "snapshot":
        writer: OutputWriter = DeltaSnapshotWriter(fs, column_types)
    elif output_table_type == "stream_of_changes":
        writer = DeltaTableWriter(
            fs, column_types, min_commit_frequency=min_commit_frequency
        )
    else:
        raise ValueError(
            "output_table_type must be 'stream_of_changes' or 'snapshot', "
            f"got {output_table_type!r}"
        )
    attach_writer(table, writer, name=name)


class _DeltaSubject(ConnectorSubjectBase):
    """Replays the transaction log, then polls for new versions (reference:
    io/deltalake read:290 — streaming mode follows appends)."""

    def __init__(
        self,
        uri,
        schema,
        mode,
        refresh_interval,
        has_diff: bool,
        start_from_timestamp_ms: int | None = None,
    ):
        super().__init__()
        self.fs = uri if isinstance(uri, LakeFS) else resolve_lake_fs(uri)
        self.schema = schema
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.has_diff = has_diff
        self.start_from_timestamp_ms = start_from_timestamp_ms
        self._next_version = 0
        self._seeked = False

    def _seek_to_timestamp(self) -> None:
        """Skip every version at or before the requested timestamp
        (reference: delta.rs:707-741 — load last version below threshold,
        clear the file queue, stream only later changes)."""
        if self.start_from_timestamp_ms is None:
            return
        last_below = None
        for v in _list_versions(self.fs):
            ts = _version_timestamp_ms(self.fs, v)
            # unknown timestamp: conservatively treat the version as
            # after the threshold (re-reading beats silent data loss)
            if ts is not None and ts <= self.start_from_timestamp_ms:
                last_below = v
            else:
                break
        if last_below is not None:
            self._next_version = last_below + 1

    def _emit_file(self, fname: str, sign: int) -> None:
        names = list(self.schema.keys())
        table = _read_parquet(self.fs, fname)
        data = table.to_pylist()
        for rec in data:
            row = {
                k: _coerce_delta(rec.get(k), self.schema[k].dtype)
                for k in names
                if k in rec
            }
            diff = rec.get("diff", 1) if self.has_diff else 1
            if diff * sign > 0:
                self.next(**row)
            else:
                self._remove(row)

    def _apply_new_versions(self) -> bool:
        versions = [v for v in _list_versions(self.fs) if v >= self._next_version]
        changed = False
        for v in versions:
            for action in _read_actions(self.fs, v):
                if "add" in action:
                    self._emit_file(action["add"]["path"], 1)
                    changed = True
                elif "remove" in action:
                    fname = action["remove"]["path"]
                    try:
                        self._emit_file(fname, -1)
                        changed = True
                    except FileNotFoundError:
                        pass  # data file already vacuumed
            self._next_version = v + 1
        return changed

    def run(self) -> None:
        if not self._seeked:
            # persisted state wins over the timestamp seek on resume
            if self._next_version == 0:
                self._seek_to_timestamp()
            self._seeked = True
        while True:
            if self._apply_new_versions():
                self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)

    def _persisted_state(self):
        return {"next_version": self._next_version}

    def _restore_persisted_state(self, state) -> None:
        if state:
            self._next_version = state.get("next_version", 0)


def _coerce_delta(v, dtype):
    core = dt.unoptionalize(dtype)
    if v is None:
        return None
    if core is dt.FLOAT and isinstance(v, int):
        return float(v)
    return v


def read(
    uri: str,
    schema,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 0.5,
    start_from_timestamp_ms: int | None = None,
    s3_connection_settings=None,
    name: str | None = None,
    _has_diff_column: bool = True,
    _object_client=None,
    **kwargs,
):
    """Read a Delta table as a (streaming) table (reference: io/deltalake
    read:290). Rows carrying a `diff` column are interpreted as a change
    stream; otherwise every row is an insertion. With
    ``start_from_timestamp_ms``, only changes committed after the given
    timestamp are read (reference: deltalake/__init__.py:298,
    delta.rs:707). ``uri`` may be local or ``s3://`` / ``az://`` with
    credentials via ``s3_connection_settings``."""
    fs = resolve_lake_fs(
        uri,
        s3_connection_settings=s3_connection_settings,
        _object_client=_object_client,
    )

    def factory():
        return _DeltaSubject(
            fs,
            schema,
            mode,
            refresh_interval,
            _has_diff_column,
            start_from_timestamp_ms=start_from_timestamp_ms,
        )

    return connector_table(schema, factory, mode=mode, name=name)
