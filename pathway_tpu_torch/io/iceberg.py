"""pw.io.iceberg — Apache Iceberg connector (reference:
python/pathway/io/iceberg; Rust implementation
src/connectors/data_lake/iceberg.rs:1-560 — snapshot-based reads + appends
over the Iceberg v2 table spec).

Implemented natively over pyarrow.parquet with spec-shaped v2 table
metadata: `metadata/v<N>.metadata.json` carries table-uuid / schemas with
field ids / partition-specs / sort-orders / sequence numbers /
snapshot-log / metadata-log, each snapshot references a manifest LIST
which references manifest files which reference parquet data files, and
`version-hint.text` points catalogs at the current version.  Manifests
and manifest lists are spec-compliant Avro object container files with
Iceberg field-ids (written by the self-contained codec in `io/_avro.py`);
tables written by older versions with JSON manifests still read.  The
change stream carries the reference's `time`/`diff` columns.
"""

from __future__ import annotations

import io as io_mod
import json
import time as time_mod
from typing import Dict, List, Sequence

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
from pathway_tpu_torch.io.deltalake import _coerce_delta

_META_DIR = "metadata"
_DATA_DIR = "data"

# Avro schema for manifest files (Iceberg spec §Manifests, v2 subset of
# manifest_entry with the spec's field-ids)
_MANIFEST_ENTRY_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "field-id": 1},
        {
            "name": "sequence_number",
            "type": ["null", "long"],
            "field-id": 3,
        },
        {
            "name": "file_sequence_number",
            "type": ["null", "long"],
            "field-id": 4,
        },
        {
            "name": "data_file",
            "field-id": 2,
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "content", "type": "int", "field-id": 134},
                    {"name": "file_path", "type": "string", "field-id": 100},
                    {
                        "name": "file_format",
                        "type": "string",
                        "field-id": 101,
                    },
                    {
                        "name": "partition",
                        "field-id": 102,
                        "type": {
                            "type": "record",
                            "name": "r102",
                            "fields": [],
                        },
                    },
                    {
                        "name": "record_count",
                        "type": "long",
                        "field-id": 103,
                    },
                    {
                        "name": "file_size_in_bytes",
                        "type": "long",
                        "field-id": 104,
                    },
                ],
            },
        },
    ],
}

# Avro schema for manifest lists (Iceberg spec §Manifest Lists, v2 subset)
_MANIFEST_FILE_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "content", "type": "int", "field-id": 517},
        {"name": "sequence_number", "type": "long", "field-id": 515},
        {"name": "min_sequence_number", "type": "long", "field-id": 516},
        {"name": "added_snapshot_id", "type": "long", "field-id": 503},
        {"name": "added_files_count", "type": "int", "field-id": 504},
        {"name": "existing_files_count", "type": "int", "field-id": 505},
        {"name": "deleted_files_count", "type": "int", "field-id": 506},
        {"name": "added_rows_count", "type": "long", "field-id": 512},
        {"name": "existing_rows_count", "type": "long", "field-id": 513},
        {"name": "deleted_rows_count", "type": "long", "field-id": 514},
    ],
}


def _load_manifest_list(fs: LakeFS, path: str) -> List[dict]:
    """Manifest-list entries from an Avro file (spec) or legacy JSON."""
    fs = _as_fs(fs)
    if path.endswith(".avro"):
        from pathway_tpu_torch.io._avro import read_ocf

        _schema, records = read_ocf(fs.read_bytes(path))
        return records
    return json.loads(fs.read_bytes(path)).get("manifests", [])


def _load_manifest_entries(fs: LakeFS, path: str) -> List[dict]:
    """Manifest entries from an Avro file (spec) or legacy JSON."""
    fs = _as_fs(fs)
    if path.endswith(".avro"):
        from pathway_tpu_torch.io._avro import read_ocf

        _schema, records = read_ocf(fs.read_bytes(path))
        return records
    return json.loads(fs.read_bytes(path)).get("entries", [])


def _current_metadata(fs: LakeFS):
    fs = _as_fs(fs)
    versions = sorted(
        int(f.split(".")[0][1:])
        for f in fs.listdir(_META_DIR)
        if f.endswith(".metadata.json")
    )
    if not versions:
        return None, 0
    v = versions[-1]
    return json.loads(fs.read_bytes(f"{_META_DIR}/v{v}.metadata.json")), v


def _iceberg_type(dtype) -> str:
    """pathway dtype -> Iceberg primitive type name (spec §Schemas)."""
    core = dt.unoptionalize(dtype)
    return {
        dt.INT: "long",
        dt.FLOAT: "double",
        dt.BOOL: "boolean",
        dt.STR: "string",
        dt.BYTES: "binary",
        dt.DATE_TIME_NAIVE: "timestamp",
        dt.DATE_TIME_UTC: "timestamptz",
        dt.DURATION: "long",
    }.get(core, "string")


class IcebergTableWriter(OutputWriter):
    """Appends change-stream batches as Iceberg v2 snapshots (reference:
    iceberg.rs snapshot commit path)."""

    def __init__(
        self, uri: str | LakeFS, column_names: Sequence[str], schema=None
    ):
        import pyarrow  # noqa: F401

        self.fs = _as_fs(uri)
        self.column_names = list(column_names)
        self.schema = schema
        self.fs.makedirs(_META_DIR)
        self.fs.makedirs(_DATA_DIR)
        self._counter = 0

    def _schema_fields(self) -> List[dict]:
        fields = []
        for i, name in enumerate(self.column_names, start=1):
            ftype = "string"
            if self.schema is not None and name in set(self.schema.keys()):
                ftype = _iceberg_type(self.schema[name].dtype)
            fields.append(
                {"id": i, "name": name, "required": False, "type": ftype}
            )
        n = len(self.column_names)
        fields.append(
            {"id": n + 1, "name": "time", "required": True, "type": "long"}
        )
        fields.append(
            {"id": n + 2, "name": "diff", "required": True, "type": "long"}
        )
        return fields

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        import uuid

        import pyarrow as pa

        cols: Dict[str, list] = {name: [] for name in self.column_names}
        cols["time"] = []
        cols["diff"] = []
        for ev in events:
            for name in self.column_names:
                cols[name].append(jsonable(ev.values.get(name)))
            cols["time"].append(ev.time)
            cols["diff"].append(ev.diff)
        self._counter += 1
        now_ms = int(time_mod.time() * 1000)
        fname = (
            f"{_DATA_DIR}/data-{int(time_mod.time() * 1e6)}"
            f"-{self._counter:05d}.parquet"
        )
        file_size = _write_parquet(self.fs, fname, pa.table(cols))

        meta, version = _current_metadata(self.fs)
        new_version = version + 1
        if meta is None:
            meta = {
                "format-version": 2,
                "table-uuid": str(uuid.uuid4()),
                "location": self.fs.display_uri,
                "last-sequence-number": 0,
                "last-updated-ms": now_ms,
                "last-column-id": len(self.column_names) + 2,
                "schemas": [
                    {
                        "schema-id": 0,
                        "type": "struct",
                        "fields": self._schema_fields(),
                    }
                ],
                "current-schema-id": 0,
                "partition-specs": [{"spec-id": 0, "fields": []}],
                "default-spec-id": 0,
                "last-partition-id": 999,
                "sort-orders": [{"order-id": 0, "fields": []}],
                "default-sort-order-id": 0,
                "properties": {"write.format.default": "parquet"},
                "current-snapshot-id": -1,
                "snapshots": [],
                "snapshot-log": [],
                "metadata-log": [],
            }
        seq = meta.get("last-sequence-number", 0) + 1
        snapshot_id = uuid.uuid4().int >> 65  # spec: arbitrary unique i64
        parent = meta.get("current-snapshot-id", -1)

        # manifest: one entry per data file, spec-compliant Avro with
        # field-ids (reference: iceberg.rs via iceberg-rust's writers)
        from pathway_tpu_torch.io._avro import write_ocf

        manifest_name = f"{_META_DIR}/manifest-{snapshot_id}.avro"
        manifest_entries = [
            {
                "status": 1,  # ADDED
                "snapshot_id": snapshot_id,
                "sequence_number": seq,
                "file_sequence_number": seq,
                "data_file": {
                    "content": 0,  # DATA
                    "file_path": fname,
                    "file_format": "PARQUET",
                    "partition": {},
                    "record_count": len(events),
                    "file_size_in_bytes": file_size,
                },
            }
        ]
        sink = io_mod.BytesIO()
        write_ocf(
            sink,
            _MANIFEST_ENTRY_SCHEMA,
            manifest_entries,
            metadata={
                "format-version": "2",
                "content": "data",
                "partition-spec-id": "0",
            },
        )
        manifest_len = len(sink.getvalue())
        self.fs.write_bytes(manifest_name, sink.getvalue())

        # manifest list: the spec requires a snapshot's manifest list to
        # represent FULL table state, so carry every prior manifest
        # forward and append the new one
        prior_manifests: List[dict] = []
        cur_id = meta.get("current-snapshot-id", -1)
        for prev_snap in meta.get("snapshots", []):
            if prev_snap["snapshot-id"] == cur_id and "manifest-list" in prev_snap:
                try:
                    prior_manifests = _load_manifest_list(
                        self.fs, prev_snap["manifest-list"]
                    )
                except (OSError, FileNotFoundError):
                    prior_manifests = []
                break
        mlist_name = f"{_META_DIR}/snap-{snapshot_id}-manifest-list.avro"
        new_entry = {
            "manifest_path": manifest_name,
            "manifest_length": manifest_len,
            "partition_spec_id": 0,
            "content": 0,
            "sequence_number": seq,
            "min_sequence_number": seq,
            "added_snapshot_id": snapshot_id,
            "added_files_count": 1,
            "existing_files_count": 0,
            "deleted_files_count": 0,
            "added_rows_count": len(events),
            "existing_rows_count": 0,
            "deleted_rows_count": 0,
        }
        # legacy-JSON entries carried forward may lack newer spec fields
        prior_manifests = [
            {
                "min_sequence_number": e.get("sequence_number", 0),
                "existing_rows_count": 0,
                "deleted_rows_count": 0,
                **e,
            }
            for e in prior_manifests
        ]
        mlist_sink = io_mod.BytesIO()
        write_ocf(
            mlist_sink,
            _MANIFEST_FILE_SCHEMA,
            prior_manifests + [new_entry],
            metadata={
                "format-version": "2",
                "snapshot-id": str(snapshot_id),
                "sequence-number": str(seq),
                "parent-snapshot-id": str(parent),
            },
        )
        self.fs.write_bytes(mlist_name, mlist_sink.getvalue())

        meta["snapshots"].append(
            {
                "snapshot-id": snapshot_id,
                "parent-snapshot-id": parent if parent != -1 else None,
                "sequence-number": seq,
                "timestamp-ms": now_ms,
                "manifest-list": mlist_name,
                "summary": {
                    "operation": "append",
                    "added-data-files": "1",
                    "added-records": str(len(events)),
                },
                "schema-id": 0,
            }
        )
        meta["current-snapshot-id"] = snapshot_id
        meta["last-sequence-number"] = seq
        meta["last-updated-ms"] = now_ms
        meta.setdefault("snapshot-log", []).append(
            {"snapshot-id": snapshot_id, "timestamp-ms": now_ms}
        )
        if version:
            meta.setdefault("metadata-log", []).append(
                {
                    "metadata-file": f"{_META_DIR}/v{version}.metadata.json",
                    "timestamp-ms": now_ms,
                }
            )
        self.fs.write_bytes(
            f"{_META_DIR}/v{new_version}.metadata.json",
            json.dumps(meta).encode("utf-8"),
        )
        # catalogs resolve the current version through the hint file
        self.fs.write_bytes(
            f"{_META_DIR}/version-hint.text",
            str(new_version).encode("ascii"),
        )


def _resolve_table_fs(
    catalog_uri,
    warehouse,
    namespace,
    table_name,
    s3_connection_settings=None,
    _object_client=None,
) -> LakeFS:
    """A table lives under ``warehouse/<namespace...>/<table_name>``.

    The reference's ``catalog_uri`` names an Iceberg REST catalog
    (io/iceberg/__init__.py:52); this implementation speaks the
    warehouse layout directly (local or object store) and refuses to
    silently treat a catalog URL as a directory — pass ``warehouse=``."""
    if warehouse is None:
        if catalog_uri is None:
            raise ValueError(
                "pw.io.iceberg needs warehouse=<path or s3:// uri>"
            )
        if catalog_uri.startswith(("http://", "https://", "thrift://")):
            raise ValueError(
                "pw.io.iceberg needs warehouse=<path or s3:// uri>: this "
                "implementation maintains Iceberg v2 tables directly in a "
                "warehouse (local or object store) and does not speak the "
                f"REST catalog protocol ({catalog_uri!r} is a catalog "
                "URL, which would otherwise be silently treated as a "
                "directory)"
            )
        # path-like catalog_uri: historical alias for warehouse
        warehouse = catalog_uri
    uri = warehouse
    parts = [p for p in (namespace or []) if p]
    if table_name:
        parts.append(table_name)
    if parts:
        uri = uri.rstrip("/") + "/" + "/".join(parts)
    return resolve_lake_fs(
        uri,
        s3_connection_settings=s3_connection_settings,
        _object_client=_object_client,
    )


def write(
    table,
    catalog_uri: str | None = None,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    *,
    warehouse: str | None = None,
    min_commit_frequency: int | None = 60_000,
    s3_connection_settings=None,
    name: str | None = None,
    _object_client=None,
    **kwargs,
) -> None:
    """Append the change stream to an Iceberg table (reference: io/iceberg
    write)."""
    fs = _resolve_table_fs(
        catalog_uri,
        warehouse,
        namespace,
        table_name,
        s3_connection_settings,
        _object_client,
    )
    attach_writer(
        table,
        IcebergTableWriter(
            fs, table.column_names(), schema=getattr(table, "schema", None)
        ),
        name=name,
    )


class _IcebergSubject(ConnectorSubjectBase):
    def __init__(self, uri, schema, mode, refresh_interval):
        super().__init__()
        self.fs = _as_fs(uri)
        self.schema = schema
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._seen_snapshots: set[int] = set()
        # manifest lists carry full table state; incremental reads must
        # dedupe at the data-file level
        self._seen_files: set[str] = set()

    def _poll(self) -> bool:
        meta, _ = _current_metadata(self.fs)
        if meta is None:
            return False
        names = list(self.schema.keys())
        changed = False
        for snap in meta.get("snapshots", []):
            sid = snap["snapshot-id"]
            if sid in self._seen_snapshots:
                continue
            self._seen_snapshots.add(sid)
            data_files: List[str] = []
            if "manifest-list" in snap:
                mlist = _load_manifest_list(self.fs, snap["manifest-list"])
                for mf in mlist:
                    entries = _load_manifest_entries(
                        self.fs, mf["manifest_path"]
                    )
                    for entry in entries:
                        if entry.get("status") != 2:  # not DELETED
                            path = entry["data_file"]["file_path"]
                            if path not in self._seen_files:
                                self._seen_files.add(path)
                                data_files.append(path)
            else:  # pre-spec layout written by older versions
                manifest = json.loads(self.fs.read_bytes(snap["manifest"]))
                data_files = [
                    f
                    for f in manifest.get("data_files", [])
                    if f not in self._seen_files
                ]
                self._seen_files.update(data_files)
            for fname in data_files:
                for rec in _read_parquet(self.fs, fname).to_pylist():
                    row = {
                        k: _coerce_delta(rec.get(k), self.schema[k].dtype)
                        for k in names
                        if k in rec
                    }
                    if rec.get("diff", 1) > 0:
                        self.next(**row)
                    else:
                        self._remove(row)
                changed = True
        return changed

    def run(self) -> None:
        while True:
            if self._poll():
                self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)

    def _persisted_state(self):
        return {
            "seen": sorted(self._seen_snapshots),
            "seen_files": sorted(self._seen_files),
        }

    def _restore_persisted_state(self, state) -> None:
        if state:
            self._seen_snapshots.update(state.get("seen", []))
            self._seen_files.update(state.get("seen_files", []))


def read(
    catalog_uri: str | None = None,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    schema=None,
    *,
    warehouse: str | None = None,
    mode: str = "streaming",
    refresh_interval: float = 0.5,
    s3_connection_settings=None,
    name: str | None = None,
    _object_client=None,
    **kwargs,
):
    """Read an Iceberg table as a (streaming) table (reference: io/iceberg
    read)."""
    fs = _resolve_table_fs(
        catalog_uri,
        warehouse,
        namespace,
        table_name,
        s3_connection_settings,
        _object_client,
    )

    def factory():
        return _IcebergSubject(fs, schema, mode, refresh_interval)

    return connector_table(schema, factory, mode=mode, name=name)
