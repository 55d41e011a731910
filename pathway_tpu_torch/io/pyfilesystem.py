"""pw.io.pyfilesystem — read any PyFilesystem FS object (reference:
python/pathway/io/pyfilesystem — _PyFilesystemSubject:29, read:143; polls an
fs.base.FS for files, emitting payload + metadata, with modification and
deletion tracking)."""

from __future__ import annotations

import time as time_mod
from typing import Dict

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _PyFilesystemSubject(ConnectorSubjectBase):
    def __init__(self, source, path, mode, refresh_interval, with_metadata):
        super().__init__()
        self.source = source
        self.path = path
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._seen: Dict[str, tuple] = {}

    def _row(self, path: str, payload: bytes, info) -> dict:
        row = {"data": payload}
        if self.with_metadata:
            from pathway_tpu_torch.engine.value import Json

            row["_metadata"] = Json(
                {
                    "path": path,
                    "size": len(payload),
                    "modified_at": (
                        info.modified.timestamp()
                        if getattr(info, "modified", None)
                        else None
                    ),
                    "seen_at": int(time_mod.time()),
                }
            )
        return row

    def run(self) -> None:
        while True:
            changed = False
            current = set()
            for path in self.source.walk.files(self.path or "/"):
                info = self.source.getinfo(path, namespaces=["details"])
                modified = getattr(info, "modified", None)
                stamp = (modified.timestamp() if modified else None,)
                current.add(path)
                old = self._seen.get(path)
                if old is not None and old[0] == stamp:
                    continue
                payload = self.source.readbytes(path)
                if old is not None:
                    # retract the exact previously-emitted row
                    self._remove(old[1])
                row = self._row(path, payload, info)
                self._seen[path] = (stamp, row)
                self.next(**row)
                changed = True
            for path in list(self._seen):
                if path not in current:
                    stamp, row = self._seen.pop(path)
                    self._remove(row)
                    changed = True
            if changed:
                self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)


def read(
    source,
    *,
    path: str | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    refresh_interval: float = 30.0,
    name: str | None = None,
    **kwargs,
):
    """Read a PyFilesystem FS as a binary-file table (reference:
    io/pyfilesystem read:143). `source` is an fs.base.FS (install the `fs`
    package) or any object with `walk.files`, `getinfo`, `readbytes`."""
    cols = {"data": ColumnSchema(name="data", dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = ColumnSchema(name="_metadata", dtype=dt.JSON)
    schema = schema_from_columns(cols, name="PyFilesystemSchema")

    def factory():
        return _PyFilesystemSubject(source, path, mode, refresh_interval, with_metadata)

    return connector_table(schema, factory, mode=mode, name=name)
