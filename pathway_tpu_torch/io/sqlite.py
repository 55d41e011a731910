"""pw.io.sqlite — SQLite CDC reader (reference: python/pathway/io/sqlite
read:19; Rust side StorageType::Sqlite, src/connectors/data_storage.rs).

Fully functional via the stdlib sqlite3 module: polls the table and diffs
consecutive snapshots into insert/delete deltas keyed by the declared
primary key, reproducing the reference's change-data-capture behavior.
"""

from __future__ import annotations

import sqlite3
import time as time_mod
from typing import Any, Dict, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _SqliteSubject(ConnectorSubjectBase):
    def __init__(self, path, table_name, schema, mode, refresh_interval):
        super().__init__()
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._snapshot: Dict[Any, Tuple] = {}

    def _read_rows(self, conn) -> Dict[Any, Tuple]:
        names = list(self.schema.keys())
        pk = self.schema.primary_key_columns() or names
        cols = ", ".join(names)
        rows: Dict[Any, Tuple] = {}
        for rec in conn.execute(f"SELECT {cols} FROM {self.table_name}"):
            row = dict(zip(names, rec))
            key = tuple(row[c] for c in pk)
            rows[key] = tuple(
                _coerce(row[c], self.schema[c].dtype) for c in names
            )
        return rows

    def run(self) -> None:
        names = list(self.schema.keys())
        conn = sqlite3.connect(self.path)
        try:
            while True:
                current = self._read_rows(conn)
                changed = False
                for key, values in current.items():
                    old = self._snapshot.get(key)
                    if old == values:
                        continue
                    if old is not None:
                        self._remove(dict(zip(names, old)))
                    self.next(**dict(zip(names, values)))
                    changed = True
                for key in list(self._snapshot):
                    if key not in current:
                        self._remove(dict(zip(names, self._snapshot[key])))
                        changed = True
                self._snapshot = current
                if changed:
                    self.commit()
                if self.mode == "static":
                    return
                time_mod.sleep(self.refresh_interval)
        finally:
            conn.close()

    def _persisted_state(self):
        return {
            "snapshot": [[list(k), list(v)] for k, v in self._snapshot.items()]
        }

    def _restore_persisted_state(self, state) -> None:
        if state and "snapshot" in state:
            self._snapshot = {
                tuple(k): tuple(v) for k, v in state["snapshot"]
            }


def _coerce(v, dtype):
    core = dt.unoptionalize(dtype)
    if v is None:
        return None
    if core is dt.FLOAT and isinstance(v, int):
        return float(v)
    if core is dt.BYTES and isinstance(v, str):
        return v.encode()
    return v


def read(
    path: str,
    table_name: str,
    schema,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 0.2,
    name: str | None = None,
    **kwargs,
):
    """Stream changes of an SQLite table (reference: io/sqlite read:19).

    The schema's primary key columns identify rows across polls; value
    changes become retraction+insertion pairs.
    """

    def factory():
        return _SqliteSubject(path, table_name, schema, mode, refresh_interval)

    return connector_table(schema, factory, mode=mode, name=name)
