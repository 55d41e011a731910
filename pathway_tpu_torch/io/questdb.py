"""pw.io.questdb — QuestDB sink (reference: python/pathway/io/questdb
write:17; Rust QuestDB writer in src/connectors/data_storage.rs).

Implemented over QuestDB's InfluxDB line protocol (ILP) on a plain TCP
socket — no client library needed, so this sink is fully functional with
the stdlib and unit-testable against a local socket server.
"""

from __future__ import annotations

import socket
from typing import Any, Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


def _escape_tag(s: str) -> str:
    return s.replace("\\", "\\\\").replace(",", "\\,").replace(" ", "\\ ").replace("=", "\\=")


def _field_value(v: Any) -> str:
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        return repr(v)
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


def format_ilp_line(
    table_name: str, values: dict, time: int, diff: int, *, designated_ts: str | None = None
) -> str:
    """One ILP line: measurement fields [timestamp] (QuestDB ILP docs;
    reference writer behavior: appends time/diff columns)."""
    fields = {k: v for k, v in values.items() if v is not None}
    ts = None
    if designated_ts is not None and designated_ts in fields:
        ts = fields.pop(designated_ts)
    parts = [
        f"{k}={_field_value(jsonable(v))}" for k, v in fields.items()
    ]
    parts.append(f"time={time}i")
    parts.append(f"diff={diff}i")
    line = f"{_escape_tag(table_name)} {','.join(parts)}"
    if ts is not None:
        line += f" {int(ts)}"
    return line


class QuestDBWriter(OutputWriter):
    def __init__(self, host: str, port: int, table_name: str, *, designated_ts: str | None = None, _sock=None):
        self.table_name = table_name
        self.designated_ts = designated_ts
        self._sock = _sock or socket.create_connection((host, port))

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        lines = [
            format_ilp_line(
                self.table_name,
                ev.values,
                ev.time,
                ev.diff,
                designated_ts=self.designated_ts,
            )
            for ev in events
        ]
        self._sock.sendall(("\n".join(lines) + "\n").encode())

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def write(
    table,
    connection_string_or_host: str | None = None,
    table_name: str | None = None,
    *,
    host: str | None = None,
    port: int = 9009,
    designated_timestamp=None,
    name: str | None = None,
    _sock=None,
    **kwargs,
) -> None:
    """Stream the change stream into QuestDB over ILP/TCP (reference:
    io/questdb write:17)."""
    host = host or connection_string_or_host or "localhost"
    ts = getattr(designated_timestamp, "name", designated_timestamp)
    attach_writer(
        table,
        QuestDBWriter(host, port, table_name, designated_ts=ts, _sock=_sock),
        name=name,
    )
