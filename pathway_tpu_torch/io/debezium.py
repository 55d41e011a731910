"""pw.io.debezium — CDC ingestion via Debezium-format messages (reference:
python/pathway/io/debezium read:17; Rust parser
src/connectors/data_format.rs DebeziumMessageParser:1122).

Debezium envelopes carry `payload.before` / `payload.after` and an op code
(`c`reate / `u`pdate / `d`elete / `r`ead-snapshot); updates decompose into a
retraction of `before` plus an insertion of `after` — exactly the engine's
diff semantics.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.io import _mq
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


def parse_debezium_message(payload: bytes | str) -> list[tuple[dict, int]]:
    """Parse one Debezium message into [(row_dict, diff)] (reference:
    DebeziumMessageParser::parse, data_format.rs:1122)."""
    if isinstance(payload, bytes):
        payload = payload.decode(errors="replace")
    obj = json.loads(payload)
    body = obj.get("payload", obj)
    if body is None:
        return []
    op = body.get("op", "c")
    before = body.get("before")
    after = body.get("after")
    out: list[tuple[dict, int]] = []
    if op in ("c", "r"):
        if after is not None:
            out.append((after, 1))
    elif op == "u":
        if before is not None:
            out.append((before, -1))
        if after is not None:
            out.append((after, 1))
    elif op == "d":
        if before is not None:
            out.append((before, -1))
    return out


class _DebeziumSubject(ConnectorSubjectBase):
    def __init__(self, client_factory, schema, mode: str):
        super().__init__()
        self.client_factory = client_factory
        self.schema = schema
        self.mode = mode

    def run(self) -> None:
        client = self.client_factory()
        names = set(self.schema.keys())
        try:
            while True:
                batch = client.poll(0.2)
                if batch is None:
                    return
                got = False
                for key, payload, meta in batch:
                    got = True
                    for row, diff in parse_debezium_message(payload):
                        clean = {
                            k: _mq._coerce(v, self.schema[k].dtype)
                            for k, v in row.items()
                            if k in names
                        }
                        if diff > 0:
                            self.next(**clean)
                        else:
                            self._remove(clean)
                if got:
                    self.commit()
                    client.commit()
                elif self.mode == "static":
                    return
        finally:
            client.close()


def read(
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    *,
    schema=None,
    autocommit_duration_ms: int | None = 1500,
    mode: str = "streaming",
    name: str | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read a Debezium CDC stream as an evolving table (reference:
    io/debezium read:17)."""
    if schema is None:
        raise ValueError("pw.io.debezium.read requires schema")
    if _client_factory is None:
        from pathway_tpu_torch.io.kafka import _ConfluentClient

        def _client_factory():
            return _ConfluentClient(rdkafka_settings, topic_name, for_read=True)

    def factory():
        return _DebeziumSubject(_client_factory, schema, mode)

    return connector_table(schema, factory, mode=mode, name=name)
