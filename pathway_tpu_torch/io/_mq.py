"""Shared message-queue connector machinery (kafka / redpanda / nats / mqtt).

Host-side equivalent of the reference's Rust MQ reader/writer layer
(reference: src/connectors/data_storage.rs — Kafka via rdkafka, NATS via
async-nats, MQTT via rumqttc; topic routing at data_storage.rs:193). The
broker client is abstracted behind `MessageQueueClient`, so each backend
module supplies a thin adapter over its (optional, gated) client library,
and unit tests inject an in-memory fake broker.

Message payload parsing follows the reference's Parser taxonomy
(src/connectors/data_format.rs): raw (bytes), plaintext (utf-8 line),
json (JsonLinesParser:1630), dsv (DsvParser:522).
"""

from __future__ import annotations

import csv as csv_mod
import io as io_mod
import json
import time as time_mod
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)
from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class MessageQueueClient:
    """Minimal broker-client interface.

    poll() -> iterable of (key: bytes|None, payload: bytes, meta: dict)
    messages available now (may block briefly); None when the stream is
    finished (static mode / closed broker).
    """

    def poll(self, timeout: float) -> Optional[Iterable[Tuple[Optional[bytes], bytes, dict]]]:
        raise NotImplementedError

    def produce(self, topic: str, key: Optional[bytes], payload: bytes) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        pass

    def close(self) -> None:
        pass

    # persistence hooks: opaque resume cursor
    def position(self):
        return None

    def seek(self, position) -> None:
        pass


def raw_schema():
    return schema_from_columns(
        {"data": ColumnSchema(name="data", dtype=dt.BYTES)}, name="MQRawSchema"
    )


def plaintext_schema():
    return schema_from_columns(
        {"data": ColumnSchema(name="data", dtype=dt.STR)}, name="MQPlaintextSchema"
    )


def _coerce(v, dtype):
    core = dt.unoptionalize(dtype)
    if core is dt.JSON:
        from pathway_tpu_torch.engine.value import Json

        return v if isinstance(v, Json) else Json(v)
    if core is dt.FLOAT and isinstance(v, int):
        return float(v)
    if isinstance(v, (dict, list)):
        from pathway_tpu_torch.engine.value import Json

        return Json(v)
    return v


def parse_payload(
    payload: bytes,
    format: str,
    schema,
    *,
    delimiter: str = ",",
) -> Iterable[Dict[str, Any]]:
    """Parse one message payload into zero-or-more rows (reference parser
    dispatch: data_format.rs JsonLinesParser:1630 / DsvParser:522 /
    IdentityParser:894)."""
    if format == "raw":
        yield {"data": payload}
        return
    if format == "plaintext":
        yield {"data": payload.decode(errors="replace").rstrip("\n")}
        return
    if format == "json":
        names = set(schema.keys())
        for line in payload.decode(errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            yield {
                k: _coerce(v, schema[k].dtype) for k, v in obj.items() if k in names
            }
        return
    if format in ("dsv", "csv"):
        names = list(schema.keys())
        text = payload.decode(errors="replace")
        reader = csv_mod.reader(io_mod.StringIO(text), delimiter=delimiter)
        for rec in reader:
            if not rec:
                continue
            yield {
                k: _parse_text(v, schema[k].dtype)
                for k, v in zip(names, rec)
            }
        return
    raise ValueError(f"unknown message format {format!r}")


def _parse_text(text, dtype):
    core = dt.unoptionalize(dtype)
    try:
        if core is dt.INT:
            return int(text)
        if core is dt.FLOAT:
            return float(text)
        if core is dt.BOOL:
            return text.strip().lower() in ("true", "1", "yes", "on")
    except ValueError:
        return None
    return text


class MessageQueueSubject(ConnectorSubjectBase):
    """Reader thread: polls the broker client, parses, pushes rows
    (reference: Connector::run reader loop, src/connectors/mod.rs:523)."""

    def __init__(
        self,
        client_factory,
        format: str,
        schema,
        mode: str = "streaming",
        poll_timeout: float = 0.2,
        delimiter: str = ",",
    ):
        super().__init__()
        self.client_factory = client_factory
        self.format = format
        self.schema = schema
        self.mode = mode
        self.poll_timeout = poll_timeout
        self.delimiter = delimiter
        self._client = None
        self._resume_position = None

    def run(self) -> None:
        self._client = self.client_factory()
        if self._resume_position is not None:
            # resume from the persisted cursor instead of replaying the
            # stream (reference: Reader::seek, data_storage.rs:398)
            self._client.seek(self._resume_position)
        from pathway_tpu_torch.internals.backoff import Backoff

        try:
            # transient broker hiccups: shared capped-exponential backoff
            # (surfaced as pathway_connector_retries / _backoff_seconds)
            # before a persistent failure kills the reader.  Full jitter
            # with a per-worker seed decorrelates workers that lost the
            # same broker (no thundering-herd reconnect); max_elapsed
            # bounds the total stall a flapping broker can cause.
            backoff = Backoff(
                base=0.05,
                cap=1.0,
                full_jitter=True,
                max_elapsed=5.0,
                seed=self._worker_id,
            )
            while True:
                try:
                    batch = self._client.poll(self.poll_timeout)
                except Exception:
                    if backoff.exhausted():
                        self.report_retry(0.0)
                        raise
                    delay = backoff.next_delay()
                    self.report_retry(delay)
                    time_mod.sleep(delay)
                    continue
                backoff.reset()
                if batch is None:
                    return  # stream finished
                got = False
                for key, payload, meta in batch:
                    got = True
                    for row in parse_payload(
                        payload,
                        self.format,
                        self.schema,
                        delimiter=self.delimiter,
                    ):
                        self.next(**row)
                if got:
                    self.commit()
                    self._client.commit()
                elif self.mode == "static":
                    return
        finally:
            self._client.close()

    def _persisted_state(self):
        if self._client is None:
            return None
        return {"position": self._client.position()}

    def _restore_persisted_state(self, state) -> None:
        if state and state.get("position") is not None:
            # applied when the client is created
            self._resume_position = state["position"]


def mq_read(
    client_factory,
    *,
    schema=None,
    format: str = "raw",
    mode: str = "streaming",
    name: str | None = None,
    delimiter: str = ",",
    partitioned: bool = False,
):
    if schema is None:
        schema = plaintext_schema() if format == "plaintext" else raw_schema()

    def factory():
        return MessageQueueSubject(
            client_factory, format, schema, mode=mode, delimiter=delimiter
        )

    # partitioned (kafka/redpanda consumer groups): each worker reads a
    # disjoint partition subset and rows are scatter-exchanged to owners.
    # Broadcast subscriptions (nats/mqtt) stay replicated: every worker sees
    # every message and keeps only its key shard.
    return connector_table(
        schema, factory, mode=mode, name=name, partitioned=partitioned
    )


class MessageQueueOutputWriter(OutputWriter):
    """Formats each delta as a message and produces to a topic (reference:
    Kafka/NATS/MQTT writers in data_storage.rs; JsonLines formatter
    data_format.rs:2059).

    Under a persistent run with snapshots enabled, epochs buffer until
    the snapshot-aligned commit: `prepare(F)` durably stages messages
    <= F in the SinkCommitLog before the manifest, `commit(F)` produces
    every staged epoch past the log's committed frontier and then
    advances the marker.  Replayed epochs <= the committed frontier are
    suppressed on resume (they are never re-staged).  Brokers without
    transactions leave one race — a crash between the final produce and
    the marker write re-produces that window on recovery — so the MQ
    sink is exactly-once up to that documented at-least-once edge.
    """

    def __init__(self, client, topic: str, *, format: str = "json", key_column: str | None = None):
        self.client = client
        self.topic = topic
        self.format = format
        self.key_column = key_column
        self.log = None
        self._epochs: list = []

    transactional = True

    def bind_commit_log(self, log) -> None:
        self.log = log

    def _messages(self, events: Sequence[RowEvent]) -> list:
        msgs = []
        for ev in events:
            obj = {k: jsonable(v) for k, v in ev.values.items()}
            obj["time"] = ev.time
            obj["diff"] = ev.diff
            payload = json.dumps(obj).encode()
            key = None
            if self.key_column is not None:
                kv = ev.values.get(self.key_column)
                key = str(jsonable(kv)).encode() if kv is not None else None
            msgs.append((key, payload))
        return msgs

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        msgs = self._messages(events)
        if self.log is None:
            for key, payload in msgs:
                self.client.produce(self.topic, key, payload)
            return
        self._epochs.append((events[0].time, msgs))

    def prepare(self, frontier: int) -> None:
        import pickle

        ready = [(t, m) for t, m in self._epochs if t <= frontier]
        self._epochs = [(t, m) for t, m in self._epochs if t > frontier]
        self.log.stage(frontier, pickle.dumps(ready))

    def commit(self, frontier: int) -> None:
        self._finalize(frontier)

    def _finalize(self, frontier: int) -> None:
        import pickle

        committed = self.log.committed_frontier()
        for _f, blob in self.log.read_staged(committed, frontier):
            for _t, msgs in pickle.loads(blob):
                for key, payload in msgs:
                    self.client.produce(self.topic, key, payload)
        self.client.commit()
        self.log.mark_committed(frontier)

    def recover(self, frontier: int) -> None:
        self._epochs.clear()
        if self.log is None:
            return
        self.log.rollback_to(frontier)
        if frontier >= 0:
            self._finalize(frontier)

    def committed_frontier(self) -> int:
        return -1 if self.log is None else self.log.committed_frontier()

    def flush(self) -> None:
        if self.log is None:
            self.client.commit()

    def close(self) -> None:
        self.client.close()


def mq_write(table, client, topic: str, *, format: str = "json", key_column: str | None = None, name: str | None = None) -> None:
    attach_writer(
        table,
        MessageQueueOutputWriter(client, topic, format=format, key_column=key_column),
        name=name,
    )
