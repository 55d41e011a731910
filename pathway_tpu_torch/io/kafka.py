"""pw.io.kafka — Kafka connector (reference: python/pathway/io/kafka —
read:29, simple_read:261, write:360; Rust side: rdkafka-backed
StorageType::Kafka, src/connectors/data_storage.rs).

The broker client library (confluent_kafka / kafka-python) is optional and
gated; tests and embedded uses may inject any `MessageQueueClient` via the
private `_client_factory` / `_client` parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

from pathway_tpu_torch.io import _mq


def _load_confluent():
    try:
        import confluent_kafka  # type: ignore

        return confluent_kafka
    except ImportError:
        return None


def _load_kafka_python():
    try:
        import kafka  # type: ignore

        return kafka
    except ImportError:
        return None


class _ConfluentClient(_mq.MessageQueueClient):
    """Adapter over confluent_kafka Consumer/Producer."""

    def __init__(self, rdkafka_settings: dict, topics, *, for_read: bool):
        ck = _load_confluent()
        if ck is None:
            raise ImportError(
                "pw.io.kafka requires the confluent_kafka (or kafka-python) "
                "package; install one, or inject a client via _client_factory"
            )
        self._ck = ck
        self.topics = [topics] if isinstance(topics, str) else list(topics or [])
        if for_read:
            self.consumer = ck.Consumer(rdkafka_settings)
            self.consumer.subscribe(self.topics)
            self.producer = None
        else:
            self.consumer = None
            self.producer = ck.Producer(rdkafka_settings)

    def poll(self, timeout: float):
        msg = self.consumer.poll(timeout)
        if msg is None:
            return []
        err = msg.error()
        if err is not None:
            if err.code() == self._ck.KafkaError._PARTITION_EOF:
                return []  # benign end-of-partition event
            raise RuntimeError(f"kafka consumer error: {err}")
        return [(msg.key(), msg.value(), {"partition": msg.partition(), "offset": msg.offset()})]

    def produce(self, topic, key, payload):
        self.producer.produce(topic, value=payload, key=key)

    def commit(self):
        if self.producer is not None:
            self.producer.flush()

    def close(self):
        if self.consumer is not None:
            self.consumer.close()
        if self.producer is not None:
            self.producer.flush()


def read(
    rdkafka_settings: dict,
    topic: str | list[str] | None = None,
    *,
    schema=None,
    format: str = "raw",
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    topic_names: list[str] | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read a Kafka topic as a streaming table (reference: io/kafka read:29).

    format: "raw" (bytes in `data`), "plaintext", "json", "dsv".
    """
    topics = topic if topic is not None else topic_names
    if isinstance(topics, str):
        topics = [topics]
    if _client_factory is None:

        def _client_factory():
            return _ConfluentClient(rdkafka_settings, topics, for_read=True)

    return _mq.mq_read(
        _client_factory,
        schema=schema,
        format=format,
        mode=mode,
        name=name,
        partitioned=True,
    )


def simple_read(
    server: str,
    topic: str,
    *,
    read_only_new: bool = False,
    schema=None,
    format: str = "raw",
    mode: str = "streaming",
    name: str | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read with minimal config (reference: io/kafka simple_read:261)."""
    settings = {
        "bootstrap.servers": server,
        "group.id": "$GROUP_NAME",
        "session.timeout.ms": "6000",
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(
        settings,
        topic,
        schema=schema,
        format=format,
        mode=mode,
        name=name,
        _client_factory=_client_factory,
    )


def write(
    table,
    rdkafka_settings: dict,
    topic_name: str,
    *,
    format: str = "json",
    key=None,
    name: str | None = None,
    _client=None,
    **kwargs,
) -> None:
    """Write the table's change stream to a Kafka topic (reference:
    io/kafka write:360; JsonLines formatter data_format.rs:2059)."""
    if _client is None:
        _client = _ConfluentClient(rdkafka_settings, topic_name, for_read=False)
    key_column = getattr(key, "name", key) if key is not None else None
    # default sink name carries the topic: the exactly-once commit log is
    # keyed on it, and two unnamed sinks must not share a log
    _mq.mq_write(
        table,
        _client,
        topic_name,
        format=format,
        key_column=key_column,
        name=name or f"kafka:{topic_name}",
    )
