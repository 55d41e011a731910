"""pw.io.mqtt — MQTT connector (reference: python/pathway/io/mqtt read:22,
write:167; Rust side rumqttc in src/connectors/data_storage.rs).

The paho-mqtt client is optional/gated; tests inject `_client_factory`.
"""

from __future__ import annotations

import queue as queue_mod

from pathway_tpu_torch.io import _mq


class _PahoClient(_mq.MessageQueueClient):
    def __init__(self, uri: str, topic: str, *, for_read: bool, qos: int = 1):
        try:
            import paho.mqtt.client as paho  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.mqtt requires the paho-mqtt package; install it or "
                "inject a client via _client_factory"
            )
        from urllib.parse import urlparse

        self.topic = topic
        self.qos = qos
        self._messages: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        parsed = urlparse(uri if "//" in uri else f"mqtt://{uri}")
        self._client = paho.Client()
        if parsed.username:
            self._client.username_pw_set(parsed.username, parsed.password)
        self._client.connect(parsed.hostname or "localhost", parsed.port or 1883)
        if for_read:
            def on_message(client, userdata, msg):
                self._messages.put((None, msg.payload, {"topic": msg.topic}))

            self._client.on_message = on_message
            self._client.subscribe(topic, qos=qos)
        self._client.loop_start()

    def poll(self, timeout: float):
        out = []
        try:
            out.append(self._messages.get(timeout=timeout))
            while True:
                out.append(self._messages.get_nowait())
        except queue_mod.Empty:
            pass
        return out

    def produce(self, topic, key, payload):
        self._client.publish(topic, payload, qos=self.qos)

    def close(self):
        self._client.loop_stop()
        self._client.disconnect()


def read(
    uri: str,
    topic: str,
    *,
    schema=None,
    format: str = "raw",
    mode: str = "streaming",
    qos: int = 1,
    name: str | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read an MQTT topic as a streaming table (reference: io/mqtt read:22)."""
    if _client_factory is None:

        def _client_factory():
            return _PahoClient(uri, topic, for_read=True, qos=qos)

    return _mq.mq_read(
        _client_factory, schema=schema, format=format, mode=mode, name=name
    )


def write(
    table,
    uri: str,
    topic: str,
    *,
    format: str = "json",
    qos: int = 1,
    name: str | None = None,
    _client=None,
    **kwargs,
) -> None:
    """Publish the table's change stream to an MQTT topic (reference:
    io/mqtt write:167)."""
    if _client is None:
        _client = _PahoClient(uri, topic, for_read=False, qos=qos)
    _mq.mq_write(table, _client, topic, format=format, name=name)
