"""pw.io.nats — NATS connector (reference: python/pathway/io/nats read:24,
write:158; Rust side async-nats in src/connectors/data_storage.rs).

The nats-py client is optional/gated; tests inject `_client_factory`.
"""

from __future__ import annotations

import queue as queue_mod
import threading

from pathway_tpu_torch.io import _mq


class _NatsClient(_mq.MessageQueueClient):
    """Adapter over nats-py run in a private event-loop thread."""

    def __init__(self, uri: str, topic: str, *, for_read: bool):
        try:
            import asyncio

            import nats  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.nats requires the nats-py package; install it or "
                "inject a client via _client_factory"
            )
        self._asyncio = asyncio
        self._nats = nats
        self.uri = uri
        self.topic = topic
        self._messages: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self._conn = self._call(nats.connect(uri))
        if for_read:
            async def _sub():
                async def handler(msg):
                    self._messages.put((None, msg.data, {"subject": msg.subject}))

                await self._conn.subscribe(topic, cb=handler)

            self._call(_sub())

    def _call(self, coro):
        fut = self._asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout=30)

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
        self._call(self._conn.publish(topic, payload))

    def commit(self):
        self._call(self._conn.flush())

    def close(self):
        try:
            self._call(self._conn.drain())
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)


def read(
    uri: str,
    topic: str,
    *,
    schema=None,
    format: str = "raw",
    mode: str = "streaming",
    name: str | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read a NATS subject as a streaming table (reference: io/nats read:24)."""
    if _client_factory is None:

        def _client_factory():
            return _NatsClient(uri, topic, for_read=True)

    return _mq.mq_read(
        _client_factory, schema=schema, format=format, mode=mode, name=name
    )


def write(
    table,
    uri: str,
    topic: str,
    *,
    format: str = "json",
    name: str | None = None,
    _client=None,
    **kwargs,
) -> None:
    """Publish the table's change stream to a NATS subject (reference:
    io/nats write:158)."""
    if _client is None:
        _client = _NatsClient(uri, topic, for_read=False)
    _mq.mq_write(table, _client, topic, format=format, name=name)
