"""pw.io.pubsub — Google Pub/Sub sink (reference: python/pathway/io/pubsub
write:50, buffered via _OutputBuffer:12 — publishes each delta as a message
with time/diff attributes)."""

from __future__ import annotations

import json
from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class PubSubWriter(OutputWriter):
    def __init__(self, publisher, topic_path: str):
        self.publisher = publisher
        self.topic_path = topic_path
        self._futures = []

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        for ev in events:
            payload = json.dumps(
                {k: jsonable(v) for k, v in ev.values.items()}
            ).encode()
            fut = self.publisher.publish(
                self.topic_path,
                payload,
                time=str(ev.time),
                diff=str(ev.diff),
            )
            self._futures.append(fut)

    def flush(self) -> None:
        for fut in self._futures:
            result = getattr(fut, "result", None)
            if result:
                result()
        self._futures.clear()


def write(
    table,
    publisher=None,
    project_id: str | None = None,
    topic_id: str | None = None,
    *,
    name: str | None = None,
    **kwargs,
) -> None:
    """Publish change-stream deltas to a Pub/Sub topic (reference:
    io/pubsub write:50). `publisher` may be any object with
    publish(topic, data, **attrs) — the google-cloud-pubsub PublisherClient
    if installed, or a fake in tests."""
    if publisher is None:
        try:
            from google.cloud import pubsub_v1  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.pubsub requires google-cloud-pubsub; install it or "
                "pass a publisher client"
            )
        publisher = pubsub_v1.PublisherClient()
    topic_path = (
        publisher.topic_path(project_id, topic_id)
        if hasattr(publisher, "topic_path") and project_id
        else (topic_id or "")
    )
    attach_writer(table, PubSubWriter(publisher, topic_path), name=name)
