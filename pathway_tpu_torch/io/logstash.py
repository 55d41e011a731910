"""pw.io.logstash — Logstash sink (reference: python/pathway/io/logstash
write:17 — posts change-stream events to a Logstash HTTP input plugin).

Functional via `requests` (available in this image).
"""

from __future__ import annotations

import json
from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class LogstashWriter(OutputWriter):
    def __init__(self, endpoint: str, *, _post=None):
        self.endpoint = endpoint
        if _post is None:
            import requests

            _post = requests.post
        self._post = _post

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        for ev in events:
            obj = {k: jsonable(v) for k, v in ev.values.items()}
            obj["time"] = ev.time
            obj["diff"] = ev.diff
            self._post(
                self.endpoint,
                data=json.dumps(obj),
                headers={"Content-Type": "application/json"},
            )


def write(table, endpoint: str, *, name: str | None = None, _post=None, **kwargs) -> None:
    """Send each delta as a JSON document to a Logstash HTTP input
    (reference: io/logstash write:17)."""
    attach_writer(table, LogstashWriter(endpoint, _post=_post), name=name)
