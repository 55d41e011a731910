"""HTTP client connector: poll/stream an HTTP endpoint into a table, and
POST table changes out (reference: python/pathway/io/http/__init__.py client
read/write, _streaming.py)."""

from __future__ import annotations

import json as json_mod
import time as time_mod
import urllib.request
from typing import Any, Callable, Dict, Optional, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _HttpSubject(ConnectorSubjectBase):
    def __init__(self, url, schema, method, headers, payload, refresh_interval, mode):
        super().__init__()
        self.url = url
        self.schema = schema
        self.method = method
        self.headers = headers or {}
        self.payload = payload
        self.refresh_interval = refresh_interval
        self.mode = mode

    def _fetch(self):
        data = None
        if self.payload is not None:
            data = json_mod.dumps(self.payload).encode()
        req = urllib.request.Request(
            self.url, data=data, method=self.method, headers=self.headers
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read()
        try:
            parsed = json_mod.loads(body)
        except json_mod.JSONDecodeError:
            parsed = body.decode(errors="replace")
        names = set(self.schema.keys())
        if isinstance(parsed, list):
            for obj in parsed:
                if isinstance(obj, dict):
                    self.next(**{k: v for k, v in obj.items() if k in names})
                else:
                    self.next(data=obj)
        elif isinstance(parsed, dict):
            self.next(**{k: v for k, v in parsed.items() if k in names})
        else:
            self.next(data=parsed)

    def run(self) -> None:
        from pathway_tpu_torch.internals.backoff import Backoff

        # full jitter + per-worker seed: workers polling the same origin
        # decorrelate their retries; max_elapsed caps the total backoff a
        # dead endpoint can accumulate before the reader fails loudly
        backoff = Backoff(
            base=0.5,
            cap=30.0,
            full_jitter=True,
            max_elapsed=120.0,
            seed=self._worker_id,
        )
        while True:
            try:
                self._fetch()
            except Exception:  # noqa: BLE001 — network/HTTP errors
                if backoff.exhausted():
                    self.report_retry(0.0)
                    raise
                delay = backoff.next_delay()
                self.report_retry(delay)
                time_mod.sleep(delay)
                continue
            backoff.reset()
            self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)


def read(
    url: str,
    *,
    schema=None,
    method: str = "GET",
    headers: Dict[str, str] | None = None,
    payload=None,
    mode: str = "streaming",
    refresh_interval: float = 5.0,
    format: str = "json",
    **kwargs,
):
    if schema is None:
        schema = schema_from_columns(
            {"data": ColumnSchema(name="data", dtype=dt.ANY)},
            name="HttpSchema",
        )
    return connector_table(
        schema,
        lambda: _HttpSubject(
            url, schema, method, headers, payload, refresh_interval, mode
        ),
        mode=mode,
    )


def write(
    table,
    url: str,
    *,
    method: str = "POST",
    headers: Dict[str, str] | None = None,
    format: str = "json",
    **kwargs,
) -> None:
    """POST each change as JSON (reference: io/http write)."""
    column_names = table.column_names()
    headers = dict(headers or {})
    headers.setdefault("Content-Type", "application/json")

    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import SubscribeNode
        from pathway_tpu_torch.io.http._server import _jsonable_payload

        (node,) = nodes

        def on_change(key, row, time, is_addition):
            obj = {c: _jsonable_payload(row[c]) for c in column_names}
            obj["time"] = time
            obj["diff"] = 1 if is_addition else -1
            req = urllib.request.Request(
                url,
                data=json_mod.dumps(obj).encode(),
                method=method,
                headers=headers,
            )
            try:
                urllib.request.urlopen(req, timeout=30).read()
            except Exception as exc:  # noqa: BLE001
                import logging

                logging.getLogger("pathway_tpu_torch").warning(
                    "http write failed: %s", exc
                )

        SubscribeNode(
            ctx.engine, node, on_change=on_change, column_names=column_names
        )

    G.add_sink([table], attach)
