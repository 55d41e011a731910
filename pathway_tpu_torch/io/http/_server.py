"""REST ingress: PathwayWebserver + rest_connector.

Rebuild of the reference HTTP server connector (reference:
python/pathway/io/http/_server.py — PathwayWebserver:482 (aiohttp + CORS +
OpenAPI), rest_connector:696: request→row, response via subscribe). Each
request becomes a stream row keyed by a fresh pointer; the response completes
when the result table emits a row with that key. Counterpart of
pathway_tpu/io/http/_server.py.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from pathway_tpu_torch.engine.value import Json, Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import (
    ColumnSchema,
    Schema,
    schema_from_columns,
)
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import serving as _serving
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)

_request_ids = itertools.count(1)


@dataclass
class EndpointDocumentation:
    """OpenAPI-ish endpoint metadata (reference: _server.py
    EndpointDocumentation:127)."""

    summary: str | None = None
    description: str | None = None
    tags: Sequence[str] = ()
    method_types: Sequence[str] | None = None


class PathwayWebserver:
    """One aiohttp server shared by many rest_connector routes (reference:
    _server.py PathwayWebserver:482)."""

    def __init__(self, host: str, port: int, with_cors: bool = False):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        # route -> (methods, handler, documentation)
        self._routes: Dict[str, tuple] = {}
        self._pending: Dict[Pointer, asyncio.Future] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._start_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def register_route(
        self,
        route: str,
        methods: Sequence[str],
        handler: Callable,
        documentation: EndpointDocumentation | None = None,
    ) -> None:
        self._routes[route] = (
            tuple(m.upper() for m in methods),
            handler,
            documentation,
        )

    def openapi_description_json(self) -> dict:
        paths: dict = {}
        for route, (methods, _h, doc) in self._routes.items():
            entry = {}
            for m in methods:
                entry[m.lower()] = {
                    "summary": getattr(doc, "summary", None) or route,
                    "description": getattr(doc, "description", None) or "",
                    "responses": {"200": {"description": "OK"}},
                }
            paths[route] = entry
        return {
            "openapi": "3.0.3",
            "info": {"title": "pathway_tpu_torch app", "version": "1.0"},
            "paths": paths,
        }

    def _ensure_started(self) -> None:
        """Start the server's thread once, and wait up to 10 s for it to
        listen. A thread still starting is waited for again, never
        joined by a second server on the port (which would die with
        EADDRINUSE); only a thread that has died is replaced."""
        with self._start_lock:
            if self._started.is_set():
                return
            if self._thread is not None and self._thread.is_alive():
                self._started.wait(timeout=10)
                return

            def run_loop():
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                self._loop = loop
                loop.run_until_complete(self._serve())
                loop.run_forever()

            t = self._thread = threading.Thread(
                target=run_loop, daemon=True, name=f"webserver:{self.port}"
            )
            t.start()
            self._started.wait(timeout=10)

    async def _serve(self) -> None:
        from aiohttp import web

        app = web.Application()

        async def dispatch(request: "web.Request"):
            if request.path == "/_schema" or request.path == "/openapi.json":
                return web.json_response(self.openapi_description_json())
            entry = self._routes.get(request.path)
            if entry is None:
                return web.json_response({"error": "not found"}, status=404)
            methods, handler, _doc = entry
            if request.method == "OPTIONS" and self.with_cors:
                return self._with_cors_headers(web.Response(status=204))
            if request.method not in methods:
                return web.json_response(
                    {"error": "method not allowed"}, status=405
                )
            if request.method in ("GET", "DELETE"):
                payload = dict(request.rel_url.query)
            else:
                try:
                    payload = await request.json()
                except json.JSONDecodeError:
                    return web.json_response(
                        {"error": "invalid json"}, status=400
                    )
                if not isinstance(payload, dict):
                    payload = {"value": payload}
            try:
                result = await handler(payload, request)
            except _RequestThrottled as exc:
                import math

                resp = web.json_response(
                    {"error": str(exc), "reason": exc.reason},
                    status=429,
                    headers={
                        "Retry-After": str(
                            max(1, math.ceil(exc.retry_after))
                        )
                    },
                )
                if self.with_cors:
                    resp = self._with_cors_headers(resp)
                return resp
            except _RequestRejected as exc:
                return web.json_response({"error": str(exc)}, status=400)
            resp = web.json_response(result)
            if self.with_cors:
                resp = self._with_cors_headers(resp)
            return resp

        app.router.add_route("*", "/{tail:.*}", dispatch)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        self._started.set()

    def _with_cors_headers(self, resp):
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        return resp

    # -- response plumbing ------------------------------------------------
    def _register_pending(self, key: Pointer) -> asyncio.Future:
        fut = self._loop.create_future()
        self._pending[key] = fut
        return fut

    def complete(self, key: Pointer, payload: Any) -> None:
        if _qtrace.ENABLED:
            _qtrace.tracker().mark(str(key), "emitted")
        fut = self._pending.pop(key, None)
        if fut is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(payload)
            )


class _RequestRejected(Exception):
    pass


class _RequestThrottled(Exception):
    """Admission-control shed: becomes a 429 with a Retry-After header —
    the request never touched the engine or the device."""

    def __init__(self, retry_after: float, reason: str):
        super().__init__(f"overloaded ({reason})")
        self.retry_after = retry_after
        self.reason = reason


class _RestSubject(ConnectorSubjectBase):
    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: Sequence[str],
        schema,
        delete_completed_queries: bool,
        request_validator: Callable | None,
        documentation: EndpointDocumentation | None,
    ):
        super().__init__()
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self.documentation = documentation
        self._payloads: Dict[Pointer, dict] = {}
        # next()/commit() are called from the aiohttp loop (per-query
        # path, delete-completed), and from the serving batcher's flush
        # thread — one lock keeps each commit an atomic engine batch
        self._emit_lock = threading.Lock()
        # this run's serving micro-batcher and the tier that made it
        self._batcher_lock = threading.Lock()
        self._batcher_tier = None
        self._batcher = None
        self._run_ended = False

    def run(self) -> None:
        names = list(self.schema.keys())
        dtypes = self.schema.dtypes()
        defaults = self.schema.default_values()

        async def handler(payload: dict, request):
            # admission first: shedding must cost less than anything it
            # sheds (no validation, no engine row, no device work)
            tier = _serving.tier() if _serving.ENABLED else None
            admitted = False
            # resolved once, whether or not a tier admits: the tenant
            # rides the qtrace span into batched dispatch so exemplars,
            # digests, and the cost ledger can attribute per tenant
            tenant = (
                request.headers.get("X-Tenant", "default")
                if request is not None
                else "default"
            )
            if tier is not None:
                verdict = tier.admission.admit(tenant)
                if verdict is not None:
                    retry_after, reason = verdict
                    raise _RequestThrottled(retry_after, reason)
                admitted = True
            try:
                if self.request_validator is not None:
                    try:
                        validation = self.request_validator(payload)
                        if validation is not None and validation is not True:
                            raise _RequestRejected(str(validation))
                    except _RequestRejected:
                        raise
                    except Exception as exc:  # noqa: BLE001
                        raise _RequestRejected(str(exc)) from exc
                key = ref_scalar("rest", self.route, next(_request_ids))
                if _qtrace.ENABLED:
                    _qtrace.tracker().begin(
                        str(key), route=self.route, key=key, tenant=tenant
                    )
                row = {}
                for name in names:
                    if name in payload:
                        row[name] = _coerce(payload[name], dtypes[name])
                    elif name in defaults:
                        row[name] = defaults[name]
                    else:
                        row[name] = None
                fut = self.webserver._register_pending(key)
                self._payloads[key] = row
                batcher = (
                    self._batcher_in(tier)
                    if tier is not None and tier.window_ms > 0
                    else None
                )
                if batcher is not None:
                    # park on the micro-batcher: concurrent requests
                    # coalesce under ONE commit → one engine batch →
                    # one fused device dispatch for the whole flush
                    batcher.submit((key, row))
                else:
                    with self._emit_lock:
                        self.next(**row, _pw_key=key)
                        self.commit()
                    if _qtrace.ENABLED:
                        _qtrace.tracker().mark(str(key), "enqueued")
                result = await fut
                if _qtrace.ENABLED:
                    _qtrace.tracker().finish(str(key))
                if self.delete_completed_queries:
                    old = self._payloads.pop(key, None)
                    if old is not None:
                        with self._emit_lock:
                            self._remove({**old, "_pw_key": key})
                            self.commit()
                return result
            finally:
                if admitted:
                    tier.admission.release()

        self.webserver.register_route(
            self.route, self.methods, handler, self.documentation
        )
        self.webserver._ensure_started()
        # requests arrive via the aiohttp loop until the run ends
        while not self._wait_for_run_end(60.0):
            pass
        with self._batcher_lock:
            self._run_ended = True
            tier, batcher = self._batcher_tier, self._batcher
            self._batcher_tier = self._batcher = None
        if batcher is not None:
            tier.retire(batcher)

    def _batcher_in(self, tier):
        """This run's micro-batcher, made in `tier` at the first request
        that it parks (and made anew if the tier was reset).  It is the
        connector's own and retired when the run ends: a batcher shared
        by the route would outlive the run, and a later run's server on
        the route would park its requests on this ended connector.  None
        once the run has ended."""
        with self._batcher_lock:
            if self._batcher_tier is not tier and not self._run_ended:
                self._batcher_tier = tier
                self._batcher = tier.batcher(self.route, self._flush_batch)
            return self._batcher

    def _flush_batch(self, items) -> None:
        """Serving-batcher flush: push every parked (key, row) and commit
        ONCE — the engine sees one batch, the index one fused dispatch.
        Runs on the batcher thread."""
        with self._emit_lock:
            for key, row in items:
                self.next(**row, _pw_key=key)
            self.commit()
        if _qtrace.ENABLED:
            keys = [key for key, _row in items]
            tq = _qtrace.tracker()
            tq.mark_keys(keys, "enqueued")
            tq.note_batch_occupancy(keys, len(items))


def _coerce(value, dtype: dt.DType):
    core = dt.unoptionalize(dtype)
    if core is dt.JSON:
        return Json(value)
    if core is dt.FLOAT and isinstance(value, int):
        return float(value)
    if core is dt.INT and isinstance(value, str) and value.isdigit():
        return int(value)
    if isinstance(value, (dict, list)):
        return Json(value)
    return value


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema=None,
    methods: Sequence[str] = ("POST",),
    autocommit_duration_ms: int | None = 1500,
    keep_queries: bool | None = None,
    delete_completed_queries: bool | None = None,
    request_validator: Callable | None = None,
    documentation: EndpointDocumentation | None = None,
):
    """HTTP requests as a stream + a response writer (reference:
    io/http/_server.py rest_connector:696). Returns (queries, response_writer);
    call response_writer(result_table) with a table keyed like `queries`
    whose `result` column is the response payload."""
    if webserver is None:
        if host is None or port is None:
            raise ValueError("provide either webserver= or host=+port=")
        webserver = PathwayWebserver(host, port)
    if delete_completed_queries is None:
        delete_completed_queries = not keep_queries if keep_queries is not None else True
    if schema is None:
        schema = schema_from_columns(
            {"query": ColumnSchema(name="query", dtype=dt.JSON)},
            name="RestSchema",
        )

    subject_holder = []

    def factory():
        subject = _RestSubject(
            webserver,
            route,
            methods,
            schema,
            delete_completed_queries,
            request_validator,
            documentation,
        )
        subject_holder.append(subject)
        return subject

    queries = connector_table(
        schema, factory, mode="streaming", name=f"rest:{route}", exclusive=True
    )

    def response_writer(result_table, **kwargs) -> None:
        from pathway_tpu_torch.io._subscribe import subscribe

        column_names = result_table.column_names()

        def on_change(key, row, time, is_addition):
            if not is_addition:
                return
            if "result" in row:
                payload = _jsonable_payload(row["result"])
            else:
                payload = {c: _jsonable_payload(row[c]) for c in column_names}
            webserver.complete(key, payload)

        # gather results to the worker running the webserver — only that
        # process holds the pending response futures
        subscribe(result_table, on_change=on_change, on_worker=0)

    return queries, response_writer


def _jsonable_payload(v):
    import datetime

    import numpy as np

    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, datetime.timedelta):
        return v.total_seconds()
    if isinstance(v, (list, tuple)):
        return [_jsonable_payload(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable_payload(x) for k, x in v.items()}
    from pathway_tpu_torch.engine.value import Error

    if isinstance(v, Error):
        return None
    return v
