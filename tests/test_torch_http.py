"""pw.io.http and the MCP server through the port against the JAX package.

Each package serves the same app on its own free port on 127.0.0.1, and
the same requests go to both: the port's status codes, JSON bodies and
CORS / Retry-After headers must equal the JAX package's. The OpenAPI
description names its package in its title, which is read as the JAX
package's. The checks are those of tests/test_http_server.py (OpenAPI,
GET coercion, CORS, 404, 400) and the rest of the server's dispatch
rules: 405, OPTIONS 204 under CORS, 429 with Retry-After on a tenant's
limit. Then the MCP server's JSON-RPC round trip over a DocumentStore
tool, and the http client connector (pw.io.http.read / write) against a
local standard-library server.

Every test terminates the background engines it started; serving runs
on a daemon thread, as in the JAX package's tests.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from importlib import import_module

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import runner as jax_runner
from pathway_tpu_torch.internals import runner as port_runner
from test_torch_docstore import _docs_with_metadata, _knn_factory

PACKAGES = {"jax": jpw, "port": tpw}
RUNNERS = {"jax": jax_runner, "port": port_runner}
_HEADERS = (
    "Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
    "Access-Control-Allow-Headers", "Content-Type", "Retry-After",
)


def _mod(name: str, path: str):
    return import_module(f"{PACKAGES[name].__name__}.{path}")


@pytest.fixture(autouse=True)
def _fresh_serving_tiers():
    """The JAX package's serving tier keeps one micro-batcher per REST
    route for the life of the process, bound to the first connector on
    that route (the port's connector retires its own at its run's end). A
    fresh tier after each test keeps a later server on the same route (in
    this file, or in another file run by this worker) off this test's
    engines."""
    yield
    for name in PACKAGES:
        _mod(name, "internals.serving").reset_for_tests()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None, headers=None):
    """(status, JSON body or None, the headers that the dispatch sets)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        resp = urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        raw = resp.read()
        status = resp.status if hasattr(resp, "status") else resp.code
        return status, json.loads(raw) if raw else None, {h: resp.headers.get(h) for h in _HEADERS}


def _start(name, build, route="/double"):
    """Build the app on the package's parse graph, pw.run it on a daemon
    thread and return (port, engine) once `GET {route}?value=1` answers."""
    pw = PACKAGES[name]
    port = _free_port()
    pw.G.clear()
    build(pw, port)
    threading.Thread(target=pw.run, daemon=True).start()
    deadline = time.time() + 60
    while True:
        try:
            if _request(port, "GET", f"{route}?value=1")[0] == 200:
                break
        except (urllib.error.URLError, ConnectionError):
            pass
        assert time.time() < deadline, f"the {name} webserver did not come up"
        time.sleep(0.1)
    return port, RUNNERS[name].last_engine()


def _double_route(name, *, route="/double", with_cors=True):
    """A rest_connector route (GET and POST) answering 2 x value. Apps
    alive at once in one package take distinct routes: the JAX package's
    serving tier keeps one micro-batcher per route, process-wide."""
    srv = _mod(name, "io.http._server")

    def build(pw, port):
        class QuerySchema(pw.Schema):
            value: int

        webserver = srv.PathwayWebserver("127.0.0.1", port, with_cors=with_cors)
        queries, writer = srv.rest_connector(
            webserver=webserver, route=route, schema=QuerySchema,
            methods=("GET", "POST"), delete_completed_queries=False,
        )
        writer(queries.select(result=pw.this.value * 2))

    return build


def _double_app(name, *, route="/double", with_cors=True):
    return _start(name, _double_route(name, route=route, with_cors=with_cors), route)


@pytest.fixture(scope="module")
def double_apps():
    apps = {name: _double_app(name) for name in PACKAGES}
    yield {name: port for name, (port, _eng) in apps.items()}
    for _port, eng in apps.values():
        eng.terminate_flag.set()


# request -> (method, path, body, the expected status)
REQUESTS = {
    "schema": ("GET", "/_schema", None, 200),
    "openapi": ("GET", "/openapi.json", None, 200),
    "get-coerces-the-query-string": ("GET", "/double?value=21", None, 200),
    "post": ("POST", "/double", b'{"value": 5}', 200),
    "post-extra-field": ("POST", "/double", b'{"value": 7, "other": [1, 2]}', 200),
    "invalid-json": ("POST", "/double", b"{not-json", 400),
    "unknown-route": ("GET", "/nope", None, 404),
    "put-not-allowed": ("PUT", "/double", b"{}", 405),
    "delete-not-allowed": ("DELETE", "/double?value=3", None, 405),
    "options-under-cors": ("OPTIONS", "/double", None, 204),
}


@pytest.mark.parametrize("request_id", sorted(REQUESTS))
def test_webserver_answers_as_the_jax_one(double_apps, request_id):
    method, path, body, status = REQUESTS[request_id]
    got, want = (
        _request(double_apps[name], method, path, body) for name in ("port", "jax")
    )
    if request_id in ("schema", "openapi"):
        title = got[1]["info"]["title"]
        assert title == "pathway_tpu_torch app"
        got[1]["info"]["title"] = want[1]["info"]["title"]
        assert "/double" in got[1]["paths"] and set(got[1]["paths"]["/double"]) == {"get", "post"}
    assert got == want
    assert got[0] == status
    if status in (200, 204) and request_id not in ("schema", "openapi"):
        assert got[2]["Access-Control-Allow-Origin"] == "*"
    if request_id == "get-coerces-the-query-string":
        assert got[1] == 42


def test_a_route_served_again_in_a_later_run_answers():
    """A server on a route whose first server's run has ended answers: a
    REST connector parks requests on a micro-batcher of its own run, whose
    thread exits when the run ends. The JAX package keeps one batcher per
    route for the life of the process, so there the second server's
    requests go to the ended run and never return."""
    first_port, first = _start("port", _double_route("port", route="/again"), "/again")
    assert _request(first_port, "GET", "/again?value=4")[:2] == (200, 8)
    (first_batcher,) = [t for t in threading.enumerate() if t.name == "serve-batch:/again"]
    first.terminate_flag.set()
    first_batcher.join(30)
    assert not first_batcher.is_alive(), "the ended run's micro-batcher thread still runs"
    port, engine = _start("port", _double_route("port", route="/again"), "/again")
    try:
        assert _request(port, "GET", "/again?value=21")[:2] == (200, 42)
        assert _request(port, "POST", "/again", b'{"value": 5}')[:2] == (200, 10)
        # the tier still counts the retired batcher's queries: two a run
        # from _start and the first, two more here
        assert _mod("port", "internals.serving").tier().status()["batched_queries"] >= 5
    finally:
        engine.terminate_flag.set()


def test_webserver_without_cors_sets_no_cors_headers():
    out = {}
    for name in PACKAGES:
        port, eng = _double_app(name, route="/plain", with_cors=False)
        try:
            out[name] = [
                _request(port, "POST", "/plain", b'{"value": 4}'),
                _request(port, "OPTIONS", "/plain"),
            ]
        finally:
            eng.terminate_flag.set()
    assert out["port"] == out["jax"]
    (ok, _, headers), (options, _, _) = out["port"]
    assert ok == 200 and headers["Access-Control-Allow-Origin"] is None
    assert options == 405  # OPTIONS is served only under CORS


def test_mcp_tool_round_trip_matches_jax():
    """McpServer over a DocumentStore tool: initialize, tools/list,
    tools/call (the tool's answer is posted back through the server's own
    route) and an unknown method."""
    out = {}
    for name, pw in PACKAGES.items():
        mcp = _mod(name, "xpacks.llm.mcp_server")
        port = _free_port()
        pw.G.clear()
        docs = _docs_with_metadata(
            pw, [("apple pie recipe", "/docs/apple.txt"), ("banana bread", "/docs/banana.txt")]
        )
        store = _mod(name, "xpacks.llm.document_store").DocumentStore(
            docs, retriever_factory=_knn_factory(name)
        )
        server = mcp.McpServer(mcp.McpConfig(name="test-mcp", port=port))
        server.tool("retrieve", request_handler=store.retrieve_query,
                    schema=store.RetrieveQuerySchema, description="search the docs")
        threading.Thread(target=pw.run, daemon=True).start()

        def rpc(method, params=None):
            payload = {"jsonrpc": "2.0", "id": 7, "method": method}
            if params is not None:
                payload["params"] = params
            return _request(port, "POST", "/mcp", json.dumps(payload).encode())[1]

        try:
            deadline = time.time() + 60
            while True:
                try:
                    init = rpc("initialize")
                    call = rpc("tools/call", {"name": "retrieve",
                                              "arguments": {"query": "apple pie recipe", "k": 1}})
                    if "not found" not in call["result"]["content"][0]["text"]:
                        break
                except (urllib.error.URLError, ConnectionError):
                    pass
                assert time.time() < deadline, f"the {name} MCP server did not come up"
                time.sleep(0.1)
            out[name] = [init, rpc("tools/list"), call, rpc("resources/list")]
        finally:
            RUNNERS[name].last_engine().terminate_flag.set()
            pw.G.clear()
    got, want = out["port"], out["jax"]
    got_hits = json.loads(got[2]["result"]["content"][0]["text"])
    want_hits = json.loads(want[2]["result"]["content"][0]["text"])
    assert [h["text"] for h in got_hits] == [h["text"] for h in want_hits] == ["apple pie recipe"]
    np.testing.assert_allclose(
        [h["score"] for h in got_hits], [h["score"] for h in want_hits], atol=1e-5, rtol=0
    )
    assert [got[i] for i in (0, 1, 3)] == [want[i] for i in (0, 1, 3)]
    assert got[0]["result"]["serverInfo"]["name"] == "test-mcp"
    assert [t["name"] for t in got[1]["result"]["tools"]] == ["retrieve"]
    assert got[3]["error"]["code"] == -32601


class _Endpoint(BaseHTTPRequestHandler):
    """GET answers the server's `rows`; POST appends its JSON to `posts`."""

    def do_GET(self):  # noqa: N802 — the http.server hook
        body = json.dumps(self.server.rows).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        length = int(self.headers["Content-Length"])
        self.server.posts.append(json.loads(self.rfile.read(length)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def endpoint():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Endpoint)
    server.rows = [{"name": "a", "n": 1}, {"name": "b", "n": 2}, {"name": "c", "n": 3}]
    server.posts = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_client_read_and_write_match_jax(endpoint):
    """pw.io.http.read polls the endpoint once (static mode) and
    pw.io.http.write posts each change of a derived table back to it."""
    url = f"http://127.0.0.1:{endpoint.server_address[1]}/rows"
    out = {}
    for name, pw in PACKAGES.items():
        endpoint.posts.clear()
        pw.G.clear()
        try:
            rows = pw.io.http.read(
                url, schema=pw.schema_from_types(name=str, n=int), mode="static"
            )
            doubled = rows.select(name=pw.this.name, n2=pw.this.n * 2)
            pw.io.http.write(doubled, url)
            pw.run()
        finally:
            pw.G.clear()
        out[name] = sorted(endpoint.posts, key=lambda p: p["name"])
    assert out["port"] == out["jax"]
    assert [(p["name"], p["n2"], p["diff"]) for p in out["port"]] == [
        ("a", 2, 1), ("b", 4, 1), ("c", 6, 1)
    ]


def test_tenant_limit_answers_429_with_retry_after(monkeypatch):
    """A tenant over its token bucket gets 429 with Retry-After, another
    tenant is served (the serving tier's admission at REST ingress)."""
    monkeypatch.setenv("PATHWAY_SERVE_TENANT_RATE", "0.2")
    monkeypatch.setenv("PATHWAY_SERVE_TENANT_BURST", "1")
    monkeypatch.setenv("PATHWAY_SERVE_BATCH_WINDOW_MS", "1")
    out = {}
    try:
        for name in PACKAGES:
            serving = _mod(name, "internals.serving")
            serving.reset_for_tests()
            port, eng = _double_app(name, route="/limited")
            try:
                out[name] = [
                    _request(port, "POST", "/limited", json.dumps({"value": v}).encode(),
                             {"X-Tenant": tenant})
                    for v, tenant in ((2, "alice"), (3, "alice"), (4, "bob"))
                ]
                out[name].append(serving.tier().admission.sheds["tenant_limit"])
            finally:
                eng.terminate_flag.set()
    finally:
        monkeypatch.undo()  # before the fixture's fresh tiers read the knobs
    assert out["port"] == out["jax"]
    (ok, body, _), (shed, reason, headers), (other, _, _), sheds = out["port"]
    assert (ok, body, other, sheds) == (200, 4, 200, 1)
    assert shed == 429 and reason["reason"] == "tenant_limit"
    assert int(headers["Retry-After"]) >= 1
