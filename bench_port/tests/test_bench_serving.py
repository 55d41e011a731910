"""The RAG cell's plumbing on this host: the server's port lies outside
the kernel's ephemeral range, set-up can tell when the server listens,
and the clients reach the server on 127.0.0.1 whatever proxy the
environment names."""

from __future__ import annotations

import http.server
import json
import socket
import threading

from bench_port.drivers import rag_answer
from bench_port.harness.core import Run
from bench_port.harness.serving import ClosedLoop


def test_server_port_is_outside_the_ephemeral_range():
    lo, hi = rag_answer.ephemeral_ports()
    assert 0 < lo <= hi <= 65535
    for seed in (0, 2**31 + 7, 2**40 + 3):
        port = rag_answer._free_port(seed)
        assert not lo <= port <= hi
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))


def test_listening_tells_a_listening_port_from_a_closed_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        assert not rag_answer.listening("127.0.0.1", port)
        s.listen()
        assert rag_answer.listening("127.0.0.1", port)


def test_ephemeral_range_falls_back_to_the_linux_default(monkeypatch):
    def no_file(*args, **kwargs):
        raise OSError("no /proc here")

    monkeypatch.setattr("builtins.open", no_file)
    assert rag_answer.ephemeral_ports() == (32768, 60999)


class _Answer(http.server.BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 - the handler's name is http.server's
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        out = json.dumps({"response": body["prompt"].upper(), "context_docs": []}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


def test_clients_ignore_a_proxy_in_the_environment(monkeypatch):
    with socket.socket() as s:  # a port nothing listens on: the proxy
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    for name in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.setenv(name, f"http://127.0.0.1:{dead}")
    for name in ("no_proxy", "NO_PROXY"):
        monkeypatch.delenv(name, raising=False)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Answer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        clients = ClosedLoop(Run(0.0), f"http://127.0.0.1:{server.server_address[1]}", [], 10.0)
        reply, error = clients._ask("what is up")
    finally:
        server.shutdown()
        server.server_close()
    assert error is None
    assert reply["response"] == "WHAT IS UP"
