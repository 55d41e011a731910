"""The port's cli (`pathway-tpu-torch`, pathway_tpu_torch/cli.py) against
the JAX package's (`pathway-tpu`), on the CPU.

`analyze` runs the same script written for each package and must give the
same codes and exit codes; `airbyte create-source` must write the same
config file; `status`, `top`, `profile` and `explain` run against a live
port monitoring server (`top` renders the frame the JAX package's
renderer draws from the same /status payload); `trace` and `spawn` run a
script through the port. Entry points follow the port's rule:
`profile --device` captures on the card, and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.cli import main as jax_main
from pathway_tpu_torch.cli import main as port_main
from pathway_tpu_torch.internals.monitoring import PrometheusServer
from pathway_tpu_torch.internals.runner import run_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"jax": (jax_main, "pathway_tpu"), "port": (port_main, "pathway_tpu_torch")}

_CLEAN_SCRIPT = """
import {pkg} as pw

t = pw.debug.table_from_rows(pw.schema_from_types(k=str, v=int), [("a", 1)])
res = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))
pw.io.subscribe(res, on_change=lambda *a, **kw: None)
pw.run()
"""

_LINTY_SCRIPT = """
import {pkg} as pw

t = pw.debug.table_from_rows(pw.schema_from_types(g=float, v=int), [(0.5, 1)])
res = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
wide = t.select(g=t.g, v=t.v, w=t.v * 2)
narrow = wide.select(v=wide.v)
pw.io.subscribe(res, on_change=lambda *a, **kw: None)
pw.io.subscribe(narrow, on_change=lambda *a, **kw: None)
pw.run()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _script(tmp_path, body: str, name: str) -> str:
    path = tmp_path / f"{name}.py"
    path.write_text(body.format(pkg=MAINS[name][1]))
    return str(path)


@pytest.fixture
def clear_graphs():
    jpw.G.clear()
    tpw.G.clear()
    yield
    jpw.G.clear()
    tpw.G.clear()


@pytest.mark.parametrize(
    "body, argv",
    [
        (_LINTY_SCRIPT, []),
        (_LINTY_SCRIPT, ["--fail-on", "warning"]),
        (_LINTY_SCRIPT, ["--fail-on", "error"]),
        (_CLEAN_SCRIPT, ["--fail-on", "warning"]),
        (_LINTY_SCRIPT, ["--mesh", "dp=3,tp=5"]),
    ],
)
def test_analyze_json_gives_the_jax_clis_codes(tmp_path, capsys, clear_graphs, body, argv):
    got = {}
    for name, (main, _) in MAINS.items():
        rc = main(["analyze", _script(tmp_path, body, name), "--json", *argv])
        payload = json.loads(capsys.readouterr().out)
        got[name] = (rc, [(f["code"], f["severity"]) for f in payload["findings"]],
                     payload["schema_version"], len(payload["predictions"]))
    assert got["port"] == got["jax"]
    if body is _LINTY_SCRIPT:
        assert "PWT202" in {c for c, _ in got["port"][1]}


def test_analyze_text_list_codes_and_broken_script(tmp_path, capsys, clear_graphs):
    out = {}
    for name, (main, _) in MAINS.items():
        assert main(["analyze", "--list-codes"]) == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] and "PWT601" in out["port"]
    for name, (main, _) in MAINS.items():
        assert main(["analyze", _script(tmp_path, _LINTY_SCRIPT, name)]) == 0
        out[name] = capsys.readouterr().out
    assert "PWT202" in out["port"]
    assert out["port"].replace(f"{tmp_path}/port.py", "S") == out["jax"].replace(
        f"{tmp_path}/jax.py", "S"
    )
    broken = tmp_path / "broken.py"
    broken.write_text("raise RuntimeError('boom')\n")
    for name, (main, _) in MAINS.items():
        assert main(["analyze", str(broken)]) == 2
        assert "boom" in capsys.readouterr().err


def test_analyze_baseline_suppresses_known_findings(tmp_path, capsys, clear_graphs):
    for name, (main, _) in MAINS.items():
        script = _script(tmp_path, _LINTY_SCRIPT, name)
        baseline = str(tmp_path / f"{name}-baseline.json")
        assert main(["analyze", script, "--baseline", baseline, "--fail-on", "warning"]) == 0
        assert os.path.exists(baseline)
        assert main(["analyze", script, "--baseline", baseline, "--fail-on", "warning"]) == 0
    capsys.readouterr()


def test_airbyte_create_source_writes_the_jax_clis_config(tmp_path, monkeypatch):
    import yaml

    from pathway_tpu.io import airbyte as jax_airbyte
    from pathway_tpu_torch.io import airbyte as port_airbyte

    written = {}
    for name, mod in (("jax", jax_airbyte), ("port", port_airbyte)):
        main = MAINS[name][0]
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        # no `docker run`: the spec sample would pull an image
        monkeypatch.setattr(mod, "_sample_config_from_spec", lambda image: {})
        assert main(["airbyte", "create-source", "demo", "--image",
                     "airbyte/source-faker:0.1.4"]) == 0
        written[name] = (where / "connections" / "demo.yaml").read_text()
        # a second create refuses to overwrite it
        assert main(["airbyte", "create-source", "demo"]) == 1
    assert written["port"] == written["jax"]
    config = yaml.safe_load(written["port"])
    assert config["source"]["docker_image"] == "airbyte/source-faker:0.1.4"


def _small_graph():
    t = tpw.debug.table_from_markdown(
        """
        k | v
        a | 1
        a | 2
        b | 5
        """
    )
    return t.groupby(t.k).reduce(t.k, s=tpw.reducers.sum(t.v))


@pytest.fixture
def port_server(monkeypatch, clear_graphs):
    monkeypatch.setenv("PATHWAY_DEVICE_PROBE", "0")
    (cap,) = run_tables(_small_graph())
    server = PrometheusServer(cap.engine, port=_free_port())
    server.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


def test_status_and_top_against_a_running_port_server(port_server, capsys):
    url = f"{port_server}/status"
    assert port_main(["status", "--url", url]) == 0
    text = capsys.readouterr().out
    assert "workers: 1" in text and "worker 0:" in text
    assert port_main(["status", "--url", url, "--json"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["worker_count"] == 1
    assert "profiler" in status["utilization"] and "memory" in status
    assert port_main(["top", "--url", url, "--once"]) == 0
    frame = capsys.readouterr().out
    assert frame.startswith("pathway-tpu-torch top")
    # the JAX package's renderer draws the same frame from the same payload
    from pathway_tpu.internals import trace_tool as jax_trace_tool
    from pathway_tpu_torch.internals import trace_tool

    served = json.loads(json.dumps(status))
    assert trace_tool.render_top(served).replace("pathway-tpu-torch top", "pathway-tpu top") == (
        jax_trace_tool.render_top(served)
    )
    assert trace_tool.render_status(served) == jax_trace_tool.render_status(served)


def test_dead_endpoint_is_a_clean_error_in_both(capsys):
    port = _free_port()
    for name, (main, _) in MAINS.items():
        assert main(["status", "--url", f"http://127.0.0.1:{port}/status"]) == 1
        assert main(["top", "--url", f"http://127.0.0.1:{port}/status", "--once"]) == 1
        assert main(["profile", "--url", f"http://127.0.0.1:{port}", "--seconds", "0.1"]) == 1
        assert main(["explain", "^abc", "--url", f"http://127.0.0.1:{port}"]) == 1
        assert main(["restart", "--url", f"http://127.0.0.1:{port}"]) == 1
    capsys.readouterr()


def test_profile_against_a_running_port_server(port_server, tmp_path, capsys):
    from pathway_tpu_torch.internals import profiler

    out = tmp_path / "capture"
    assert port_main(["profile", "--url", port_server, "--seconds", "0.2", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    last = profiler.last_capture()
    assert last["trace_dir"] == str(out) and last["trace_file"] in text
    assert "chrome://tracing" in text
    with open(last["trace_file"], encoding="utf-8") as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    # /status now carries that capture
    assert port_main(["status", "--url", f"{port_server}/status", "--json"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["utilization"]["profiler"]["last"]["trace_file"] == last["trace_file"]


def test_profile_device_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["profile", "--device", "--seconds", "0.1", "--out", str(tmp_path / "d")])


def test_trace_writes_a_chrome_trace_through_the_port(tmp_path, monkeypatch, clear_graphs, capsys):
    monkeypatch.setenv("PATHWAY_TRACE", "1")
    script = tmp_path / "wc.py"
    script.write_text(
        "import pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_markdown('''\n"
        "word\n"
        "the\n"
        "quick\n"
        "the\n"
        "''')\n"
        "c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())\n"
        f"pw.io.fs.write(c, r'{tmp_path / 'out.jsonl'}', format='json')\n"
        "pw.run(monitoring_level=None)\n"
    )
    out = tmp_path / "trace.json"
    assert port_main(["trace", str(script), "--out", str(out), "--duration", "30"]) == 0
    trace = json.loads(out.read_text())
    assert any(e["ph"] == "X" for e in trace["traceEvents"])
    norun = tmp_path / "norun.py"
    norun.write_text("x = 1\n")
    assert port_main(["trace", str(norun), "--out", str(tmp_path / "t.json")]) == 2
    capsys.readouterr()


def test_spawn_runs_a_program_on_two_processes(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(
        "import os\n"
        "open(os.path.join(os.path.dirname(__file__), 'w' + os.environ['PATHWAY_PROCESS_ID']),"
        " 'w').write(os.environ['PATHWAY_PROCESSES'])\n"
    )
    assert port_main(["spawn", "-n", "2", str(prog)]) == 0
    assert (tmp_path / "w0").read_text() == (tmp_path / "w1").read_text() == "2"


def test_module_entry_point_and_script_name():
    res = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.cli", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage: pathway-tpu-torch")
    for sub in ("analyze", "trace", "status", "top", "profile", "restart", "explain", "airbyte"):
        assert sub in res.stdout
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as f:
        assert 'pathway-tpu-torch = "pathway_tpu_torch.cli:entry"' in f.read()


def test_explain_renders_the_jax_clis_tree(capsys, monkeypatch):
    """`explain` over the same /explain payload renders the same tree."""
    from pathway_tpu.internals import trace_tool as jax_trace_tool
    from pathway_tpu_torch.internals import trace_tool

    payload = {
        "found": True, "key": "^K",
        "tree": {"op": "reduce", "operator": "reduce#3", "key": "^K",
                 "source_offsets": [0, 2], "chains": ["select->filter"],
                 "inputs": [{"op": "input", "operator": "input#1", "key": "^A"}]},
    }
    assert trace_tool.render_explain(payload) == jax_trace_tool.render_explain(payload)
    args = argparse.Namespace(url="http://127.0.0.1:9", port=None, key="^K", json=True)

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps(payload).encode()

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=10.0: _Resp())
    assert trace_tool.main_explain(args) == 0
    assert json.loads(capsys.readouterr().out) == payload
