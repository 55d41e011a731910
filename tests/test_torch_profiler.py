"""The port's on-demand profiler (internals/profiler.py) against the JAX
package's, on the CPU.

The counterparts of tests/test_utilization.py's /profile cases: the
clamp, the busy guard (409 on a second /profile) and the error dict, each
beside the JAX module's answer to the same call; a real capture whose
file parses as a Chrome trace; and /status answering with the
`utilization.profiler` key, which raised ImportError while the port had
no profiler module.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import pathway_tpu_torch as tpw
from pathway_tpu.internals import profiler as jax_profiler
from pathway_tpu_torch.internals import profiler, utilization
from pathway_tpu_torch.internals.monitoring import PrometheusServer
from pathway_tpu_torch.internals.runner import run_tables


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get_json(url: str, timeout: float = 60.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _chrome_events(path: str) -> list:
    """The trace's events, after checking the Chrome trace layout."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert isinstance(events, list) and events
    for e in events:
        assert isinstance(e.get("ph"), str) and "name" in e and "pid" in e
    return events


@pytest.fixture
def profile_server(monkeypatch):
    # /profile never touches the engine; keep the periodic device-probe
    # subprocess out of the test
    monkeypatch.setenv("PATHWAY_DEVICE_PROBE", "0")
    server = PrometheusServer(object(), port=_free_port())
    server.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


class _FakeTorchProfile:
    """Stands in for torch.profiler.profile; records its activities."""

    seen: list = []

    def __init__(self, activities):
        _FakeTorchProfile.seen.append(activities)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": []}, f)


class _FakeJaxProfiler:
    @staticmethod
    def start_trace(d):
        os.makedirs(os.path.join(d, "plugins"), exist_ok=True)
        with open(os.path.join(d, "plugins", "t.xplane.pb"), "w") as f:
            f.write("x")

    @staticmethod
    def stop_trace():
        pass


def test_capture_seconds_clamped_to_bounds(monkeypatch, tmp_path):
    import jax

    monkeypatch.setattr(torch.profiler, "profile", _FakeTorchProfile)
    monkeypatch.setattr(jax, "profiler", _FakeJaxProfiler)
    _FakeTorchProfile.seen.clear()
    got = profiler.capture(0.001, str(tmp_path / "port"))
    want = jax_profiler.capture(0.001, str(tmp_path / "jax"))
    assert got["seconds"] == want["seconds"] == pytest.approx(0.05)
    assert got["trace_dir"] == str(tmp_path / "port")
    assert got["files"] == want["files"] == 1
    assert os.path.dirname(got["trace_file"]) == got["trace_dir"]
    # CPU activity always, CUDA only where the process has a card
    (activities,) = _FakeTorchProfile.seen
    assert torch.profiler.ProfilerActivity.CPU in activities
    assert (torch.profiler.ProfilerActivity.CUDA in activities) == torch.cuda.is_available()
    assert profiler.MAX_SECONDS == jax_profiler.MAX_SECONDS == 120.0
    assert max(0.05, min(10_000.0, profiler.MAX_SECONDS)) == 120.0


def test_capture_reports_error_without_crashing(monkeypatch, tmp_path):
    import jax

    class _Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("no backend")

        @staticmethod
        def start_trace(d):
            raise RuntimeError("no backend")

    monkeypatch.setattr(torch.profiler, "profile", _Boom)
    monkeypatch.setattr(jax, "profiler", _Boom)
    got = profiler.capture(0.05, str(tmp_path / "port"))
    want = jax_profiler.capture(0.05, str(tmp_path / "jax"))
    assert "no backend" in got["error"] and "no backend" in want["error"]
    # the route's contract: the same keys as the reference's error dict
    assert set(got) == set(want)
    assert profiler.capture_active() is False
    assert profiler.last_capture() is got


def test_busy_guard_covers_every_profiler_user(tmp_path):
    with profiler.exclusive():
        with pytest.raises(profiler.CaptureBusy):
            profiler.capture(0.05, str(tmp_path / "t"))
        with pytest.raises(profiler.CaptureBusy):
            with profiler.exclusive():
                pass
    # released: a capture runs again
    assert "error" not in profiler.capture(0.05, str(tmp_path / "t"))


def test_every_profiler_session_tears_cupti_down(monkeypatch):
    """The guard asks torch.profiler to tear CUPTI down after each
    session (a session after one that kept it up lost every kernel record
    on the card) unless the session asks to keep it up; a caller's own
    setting wins, and the environment is as it was once the guard is
    released."""
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.delenv("DISABLE_CUPTI_LAZY_REINIT", raising=False)
    with profiler.exclusive():
        assert os.environ["TEARDOWN_CUPTI"] == "1"
        assert os.environ["DISABLE_CUPTI_LAZY_REINIT"] == "0"
    assert "TEARDOWN_CUPTI" not in os.environ
    assert "DISABLE_CUPTI_LAZY_REINIT" not in os.environ
    with profiler.exclusive(teardown=False):
        assert os.environ["TEARDOWN_CUPTI"] == "0"
    assert "TEARDOWN_CUPTI" not in os.environ
    monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    with profiler.exclusive():
        assert os.environ["TEARDOWN_CUPTI"] == "0"
    assert os.environ["TEARDOWN_CUPTI"] == "0"


class _EnvRecordingProfile(torch.profiler.profile):
    """torch.profiler.profile that records TEARDOWN_CUPTI as each session
    starts."""

    teardown: list = []

    def __enter__(self):
        _EnvRecordingProfile.teardown.append(os.environ.get("TEARDOWN_CUPTI"))
        return super().__enter__()


def test_capture_after_capture_local_still_tears_cupti_down(monkeypatch, tmp_path):
    """capture_local's choice to keep CUPTI up holds for its own session
    only: a later capture in the process tears it down again."""
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", _EnvRecordingProfile)
    _EnvRecordingProfile.teardown.clear()
    assert "error" not in profiler.capture_local(0.1, str(tmp_path / "local"), device="cpu")
    assert "error" not in profiler.capture(0.05, str(tmp_path / "later"))
    assert _EnvRecordingProfile.teardown == ["0", "1"]
    assert "TEARDOWN_CUPTI" not in os.environ


def test_first_card_capture_sets_cupti_up_before_its_window(monkeypatch, tmp_path):
    """On a card the process's first capture sets CUPTI up in a session of
    its own before its window opens: the window (started_at, seconds)
    starts after the set-up, whose seconds the result carries; the next
    capture has no set-up. The card is stood in for on the CPU."""
    sessions: list = []

    def set_up(torch_module):
        sessions.append(("setup", time.time()))
        time.sleep(0.2)
        return 0.2

    class _Profile(_FakeTorchProfile):
        def __enter__(self):
            sessions.append(("window", time.time()))
            return self

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(profiler, "_set_up_cuda", set_up)
    monkeypatch.setattr(profiler, "_cuda_ready", False)
    first = profiler.capture(0.05, str(tmp_path / "first"))
    second = profiler.capture(0.05, str(tmp_path / "second"))
    assert [kind for kind, _ in sessions] == ["setup", "window", "window"]
    assert first["setup_seconds"] == 0.2 and "setup_seconds" not in second
    assert sessions[0][1] + 0.2 <= first["started_at"] <= sessions[1][1]
    assert first["finished_at"] >= first["started_at"] + first["seconds"]
    assert profiler.last_capture() is second


def test_profile_endpoint_returns_readable_chrome_trace(profile_server, tmp_path):
    out = tmp_path / "trace"
    code, result = _get_json(f"{profile_server}/profile?seconds=0.2&dir={out}")
    assert code == 200, result
    assert "error" not in result, result
    assert result["trace_dir"] == str(out) and out.is_dir()
    assert result["files"] >= 1
    assert result["seconds"] == pytest.approx(0.2)
    _chrome_events(result["trace_file"])
    last = profiler.last_capture()
    assert last is not None and last["trace_dir"] == str(out)
    assert profiler.capture_active() is False


def test_profile_endpoint_rejects_concurrent_capture(profile_server, tmp_path):
    errors: list = []

    def long_capture():
        try:
            _get_json(f"{profile_server}/profile?seconds=1.5&dir={tmp_path / 'first'}")
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    t = threading.Thread(target=long_capture)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while not profiler.capture_active():
            assert time.monotonic() < deadline, "first capture never started"
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"{profile_server}/profile?seconds=0.1", timeout=10)
        assert exc_info.value.code == 409
        body = json.loads(exc_info.value.read().decode())
        assert "error" in body and body["active"]["trace_dir"] == str(tmp_path / "first")
    finally:
        t.join(timeout=60)
    assert not errors, errors
    assert not t.is_alive()


def test_profile_endpoint_validates_seconds(profile_server):
    for bad in ("abc", "-1", "0"):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"{profile_server}/profile?seconds={bad}", timeout=10)
        assert exc_info.value.code == 400


def test_capture_local_on_the_cpu_traces_the_calibration_matmul(tmp_path, monkeypatch):
    # the CLI's local capture keeps CUPTI up for its session (a teardown
    # hung its process at exit on the card), and leaves the setting as
    # it found it
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", _EnvRecordingProfile)
    _EnvRecordingProfile.teardown.clear()
    result = profiler.capture_local(0.3, str(tmp_path / "local"), device="cpu")
    assert _EnvRecordingProfile.teardown == ["0"]
    assert "TEARDOWN_CUPTI" not in os.environ
    assert "error" not in result, result
    names = {e["name"] for e in _chrome_events(result["trace_file"])}
    assert names & {"aten::mm", "aten::matmul"}, sorted(names)[:20]


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


def test_status_answers_with_the_profiler_key(monkeypatch, tmp_path):
    """The repaired fault: utilization_status() and /status answer with
    `utilization.profiler`, which holds the last capture."""
    monkeypatch.setenv("PATHWAY_DEVICE_PROBE", "0")
    captured = profiler.capture(0.05, str(tmp_path / "t"))
    status = utilization.utilization_status()
    assert status["profiler"] == profiler.profiler_status()
    assert status["profiler"]["last"] == captured
    json.dumps(status)
    tpw.G.clear()
    (cap,) = run_tables(_small_graph())
    server = PrometheusServer(cap.engine, port=_free_port())
    server.start()
    try:
        code, body = _get_json(f"http://127.0.0.1:{server.port}/status")
    finally:
        server.stop()
        tpw.G.clear()
    assert code == 200
    assert body["utilization"]["profiler"]["last"] == json.loads(json.dumps(captured))
    assert body["utilization"]["profiler"]["active"] is None
    assert "memory" in body and body["worker_count"] == 1
