"""On-demand `torch.profiler` capture — answer "why is MFU low" live.

One capture at a time, process-wide: a process has one CUPTI session, so
a second `torch.profiler` trace while one runs fails or steals the
first's events. The guard lives here, every profiler user in the process
holds it (`exclusive`), and both triggers share it:

  * the monitoring server's ``/profile?seconds=N`` route
    (internals/monitoring.py) — profile a RUNNING job without
    restarting it;
  * ``pathway-tpu-torch profile`` (cli.py) — hit that route on a running
    job, or with ``--device`` capture locally while driving a small
    calibration matmul so the trace shows the card's roofline shape.

Captures are bounded (MAX_SECONDS) and written under a fresh directory
(``PATHWAY_PROFILE_DIR`` or a tempdir) as one Chrome trace JSON file:
host ops, plus every CUDA kernel of the process when it has a card (the
trace records the kernels of all threads, the host ops of the capturing
thread). Open it in chrome://tracing or https://ui.perfetto.dev.
Failure to capture (no profiler backend) reports an error dict; it
never takes the serving job down.

A process's first CUDA session sets CUPTI up, which takes seconds and
holds the process's CUDA work meanwhile. `capture` does that in a short
session of its own before its window opens (the result's
``setup_seconds``), so the window covers the seconds asked for; later
captures start at once.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, Optional

MAX_SECONDS = 120.0

_lock = threading.Lock()  # held for the WHOLE capture: the busy guard
_active: Optional[Dict[str, Any]] = None
_last: Optional[Dict[str, Any]] = None
_cuda_ready = False  # CUPTI has been set up in this process


class CaptureBusy(RuntimeError):
    """A capture is already in progress (one at a time, process-wide)."""


_CUPTI_ENV = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


@contextlib.contextmanager
def exclusive(*, teardown: bool = True) -> Iterator[None]:
    """Hold the busy guard for a `torch.profiler` session; raise
    CaptureBusy when another one holds it.

    For the guard's span it also tells the profiler whether to tear CUPTI
    down after each session (`teardown`) and set it up again at the next;
    a caller's own setting wins, and the environment is restored after.
    With CUPTI kept up, some later sessions of a process received no
    kernel record while another thread kept launching; torn down each
    time, every session held its kernels (an H100, torch 2.11, CUDA 12.8).
    torch.profiler keeps CUPTI up only for CUDA graphs, which the port
    does not use."""
    if not _lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already in progress")
    saved = {k: os.environ.get(k) for k in _CUPTI_ENV}
    os.environ.setdefault("TEARDOWN_CUPTI", "1" if teardown else "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "0")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _lock.release()


def _trace_dir(out_dir: Optional[str]) -> str:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        return out_dir
    base = os.environ.get("PATHWAY_PROFILE_DIR")
    if base:
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(prefix="capture-", dir=base)
    return tempfile.mkdtemp(prefix="pathway-profile-")


def capture_active() -> bool:
    return _active is not None


def last_capture() -> Optional[Dict[str, Any]]:
    return _last


def _set_up_cuda(torch) -> float:
    """Set CUPTI up with a short session around one small kernel, so that
    the next session starts at once; the seconds it took."""
    from torch.profiler import ProfilerActivity

    t0 = time.monotonic()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.monotonic() - t0


def profiler_status() -> Dict[str, Any]:
    """Capture state for /status["utilization"]["profiler"]."""
    return {"active": _active, "last": _last}


def capture(
    seconds: float,
    out_dir: Optional[str] = None,
    *,
    workload: Optional[Any] = None,
    teardown: bool = True,
) -> Dict[str, Any]:
    """Run one torch.profiler trace for `seconds`, blocking the caller.

    Raises CaptureBusy when another capture is in flight.  `workload`
    (optional zero-arg callable) is invoked repeatedly during the
    window — used by the CLI's local mode; a server-side capture leaves
    it None and records whatever the job is doing.  `teardown` is the
    session's CUPTI choice (see exclusive).  Returns a dict with the
    trace dir, the trace file and the dir's file count on success, or an
    "error" key when the profiler is unavailable — the monitoring route
    must keep serving either way.  On a card the window opens once CUPTI
    is up: ``started_at`` is its start, and the process's first capture
    adds ``setup_seconds``, the set-up before it."""
    global _active, _last, _cuda_ready
    seconds = max(0.05, min(float(seconds), MAX_SECONDS))
    with exclusive(teardown=teardown):
        try:
            trace_dir = _trace_dir(out_dir)
            started = time.time()
            _active = {
                "trace_dir": trace_dir,
                "seconds": seconds,
                "started_at": started,
            }
            result = dict(_active)
            try:
                import torch
                from torch.profiler import ProfilerActivity

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                    if not _cuda_ready:
                        result["setup_seconds"] = _set_up_cuda(torch)
                        _cuda_ready = True
                        started = result["started_at"] = _active["started_at"] = time.time()
                with torch.profiler.profile(activities=activities) as prof:
                    deadline = time.monotonic() + seconds
                    while time.monotonic() < deadline:
                        if workload is not None:
                            workload()
                        else:
                            time.sleep(min(0.05, seconds))
                path = os.path.join(trace_dir, f"trace-{int(started * 1000)}.json")
                prof.export_chrome_trace(path)
                result["trace_file"] = path
                result["files"] = sum(
                    len(files) for _, _, files in os.walk(trace_dir)
                )
            except Exception as exc:  # noqa: BLE001 — report, never crash the job
                result["error"] = f"{type(exc).__name__}: {exc}"
            result["finished_at"] = time.time()
            _last = result
            return result
        finally:
            _active = None


def capture_local(
    seconds: float, out_dir: Optional[str] = None, *, device=None
) -> Dict[str, Any]:
    """CLI `--device` mode: capture while driving a small calibration
    bf16 matmul chain on `device` (None: the CUDA card, which raises
    where there is none), so the trace contains device activity even
    without a running job attached.  Its session keeps CUPTI up: torn
    down after a session that launched from this thread at this rate, it
    kept the cli's process from exiting on an H100."""
    import torch

    from pathway_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    state: Dict[str, Any] = {}

    def workload() -> None:
        try:
            if "x" not in state:
                gen = torch.Generator(device=dev).manual_seed(0)
                state["x"] = torch.randn(
                    (1024, 1024), generator=gen, device=dev
                ).to(torch.bfloat16)
            x = state["x"]
            # scalar readback: waits for the card, as the JAX package's does
            ((x @ x) @ x).float().sum().item()
        except Exception:  # noqa: BLE001 — trace whatever we can
            time.sleep(0.05)

    return capture(seconds, out_dir, workload=workload, teardown=False)
