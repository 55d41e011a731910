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

The profiler records the host ops of the capturing thread only, which
sleeps; so the capture adds, on the trace's own clock, every span of the
host-span ring (internals/tracing.py: the pipeline, decoder and ingest
spans of every thread) and every finished query span (internals/
qtrace.py) of its window, as complete events of a "host spans" process
with one row per thread (and per overlap: a span that does not nest in
its thread's row takes a row of its own). Anchor `record_function`s at
the window's opening, each between two `time.perf_counter` reads, map
the one clock onto the other: the anchor read most tightly sets it.

A process's first CUDA session sets CUPTI up, which takes seconds and
holds the process's CUDA work meanwhile. `capture` does that in a short
session of its own before its window opens (the result's
``setup_seconds``), so the window covers the seconds asked for; later
captures start at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

MAX_SECONDS = 120.0
ANCHOR = "pathway.capture_anchor"
ANCHORS = 3  # the tightest of these brackets sets the clocks' offset
HOST_SPANS_PID = 9998  # internals/qtrace.py's query rows take 9999

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
                    brackets = []
                    for _ in range(ANCHORS):
                        t_a = time.perf_counter()
                        with torch.profiler.record_function(ANCHOR):
                            pass
                        brackets.append((t_a, time.perf_counter()))
                    deadline = time.monotonic() + seconds
                    while time.monotonic() < deadline:
                        if workload is not None:
                            workload()
                        else:
                            time.sleep(min(0.05, seconds))
                    t_close = time.perf_counter()
                path = os.path.join(trace_dir, f"trace-{int(started * 1000)}.json")
                prof.export_chrome_trace(path)
                result["host_spans"] = add_host_spans(path, brackets, t_close)
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


def _lanes(spans: List[tuple], nest: bool) -> List[int]:
    """A row for each (start, end) of `spans` (sorted by start, longest
    first), the lowest that takes it: with `nest`, a span must lie inside
    the row's open spans (Chrome's complete events nest), else it must
    start after the row's last end."""
    rows: List[list] = []  # per row, the ends of its open spans
    out = []
    for start, end in spans:
        for i, stack in enumerate(rows):
            while stack and stack[-1] <= start:
                stack.pop()
            if not stack or (nest and end <= stack[-1]):
                stack.append(end)
                out.append(i)
                break
        else:
            rows.append([end])
            out.append(len(rows) - 1)
    return out


def host_span_events(t_open: float, t_close: float, offset_us: float) -> List[dict]:
    """Chrome trace events of the host-span ring's records and the
    finished query spans that overlap [t_open, t_close] (perf_counter),
    at perf_counter * 1e6 + offset_us on the trace's clock."""
    from pathway_tpu_torch.internals import qtrace, tracing

    def us(t: float) -> float:
        return round(t * 1e6 + offset_us, 3)

    pid = HOST_SPANS_PID
    events: List[dict] = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                           "args": {"name": "host spans"}}]
    rows: List[tuple] = []  # (row name, [event, ...])
    by_thread: Dict[str, list] = {}
    for rec in tracing.spans_between(t_open, t_close):
        by_thread.setdefault(rec[4], []).append(rec)
    for thread in sorted(by_thread):
        recs = sorted(by_thread[thread], key=lambda r: (r[1], -r[2]))
        lanes = _lanes([(r[1], r[1] + r[2]) for r in recs], nest=True)
        for lane in range(max(lanes) + 1):
            rows.append((thread if lane == 0 else f"{thread} +{lane}", [
                {"ph": "X", "cat": "host", "name": r[0], "ts": us(r[1]),
                 "dur": round(r[2] * 1e6, 3), "args": {"rows": r[3]}}
                for r, at in zip(recs, lanes) if at == lane
            ]))
    if qtrace.ENABLED:
        spans = sorted(qtrace.tracker().finished_between(t_open, t_close),
                       key=lambda r: r["marks"]["ingress"])
        lanes = _lanes([(r["marks"]["ingress"], r["marks"]["respond"]) for r in spans],
                       nest=False)
        for lane in range(max(lanes, default=-1) + 1):
            evs = []
            for r, at in zip(spans, lanes):
                if at != lane:
                    continue
                t0, t1 = r["marks"]["ingress"], r["marks"]["respond"]
                evs.append({"ph": "X", "cat": "query", "name": r.get("route") or "query",
                            "ts": us(t0), "dur": round((t1 - t0) * 1e6, 3),
                            "args": {"qid": r["qid"]}})
                evs += [{"ph": "X", "cat": "stage", "name": stage, "ts": us(a),
                         "dur": round((b - a) * 1e6, 3), "args": {"qid": r["qid"]}}
                        for stage, a, b in qtrace.stage_intervals(r)]
            rows.append((f"queries {lane}", evs))
    for tid, (name, evs) in enumerate(rows, start=1):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": name}})
        events += [dict(ev, pid=pid, tid=tid) for ev in evs]
    return events


def add_host_spans(path: str, brackets: List[tuple], t_close: float) -> int:
    """Add host_span_events of the window to the Chrome trace at `path`,
    whose ANCHOR events were recorded in order, each inside a
    (before, after) perf_counter bracket of `brackets`; the number of
    span events added (none in a trace without the anchors, which give
    no clock to lay them on). Each anchor's midpoint is taken for its
    bracket's; the bracket with least slack around its anchor is used."""
    with open(path) as f:
        trace = json.load(f)
    anchors = sorted((e for e in trace["traceEvents"]
                      if e.get("name") == ANCHOR and e.get("ph") == "X"),
                     key=lambda e: float(e["ts"]))
    if len(anchors) != len(brackets):
        return 0
    (a, b), anchor = min(
        zip(brackets, anchors),
        key=lambda pair: (pair[0][1] - pair[0][0]) * 1e6 - float(pair[1].get("dur", 0.0)),
    )
    offset_us = float(anchor["ts"]) + float(anchor.get("dur", 0.0)) / 2 - (a + b) / 2 * 1e6
    events = host_span_events(brackets[0][0], t_close, offset_us)
    trace["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(trace, f)
    return sum(1 for e in events if e["ph"] == "X")


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
