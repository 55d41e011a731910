"""End-to-end epoch tracing: span store, Chrome trace export, critical
path, and the slow-tick stack sampler.

Epoch-scoped spans in the style of Dapper-ish distributed tracing laid
over the engine's totally-ordered logical times (the progress-tracking
view of Naiad): every sampled epoch records one span per node that did
work, one span for watermark advancement, and one edge per cross-worker
exchange stamp (origin worker, send wall-time, receive wall-time).
Because all workers step epochs in SPMD lockstep, sampling by
``time % sample_every == 0`` is deterministic across the whole mesh —
whenever one worker records an epoch, every worker records it, which is
what makes symmetric stamp send/receive safe with zero coordination.

Sampling config (read once per engine):
  PATHWAY_TRACE=0          tracing fully off
  PATHWAY_TRACE=1          trace every epoch
  PATHWAY_TRACE_SAMPLE=N   trace epochs where time % N == 0 (default 16)
  PATHWAY_TRACE_EPOCHS=K   ring capacity in epochs (default 128)

Overhead budget: unsampled ticks pay one attribute load + one modulo;
sampled ticks add one tuple append per active node.  The perf-smoke
guard (tests/test_perf_smoke.py) holds the default-sampling cost of the
whole observability layer under 5% of the bare loop.

Host spans: beside the per-engine epoch store, one process-wide ring
(``SpanRing``) holds the spans that threads other than the engine loop
record on the same ``time.perf_counter`` clock: the device pipeline's
stages, the decoder's prefill / decode / readback, ingest's copies and
index writes.  ``PATHWAY_TRACE=0`` turns it off too; every hook site
then costs one read of ``HOST_SPANS``.  Readers (a sampled epoch, the
``/profile`` export, a benchmark) take ``spans_between(t0, t1)``, which
consumes nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time as time_mod
from collections import deque
from typing import Any, Dict, Iterable, List, Optional


# ---------------------------------------------------------------------------
# Process-wide host-span ring
# ---------------------------------------------------------------------------

HOST_SPANS = os.environ.get("PATHWAY_TRACE") != "0"

# Records the ring keeps.  A 5 s traced window of 256-token ingest at
# ~4k chunks/s records about six spans a dispatch (prep, dispatch, wait,
# device, encode.h2d, index.write) at tens of dispatches a second, and
# a generate call about 40; the window, the drain after it and the
# set-up before it stay well under this, so a reader at a run's end
# still finds its window whole.  A record is a 6-tuple (~200 bytes).
SPAN_RING_CAPACITY = 1 << 16


class SpanRing:
    """Bounded, thread-safe ring of host spans.

    Each record is ``(name, start_perf_s, duration_s, rows, thread_name,
    owner)``: the span's name, its start on ``time.perf_counter``, its
    length, a row count (prompts, keys, batch rows; 0 where none), the
    name of the thread that recorded it, and ``owner``, an opaque tag a
    producer sets to read its own records back (a DevicePipeline's serial;
    None elsewhere).  The oldest records fall out first.

    The ring keeps each record beside the time it was appended, which is
    never before its span's end (a span on the card's clock, such as the
    decoder's first token, is appended well after it ends); so a reader
    scans back from the newest record only as far as the interval it
    asks for."""

    def __init__(self, capacity: int = SPAN_RING_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._records: deque = deque(maxlen=self.capacity)  # (appended, record)
        self._lock = threading.Lock()
        self.recorded = 0  # records ever appended

    def record(self, name: str, start: float, duration: float,
               rows: int = 0, owner: Any = None) -> None:
        rec = (name, start, duration, rows,
               threading.current_thread().name, owner)
        with self._lock:
            self._records.append((time_mod.perf_counter(), rec))
            self.recorded += 1

    def spans_between(self, t0: float, t1: float) -> List[tuple]:
        """The records that overlap [t0, t1], in the order they were
        appended."""
        out: List[tuple] = []
        with self._lock:
            for appended, rec in reversed(self._records):
                if appended < t0:
                    break  # this span and every older one ended before t0
                if rec[1] + rec[2] >= t0 and rec[1] <= t1:
                    out.append(rec)
        out.reverse()
        return out

    def holds_since(self, t: float) -> bool:
        """No record that ended at or after `t` has fallen out."""
        with self._lock:
            if self.recorded <= self.capacity or not self._records:
                return True
            return self._records[0][0] < t

    def owned_by(self, owner: Any) -> List[tuple]:
        """The records that `owner` tagged, oldest first."""
        with self._lock:
            return [r for _appended, r in self._records if r[5] == owner]


_RING = SpanRing()


def host_spans() -> SpanRing:
    """The process's host-span ring."""
    return _RING


def record_span(name: str, start: float, duration: float,
                rows: int = 0, owner: Any = None) -> None:
    """Append one host span to the ring (callers check HOST_SPANS)."""
    _RING.record(name, start, duration, rows, owner)


def spans_between(t0: float, t1: float) -> List[tuple]:
    """The ring's records overlapping [t0, t1]; nothing is consumed."""
    return _RING.spans_between(t0, t1)


class _EpochRecord:
    """All spans/edges captured for one sampled epoch on one worker."""

    __slots__ = ("epoch", "t0", "t1", "spans", "edges", "wm")

    def __init__(self, epoch: int, t0: float):
        self.epoch = epoch
        self.t0 = t0
        self.t1 = t0
        # (node_idx, name, start_perf, duration_s, rows)
        self.spans: List[tuple] = []
        # (channel, origin_worker, send_wall, recv_wall)
        self.edges: List[tuple] = []
        self.wm: Optional[tuple] = None  # (start_perf, duration_s)


class TraceStore:
    """Per-engine bounded store of sampled epoch traces.

    The engine loop drives it: ``should_sample(time)`` gates the traced
    loop variant, ``begin_epoch``/``end_epoch`` bracket one tick, and
    the exchange node reports cross-worker edges via ``note_edge``.
    Spans carry perf_counter times (cheap, monotonic) converted to wall
    clock at export with the same offset trick the flight recorder uses;
    edges carry wall clock directly because they cross processes."""

    def __init__(
        self,
        worker_id: int = 0,
        *,
        sample_every: int | None = None,
        capacity: int | None = None,
    ):
        env = os.environ
        mode = env.get("PATHWAY_TRACE")
        self.enabled = mode != "0"
        if sample_every is None:
            if mode == "1":
                sample_every = 1
            else:
                try:
                    sample_every = int(env.get("PATHWAY_TRACE_SAMPLE", 16))
                except ValueError:
                    sample_every = 16
        self.sample_every = max(1, sample_every)
        self.worker_id = worker_id
        if capacity is None:
            try:
                capacity = int(env.get("PATHWAY_TRACE_EPOCHS", 128))
            except ValueError:
                capacity = 128
        self.epochs: deque = deque(maxlen=max(1, capacity))
        self.current: Optional[_EpochRecord] = None
        # perf_counter -> wall-clock offset, sampled once (flight-recorder
        # convention): spans stamp the cheap clock, export converts
        self._epoch_off = time_mod.time() - time_mod.perf_counter()
        # the host-span ring is read from here on by the sampled epochs
        self._ring_from = time_mod.perf_counter()

    # -- engine-loop hooks -------------------------------------------------
    def should_sample(self, time: int) -> bool:
        return self.enabled and time % self.sample_every == 0

    def in_epoch(self, time: int) -> bool:
        cur = self.current
        return cur is not None and cur.epoch == time

    def begin_epoch(self, time: int, t0: float) -> _EpochRecord:
        rec = _EpochRecord(time, t0)
        self.current = rec
        return rec

    def end_epoch(self, wm_start: float, wm_end: float) -> None:
        """Close the current epoch after watermark advancement (the
        ``on_time_end`` sweep) ran between ``wm_start`` and ``wm_end``."""
        cur = self.current
        if cur is None:
            return
        cur.wm = (wm_start, wm_end - wm_start)
        self.epochs.append(cur)
        self.current = None

    def pipeline_spans(self, t_end: float) -> List[tuple]:
        """The host-span ring's device-pipeline spans (pipeline:prep /
        dispatch / wait / drain / device) that ended since the previous
        sampled epoch read them, as epoch spans of node -1: they run on
        pipeline threads, concurrent with the ticks."""
        t_from, self._ring_from = self._ring_from, t_end
        if not HOST_SPANS:
            return []
        return [
            (-1, name, t0, dur, rows)
            for name, t0, dur, rows, _thread, _owner in _RING.spans_between(
                t_from, t_end
            )
            if name.startswith("pipeline:") and t_from < t0 + dur <= t_end
        ]

    def note_edge(
        self,
        time: int,
        channel: int,
        origin: int,
        send_wall: float,
        recv_wall: float,
    ) -> None:
        cur = self.current
        if cur is not None and cur.epoch == time:
            cur.edges.append((channel, origin, send_wall, recv_wall))

    # -- export ------------------------------------------------------------
    def export_events(self) -> List[tuple]:
        """Flatten the ring into compact self-describing tuples that
        survive the wire codec (dump_trace gathers them across processes
        via Coordinator.agree):
          ("tick", worker, epoch, start_wall, duration_s)
          ("span", worker, epoch, node_idx, name, start_wall, dur, rows)
          ("wm",   worker, epoch, start_wall, duration_s)
          ("edge", dst_worker, origin_worker, epoch, channel,
                   send_wall, recv_wall)"""
        off = self._epoch_off
        w = self.worker_id
        out: List[tuple] = []
        for ep in list(self.epochs):
            out.append(
                ("tick", w, ep.epoch, ep.t0 + off, max(0.0, ep.t1 - ep.t0))
            )
            for idx, name, ts, dur, rows in ep.spans:
                out.append(
                    ("span", w, ep.epoch, idx, name, ts + off, dur, rows)
                )
            if ep.wm is not None:
                out.append(("wm", w, ep.epoch, ep.wm[0] + off, ep.wm[1]))
            for channel, origin, sw, rw in ep.edges:
                out.append(("edge", w, origin, ep.epoch, channel, sw, rw))
        return out

    def critical_path(self, epoch: int | None = None) -> Optional[dict]:
        return critical_path_from_events(self.export_events(), epoch)


# ---------------------------------------------------------------------------
# Critical-path attribution
# ---------------------------------------------------------------------------


def critical_path_from_events(
    events: Iterable[tuple], epoch: int | None = None
) -> Optional[dict]:
    """Top-5 latency attribution for one completed epoch (default: the
    latest sampled one).  The engine is single-threaded per worker, so a
    worker's contribution to an epoch's wall time is literally the sum of
    its node spans + watermark sweep; cross-worker exchange transit shows
    up as explicit edge entries.  ``share_pct`` is relative to the
    longest per-worker tick (workers overlap in wall time)."""
    events = list(events)
    ticks = [e for e in events if e[0] == "tick"]
    if not ticks:
        return None
    if epoch is None:
        epoch = max(e[2] for e in ticks)
    per_worker_total: Dict[int, float] = {}
    for _, w, ep, _ts, dur in ticks:
        if ep == epoch:
            per_worker_total[w] = per_worker_total.get(w, 0.0) + dur
    entries: List[dict] = []
    for ev in events:
        kind = ev[0]
        if kind == "span" and ev[2] == epoch:
            _, w, _ep, idx, name, _ts, dur, rows = ev
            entries.append(
                {
                    # spans of the async device pipeline, read from the
                    # host-span ring (pipeline:prep / pipeline:dispatch /
                    # pipeline:wait / pipeline:drain, node -1) are
                    # attributed as their own kind: they run on pipeline
                    # threads CONCURRENT with the tick, so "node" would
                    # misread as serial engine-loop time.  The estimated
                    # per-dispatch device busy interval (pipeline:device,
                    # internals/utilization.py) gets its own kind — it is
                    # CHIP time, not host pipeline time
                    "kind": (
                        "device"
                        if name == "pipeline:device"
                        else "pipeline"
                        if name.startswith("pipeline:")
                        else "node"
                    ),
                    "worker": w,
                    "node": idx,
                    "name": name,
                    "duration_ms": round(dur * 1000, 4),
                    "rows": rows,
                }
            )
        elif kind == "wm" and ev[2] == epoch:
            _, w, _ep, _ts, dur = ev
            per_worker_total[w] = per_worker_total.get(w, 0.0) + dur
            entries.append(
                {
                    "kind": "watermark",
                    "worker": w,
                    "node": -1,
                    "name": "watermark",
                    "duration_ms": round(dur * 1000, 4),
                    "rows": 0,
                }
            )
        elif kind == "edge" and ev[3] == epoch:
            _, dst, origin, _ep, channel, sw, rw = ev
            entries.append(
                {
                    "kind": "exchange",
                    "worker": dst,
                    "node": -1,
                    "name": f"ch{channel} w{origin}->w{dst}",
                    "duration_ms": round(max(0.0, rw - sw) * 1000, 4),
                    "rows": 0,
                }
            )
    if not entries and not per_worker_total:
        return None
    total_s = max(per_worker_total.values(), default=0.0)
    entries.sort(key=lambda e: e["duration_ms"], reverse=True)
    total_ms = total_s * 1000
    for e in entries:
        e["share_pct"] = (
            round(min(100.0, 100.0 * e["duration_ms"] / total_ms), 1)
            if total_ms > 0
            else None
        )
    return {
        "epoch": epoch,
        "total_ms": round(total_ms, 4),
        "entries": entries[:5],
    }


def merged_critical_path(engines: Iterable[Any]) -> Optional[dict]:
    """Critical path over the latest sampled epoch across a group of
    in-process engines (thread workers share memory, so no coordination
    is needed — the /status endpoint calls this on every request)."""
    events: List[tuple] = []
    for eng in engines:
        m = getattr(eng, "metrics", None)
        tr = getattr(m, "trace", None) if m is not None else None
        if tr is not None:
            events.extend(tr.export_events())
    return critical_path_from_events(events)


# ---------------------------------------------------------------------------
# Cross-worker gather + Chrome trace_event export
# ---------------------------------------------------------------------------


def gather_trace_events(engine) -> List[tuple]:
    """All trace events visible from this engine: its own, its in-process
    sibling thread workers' (shared memory), and — across processes —
    every peer's, gathered with ONE ``agree`` round on the TCP mesh.

    The TCP gather is an SPMD collective: in multiprocess runs every
    process must call ``dump_trace`` (or this function) at the same point
    of its script, exactly once, or the agreement rounds desynchronize —
    the same contract every other coordinator call already has."""
    engines = [engine]
    coord = getattr(engine, "coord", None)
    group = getattr(coord, "group", None)
    if group is not None:
        for e in getattr(group, "engines", ()):
            if e not in engines:
                engines.append(e)
    events: List[tuple] = []
    for e in engines:
        m = getattr(e, "metrics", None)
        tr = getattr(m, "trace", None) if m is not None else None
        if tr is not None:
            events.extend(tr.export_events())
    tcp = group.tcp if group is not None else None
    if tcp is None and coord is not None and hasattr(coord, "_recv_loop"):
        tcp = coord  # plain TcpCoordinator (threads == 1)
    if tcp is not None:
        gathered = tcp.agree(events)
        events = [
            tuple(ev) for per_process in gathered for ev in per_process
        ]
    return events


def build_chrome_trace(events: Iterable[tuple]) -> dict:
    """Render exported events as Chrome/Perfetto ``trace_event`` JSON:
    one pid per worker, complete ("X") spans for ticks/nodes/watermarks,
    flow ("s"/"f") arrows for cross-worker exchange edges."""
    events = list(events)
    workers = set()
    for ev in events:
        if ev[0] == "edge":
            workers.add(ev[1])
            workers.add(ev[2])
        else:
            workers.add(ev[1])
    te: List[dict] = []
    for w in sorted(workers):
        te.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": w,
                "tid": 0,
                "args": {"name": f"worker {w}"},
            }
        )
    flow_id = 0
    for ev in events:
        kind = ev[0]
        if kind == "tick":
            _, w, epoch, ts, dur = ev
            te.append(
                {
                    "ph": "X",
                    "cat": "tick",
                    "name": f"epoch {epoch}",
                    "pid": w,
                    "tid": 0,
                    "ts": round(ts * 1e6, 1),
                    "dur": round(dur * 1e6, 1),
                    "args": {"epoch": epoch},
                }
            )
        elif kind == "span":
            _, w, epoch, idx, name, ts, dur, rows = ev
            te.append(
                {
                    "ph": "X",
                    "cat": "node",
                    "name": name,
                    "pid": w,
                    "tid": 1,
                    "ts": round(ts * 1e6, 1),
                    "dur": round(dur * 1e6, 1),
                    "args": {"epoch": epoch, "node": idx, "rows": rows},
                }
            )
        elif kind == "wm":
            _, w, epoch, ts, dur = ev
            te.append(
                {
                    "ph": "X",
                    "cat": "watermark",
                    "name": "watermark",
                    "pid": w,
                    "tid": 1,
                    "ts": round(ts * 1e6, 1),
                    "dur": round(dur * 1e6, 1),
                    "args": {"epoch": epoch},
                }
            )
        elif kind == "edge":
            _, dst, origin, epoch, channel, sw, rw = ev
            flow_id += 1
            common = {
                "cat": "exchange",
                "name": f"ch{channel}",
                "id": flow_id,
                "tid": 0,
            }
            te.append(
                {
                    "ph": "s",
                    "pid": origin,
                    "ts": round(sw * 1e6, 1),
                    "args": {"epoch": epoch},
                    **common,
                }
            )
            te.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "pid": dst,
                    "ts": round(rw * 1e6, 1),
                    "args": {"epoch": epoch},
                    **common,
                }
            )
    return {"traceEvents": te, "displayTimeUnit": "ms"}


_ALLOWED_PH = frozenset("BEXiICsfTtbneMPNODSvVp")


def validate_chrome_trace(trace: Any) -> None:
    """Schema-check a Chrome ``trace_event`` object (raises ValueError):
    the structural rules Perfetto's importer actually enforces — phase
    codes, numeric timestamps, flow-event ids, JSON-serializability."""
    if not isinstance(trace, dict):
        raise ValueError("trace must be a JSON object")
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _ALLOWED_PH:
            raise ValueError(f"traceEvents[{i}]: bad phase {ph!r}")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"traceEvents[{i}]: pid must be an int")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"traceEvents[{i}]: ts must be numeric")
            if not isinstance(ev.get("name"), str):
                raise ValueError(f"traceEvents[{i}]: missing name")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"traceEvents[{i}]: X event needs dur >= 0"
                )
        if ph in "sft" and "id" not in ev:
            raise ValueError(f"traceEvents[{i}]: flow event needs an id")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"trace is not JSON-serializable: {exc}") from None


# ---------------------------------------------------------------------------
# Slow-tick sampler
# ---------------------------------------------------------------------------


class SlowTickWatchdog:
    """Capture all-thread Python stacks into the flight recorder when a
    tick exceeds PATHWAY_SLOW_TICK_MS.

    A daemon thread polls the in-flight tick marker at half the threshold
    period; the engine loop pays only two attribute stores per tick (and
    zero when the watchdog is disabled — the loop None-checks it).  One
    capture per offending tick: the point is "what was the engine doing
    while it was stuck", not a profiler."""

    def __init__(self, engine, recorder, threshold_ms: float):
        import weakref

        self.threshold_s = max(0.001, float(threshold_ms) / 1000.0)
        self.recorder = recorder
        self._engine_ref = weakref.ref(engine)
        self._current: Optional[tuple] = None  # (perf_start, engine_time)
        self._captured_for: Optional[tuple] = None
        self._stop = threading.Event()
        self._poll = min(0.25, max(0.001, self.threshold_s / 2.0))
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pw-slow-tick"
        )
        self._thread.start()

    def begin(self, time: int) -> None:
        self._current = (time_mod.perf_counter(), time)

    def end(self) -> None:
        self._current = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            cur = self._current
            if cur is None or cur == self._captured_for:
                continue
            t0, etime = cur
            elapsed = time_mod.perf_counter() - t0
            if elapsed < self.threshold_s:
                continue
            self._captured_for = cur
            try:
                self._capture(etime, elapsed)
            except Exception:  # noqa: BLE001 — diagnostics must not kill runs
                pass

    def _capture(self, etime: int, elapsed: float) -> None:
        import sys
        import traceback

        me = threading.get_ident()
        parts = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = traceback.extract_stack(frame)[-8:]
            top = " < ".join(
                f"{f.name}@{os.path.basename(f.filename)}:{f.lineno}"
                for f in reversed(stack)
            )
            parts.append(f"[tid {tid}] {top}")
        eng = self._engine_ref()
        node = getattr(eng, "current_node", None) if eng is not None else None
        self.recorder.record(
            "slow_tick",
            time=etime,
            node=getattr(node, "_idx", -1),
            name=" | ".join(parts)[:4000],
            duration_s=elapsed,
        )

    def stop(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# Flight-recorder causal merge
# ---------------------------------------------------------------------------


def merge_flight_tails(
    tails: Iterable[List[Dict[str, Any]]]
) -> List[Dict[str, Any]]:
    """Merge per-worker flight-recorder tails in causal order.

    Wall clocks skew across processes; (epoch, seq, worker) does not:
    epochs advance in lockstep, and within one epoch every worker appends
    events in the same node order (SPMD), so per-worker sequence numbers
    align causally."""
    merged = [e for tail in tails for e in tail]
    merged.sort(
        key=lambda e: (
            e.get("time", 0),
            e.get("seq", 0),
            e.get("worker", 0),
        )
    )
    return merged
