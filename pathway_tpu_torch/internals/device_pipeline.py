"""Asynchronous device pipeline for the embedding/ingest hot path.

Without it the card idles while the host tokenizes, buckets, and
synchronously round-trips every batch. This module is the WindVE-style
fix — a collaborative host/device queue:

  * a PREPARE stage (worker threads) tokenizes + packs batch N+2 while
  * a single DISPATCHER thread enqueues batch N+1 on the device while
  * batch N executes — CUDA launches are async, so the dispatcher only
    blocks when the in-flight window (default 2, i.e. double-buffered)
    is full, and then only on the oldest handle.

Ordering: the dispatcher consumes strictly in submission order, which the
in-place index writes require (ops/knn.py writes each batch into the
live buffer, so the writes must keep their order).
Synchronization points are explicit: `barrier()` (everything submitted
has been *dispatched* — searches reading the device buffer need nothing
more, the card's stream order does the rest) and `drain()` (everything has
*executed*; the snapshot/rollback/finish contract).

Completion waits read back one element of the handle (`.item()` on
`handle.reshape(-1)[:1]`, 4 bytes for f32): the copy queues behind the
work that produced the handle on the card's stream, so its return means
that work has executed. CPU tensors and None need no wait.

Failure model mirrors the columnar-exchange fallback: a prepare/dispatch
exception parks the failing item plus everything still queued in a
`take_failed()` list, surfaces as DevicePipelineError at the next
submit/barrier/drain, and the caller replays those items on the classic
synchronous path exactly once.

`PATHWAY_DEVICE_PIPELINE=0` restores the classic synchronous per-batch
path wholesale (read per call, like the other runtime gates).
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


from pathway_tpu_torch.internals import memtrack, tracing, utilization
from pathway_tpu_torch.internals.metrics import MetricsRegistry


def pipeline_enabled() -> bool:
    """PATHWAY_DEVICE_PIPELINE gate, read per call: default on, "0"
    restores the classic synchronous per-batch ingest path."""
    return os.environ.get("PATHWAY_DEVICE_PIPELINE", "1") != "0"


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


class DevicePipelineError(RuntimeError):
    """A prepare or dispatch stage failed; the failed items are waiting
    in take_failed() for a synchronous replay."""


def _default_wait(handle) -> None:
    # one-element readback: the copy queues behind everything `handle`
    # depends on on the card's stream and moves 4 bytes (vs a full-array
    # copy); torch is imported here so the host framework loads without it
    if handle is None:
        return
    import torch

    if not torch.is_tensor(handle) or not handle.is_cuda:
        return  # host data: nothing to wait for
    if handle.numel():
        handle.reshape(-1)[:1].item()
    else:
        torch.cuda.current_stream(handle.device).synchronize()


class DevicePipeline:
    """prepare (host worker threads) -> bounded queue -> dispatch
    (single thread, submission order) -> bounded in-flight window.

    prepare(item) -> (payload, meta) where meta may carry "rows",
    "real_tokens", "slab_tokens" for the pad-waste accounting.
    dispatch(payload) -> a device handle the default wait can readback.
    quiesce() (optional) -> extra device sync run at the end of drain()
    (e.g. a readback on the KNN buffer to cover the scatter chain).
    """

    def __init__(
        self,
        prepare: Callable[[Any], Tuple[Any, Dict[str, Any]]],
        dispatch: Callable[[Any], Any],
        *,
        prep_workers: Optional[int] = None,
        max_prepared: Optional[int] = None,
        max_in_flight: Optional[int] = None,
        wait: Optional[Callable[[Any], None]] = None,
        quiesce: Optional[Callable[[], None]] = None,
        name: str = "device-pipeline",
        replicas: int = 1,
    ):
        self.name = name
        self._prepare = prepare
        self._dispatch = dispatch
        self._wait = wait or _default_wait
        self._quiesce = quiesce
        self.max_prepared = max_prepared or _env_int("PATHWAY_PIPELINE_QUEUE", 4)
        self.max_in_flight = max_in_flight or _env_int(
            "PATHWAY_PIPELINE_IN_FLIGHT", 2
        )
        # health-controller backpressure: the configured sizes are the
        # ceiling; set_pressure_scale() shrinks the live knobs toward 1
        # and restores them when pressure clears (AIMD)
        self._base_max_prepared = self.max_prepared
        self._base_max_in_flight = self.max_in_flight
        # two independent throttles compose multiplicatively: the health
        # AIMD pressure scale and the serving tier's priority-lane scale
        # (internals/serving.py shrinks ingest windows while the query
        # SLO burns so serving dispatches get the freed device slots)
        self._pressure_scale = 1.0
        self._serve_scale = 1.0
        # mesh backend: dispatches are SPMD across dp replicas, so every
        # replica holds its own copy of the in-flight window; meta may
        # carry "replica_rows" / "replica_real_tokens" /
        # "replica_slab_tokens" for the per-replica /status gauges
        self.replicas = max(1, int(replicas))
        self._replica_rows = [0] * self.replicas
        self._replica_real = [0] * self.replicas
        self._replica_slab = [0] * self.replicas
        # completion-to-completion device-time estimate (see
        # internals/utilization.py module docstring)
        self._last_completion = 0.0
        workers = prep_workers or _env_int("PATHWAY_PIPELINE_PREP_WORKERS", 2)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"{name}-prep"
        )
        self._cond = threading.Condition()
        self._pending: Deque[Tuple[int, Any, Any]] = collections.deque()
        self._inflight: Deque[Any] = collections.deque()
        self._submitted = 0
        self._dispatched = 0
        self._drains = 0
        self._rows = 0
        self._real_tokens = 0
        self._slab_tokens = 0
        self._error: Optional[BaseException] = None
        self._failed: List[Any] = []
        self._stop = False
        # this pipeline's tag on its records in the host-span ring
        self._serial = next(_SERIALS)
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-dispatch", daemon=True
        )
        self._thread.start()
        if _PRESSURE_SCALE < 1.0:
            # born under pressure: adopt the process-wide throttle
            self.set_pressure_scale(_PRESSURE_SCALE)
        if _SERVE_SCALE < 1.0:
            # born while serving holds priority: cede the slots too
            self.set_serve_scale(_SERVE_SCALE)
        _PIPELINES.add(self)

    # -- producer side ----------------------------------------------------

    def submit(self, item: Any) -> None:
        """Hand one batch to the pipeline. Blocks (backpressure) while the
        prepared queue is full; raises DevicePipelineError if a previous
        batch failed (the caller then replays take_failed() synchronously)."""
        with self._cond:
            self._raise_if_failed()
            while len(self._pending) >= self.max_prepared:
                self._cond.wait()
                self._raise_if_failed()
            self._submitted += 1
            seq = self._submitted
            fut = self._pool.submit(self._prep_timed, item)
            self._pending.append((seq, item, fut))
            self._cond.notify_all()

    def barrier(self) -> None:
        """Wait until every submitted batch has been DISPATCHED to the
        device. Readers of device buffers produced by the dispatch chain
        need only this — the card's stream order does the rest."""
        with self._cond:
            while self._dispatched < self._submitted and self._error is None:
                self._cond.wait()
            self._raise_if_failed()

    def drain(self) -> None:
        """Barrier, then wait until every in-flight dispatch has EXECUTED
        on device (snapshot / rollback / failover / finish contract)."""
        self.barrier()
        t0 = time.perf_counter()
        waited = False
        while True:
            with self._cond:
                if not self._inflight:
                    break
                handle, disp_end, meta = self._inflight.popleft()
            waited = True
            self._wait(handle)
            self._note_completion(disp_end, meta)
        if self._quiesce is not None:
            self._quiesce()
            waited = True
        with self._cond:
            self._drains += 1
        if waited:
            self._note_span("pipeline:drain", t0, time.perf_counter() - t0, 0)
        if waited and utilization.ENABLED:
            utilization.tracker().note_span(
                "drain", time.perf_counter() - t0
            )

    def set_pressure_scale(self, scale: float) -> None:
        """Scale the live queue/window sizes toward `scale` of their
        configured ceilings (floor 1 each — the pipeline never stalls
        outright).  Shrinking takes effect as in-flight work retires;
        expanding wakes any submitter blocked on the old bound."""
        self._pressure_scale = min(1.0, max(0.0, float(scale)))
        self._apply_scales()

    def set_serve_scale(self, scale: float) -> None:
        """Serving-priority lane: while the query SLO burns, the serving
        tier shrinks this ingest window so its batches stop queueing
        behind a full in-flight window.  Composes multiplicatively with
        the health pressure scale — whichever throttle is tighter wins
        and releasing one never masks the other."""
        self._serve_scale = min(1.0, max(0.0, float(scale)))
        self._apply_scales()

    def _apply_scales(self) -> None:
        eff = self._pressure_scale * self._serve_scale
        with self._cond:
            self.max_prepared = max(
                1, int(self._base_max_prepared * eff)
            )
            self.max_in_flight = max(
                1, int(self._base_max_in_flight * eff)
            )
            self._cond.notify_all()

    def take_failed(self) -> List[Any]:
        """Return (and clear) the items that never made it to the device,
        in submission order, resetting the error state. The caller owns
        replaying them on the synchronous path."""
        with self._cond:
            failed, self._failed = self._failed, []
            self._error = None
            return failed

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)
        _PIPELINES.discard(self)

    # -- observability -----------------------------------------------------

    @property
    def _spans(self) -> List[Tuple[str, float, float, int]]:
        """This pipeline's stage spans still in the host-span ring, as
        (name, start_perf, duration_s, rows), oldest first; nothing is
        consumed."""
        return [r[:4] for r in tracing.host_spans().owned_by(self._serial)]

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            slab = self._slab_tokens
            return {
                "submitted": self._submitted,
                "dispatched": self._dispatched,
                "queue_depth": len(self._pending),
                "in_flight": len(self._inflight),
                "drains": self._drains,
                "rows": self._rows,
                "real_tokens": self._real_tokens,
                "slab_tokens": slab,
                "pad_waste_ratio": (
                    1.0 - self._real_tokens / slab if slab else None
                ),
                "replicas": self.replicas,
            }

    def replica_stats(self) -> List[Dict[str, Any]]:
        """Per-dp-replica view.  Dispatches span every replica (one SPMD
        program), so in-flight depth and window capacity are identical
        across replicas; rows come from the "replica_rows" meta the
        dp-grouped prepare stage reports."""
        with self._cond:
            in_flight = len(self._inflight)
            return [
                {
                    "replica": r,
                    "rows": self._replica_rows[r],
                    "in_flight": in_flight,
                    "queue_depth": len(self._pending),
                    "occupancy": in_flight / self.max_in_flight,
                    "real_tokens": self._replica_real[r],
                    "slab_tokens": self._replica_slab[r],
                    "pad_waste_ratio": (
                        1.0 - self._replica_real[r] / self._replica_slab[r]
                        if self._replica_slab[r]
                        else None
                    ),
                }
                for r in range(self.replicas)
            ]

    def replica_tokens(self) -> List[Tuple[int, int]]:
        """Per-replica (real_tokens, slab_tokens) for the labeled
        pad-waste gauge."""
        with self._cond:
            return list(zip(self._replica_real, self._replica_slab))

    # -- internals ---------------------------------------------------------

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise DevicePipelineError(
                f"{self.name}: {len(self._failed)} batch(es) need a "
                f"synchronous replay ({type(self._error).__name__}: "
                f"{self._error})"
            ) from self._error

    def _note_span(self, kind: str, t0: float, dur: float, rows: int) -> None:
        if tracing.HOST_SPANS:
            tracing.record_span(kind, t0, dur, rows, self._serial)

    def _note_completion(self, disp_end: float, meta: Dict[str, Any]) -> None:
        """A waited handle finished executing: estimate its device busy
        interval (completion-to-completion; dispatches execute in-order)
        and feed the utilization window + the mesh straggler detector."""
        t_end = time.perf_counter()
        if memtrack.ENABLED:
            # the slab's packed arrays retire with the dispatch
            memtrack.tracker().adjust(
                "pipeline_inflight", self,
                -float(meta.get("slab_bytes", 0)),
            )
        with self._cond:
            device_s = max(0.0, t_end - max(self._last_completion, disp_end))
            self._last_completion = t_end
        self._note_span(
            "pipeline:device", t_end - device_s, device_s, int(meta.get("rows", 0))
        )
        from pathway_tpu_torch.internals import qtrace

        if qtrace.ENABLED:
            # ingest dispatches competing with the serving path show up
            # in slow-query exemplars as concurrent device pressure
            qtrace.tracker().note_device_window(device_s, source="ingest")
        from pathway_tpu_torch.internals import costledger

        if costledger.ENABLED:
            # same device_s the utilization window gets, so the ledger's
            # ingest cells and the window total stay conserved
            costledger.charge(
                "ingest",
                device_s=device_s,
                flops=float(meta.get("useful_flops", 0.0)),
                bytes_moved=float(meta.get("slab_bytes", 0)),
                docs=int(meta.get("rows", 0)),
            )
        if utilization.ENABLED:
            utilization.tracker().note_span("device", device_s)
            if self.replicas > 1:
                from pathway_tpu_torch.internals.mesh_backend import active_backend

                backend = active_backend()
                if backend is not None:
                    backend.note_dispatch_device_time(
                        device_s, meta.get("replica_rows")
                    )

    def _account_replicas(
        self, meta: Dict[str, Any], rows: int, real: int, slab: int
    ) -> None:
        """Per-replica row/token accounting (caller holds _cond).  The
        dp-grouped prepare stage reports exact per-replica counts; a
        single-replica pipeline books everything on replica 0; a mesh
        pipeline without per-replica detail spreads tokens evenly (slab
        rows per replica ARE equal by construction — pack_batch_dp pads
        groups to a common block)."""
        for r, n in enumerate(meta.get("replica_rows") or ()):
            if r < self.replicas:
                self._replica_rows[r] += int(n)
        if self.replicas == 1:
            self._replica_rows[0] = self._rows
            self._replica_real[0] += real
            self._replica_slab[0] += slab
            return
        rr = meta.get("replica_real_tokens")
        rs = meta.get("replica_slab_tokens")
        if rr is not None and rs is not None:
            for r in range(min(self.replicas, len(rr))):
                self._replica_real[r] += int(rr[r])
                self._replica_slab[r] += int(rs[r])
        else:
            for r in range(self.replicas):
                self._replica_real[r] += real // self.replicas
                self._replica_slab[r] += slab // self.replicas

    def _prep_timed(self, item: Any) -> Tuple[Any, Dict[str, Any]]:
        t0 = time.perf_counter()
        payload, meta = self._prepare(item)
        dur = time.perf_counter() - t0
        self._note_span("pipeline:prep", t0, dur, int(meta.get("rows", 0)))
        if utilization.ENABLED:
            utilization.tracker().note_span("prep", dur)
        return payload, meta

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending:
                    return
                seq, item, fut = self._pending.popleft()
                self._cond.notify_all()
            try:
                payload, meta = fut.result()
                # window: wait the OLDEST handle only when double-buffering
                # is exhausted — batch N executes while N+1 enqueues
                while True:
                    with self._cond:
                        if len(self._inflight) < self.max_in_flight:
                            break
                        handle, disp_end, old_meta = self._inflight.popleft()
                    t0 = time.perf_counter()
                    self._wait(handle)
                    wait_dur = time.perf_counter() - t0
                    self._note_span("pipeline:wait", t0, wait_dur, 0)
                    if utilization.ENABLED:
                        utilization.tracker().note_span("wait", wait_dur)
                    self._note_completion(disp_end, old_meta)
                t0 = time.perf_counter()
                handle = self._dispatch(payload)
                disp_end = time.perf_counter()
                if memtrack.ENABLED:
                    # packed slab bytes live on device until the handle
                    # retires (_note_completion books the -delta)
                    memtrack.tracker().adjust(
                        "pipeline_inflight", self,
                        float(meta.get("slab_bytes", 0)),
                    )
                rows = int(meta.get("rows", 0))
                real = int(meta.get("real_tokens", 0))
                slab = int(meta.get("slab_tokens", 0))
                self._note_span("pipeline:dispatch", t0, disp_end - t0, rows)
                with self._cond:
                    self._inflight.append((handle, disp_end, meta))
                    self._dispatched = seq
                    self._rows += rows
                    self._real_tokens += real
                    self._slab_tokens += slab
                    self._account_replicas(meta, rows, real, slab)
                    self._cond.notify_all()
                if utilization.ENABLED:
                    t = utilization.tracker()
                    t.note_span("dispatch", disp_end - t0)
                    t.note_batch(
                        rows, real, slab,
                        float(meta.get("useful_flops", 0.0)),
                    )
            except BaseException as exc:  # noqa: BLE001 — parked for replay
                with self._cond:
                    self._failed.append(item)
                    while self._pending:
                        _seq, p_item, p_fut = self._pending.popleft()
                        p_fut.cancel()
                        self._failed.append(p_item)
                    self._dispatched = self._submitted
                    self._error = exc
                    _STATS["fallbacks"] += 1
                    self._cond.notify_all()


# -- module registry / gauges ---------------------------------------------

_PIPELINES: "weakref.WeakSet[DevicePipeline]" = weakref.WeakSet()
_SERIALS = itertools.count(1)
_STATS: Dict[str, int] = {"fallbacks": 0}
# process-wide backpressure scale (internals/health.py AIMD loop); new
# pipelines adopt it at construction so pressure survives pipeline churn
_PRESSURE_SCALE = 1.0


def set_backpressure_scale(scale: float) -> float:
    """Apply the health controller's AIMD scale to every live pipeline
    (and remember it for pipelines created while pressure holds).
    Returns the clamped scale actually applied."""
    global _PRESSURE_SCALE
    scale = min(1.0, max(0.0, float(scale)))
    _PRESSURE_SCALE = scale
    for p in list(_PIPELINES):
        p.set_pressure_scale(scale)
    return scale


def backpressure_scale() -> float:
    return _PRESSURE_SCALE


# serving-priority scale (internals/serving.py partitioner); same
# adopt-at-birth contract as the pressure scale
_SERVE_SCALE = 1.0


def set_serving_scale(scale: float) -> float:
    """Apply the serving partitioner's priority-lane scale to every live
    pipeline (and remember it for pipelines created while serving holds
    priority).  Returns the clamped scale actually applied."""
    global _SERVE_SCALE
    scale = min(1.0, max(0.0, float(scale)))
    _SERVE_SCALE = scale
    for p in list(_PIPELINES):
        p.set_serve_scale(scale)
    return scale


def serving_scale() -> float:
    return _SERVE_SCALE
# The pipeline is a process-wide resource (one set of gauges regardless of
# how many engine workers share the process), so its series carry the
# conventional worker="0" constant label the exposition contract requires.
_REGISTRY = MetricsRegistry(worker="0")


def _sum_stat(key: str) -> Optional[float]:
    pipes = list(_PIPELINES)
    if not pipes:
        return None
    return float(sum(p.stats()[key] or 0 for p in pipes))


def _pad_waste() -> Optional[float]:
    pipes = list(_PIPELINES)
    real = sum(p.stats()["real_tokens"] for p in pipes)
    slab = sum(p.stats()["slab_tokens"] for p in pipes)
    if not slab:
        return None
    return 1.0 - real / slab


def _occupancy() -> Optional[float]:
    pipes = list(_PIPELINES)
    cap = sum(p.max_in_flight for p in pipes)
    if not cap:
        return None
    return sum(p.stats()["in_flight"] for p in pipes) / cap


def _by_replica(values_of_pipe) -> List[Tuple[Tuple[str], float]]:
    """Aggregate a per-pipeline list of per-replica numbers into labeled
    gauge samples [(("<replica>",), value), ...].  A 4-replica mesh run
    reports 4 series instead of collapsing into one number; the classic
    single-device pipeline reports replica="0"."""
    acc: Dict[int, float] = {}
    for p in list(_PIPELINES):
        for r, v in enumerate(values_of_pipe(p)):
            if v is None:
                continue
            acc[r] = acc.get(r, 0.0) + v
    return [((str(r),), acc[r]) for r in sorted(acc)]


def _pad_waste_by_replica() -> List[Tuple[Tuple[str], float]]:
    real: Dict[int, int] = {}
    slab: Dict[int, int] = {}
    for p in list(_PIPELINES):
        for r, (re, sl) in enumerate(p.replica_tokens()):
            real[r] = real.get(r, 0) + re
            slab[r] = slab.get(r, 0) + sl
    return [
        ((str(r),), 1.0 - real[r] / slab[r])
        for r in sorted(slab)
        if slab[r]
    ]


def _occupancy_by_replica() -> List[Tuple[Tuple[str], float]]:
    in_flight: Dict[int, int] = {}
    cap: Dict[int, int] = {}
    for p in list(_PIPELINES):
        n = p.stats()["in_flight"]
        for r in range(p.replicas):
            in_flight[r] = in_flight.get(r, 0) + n
            cap[r] = cap.get(r, 0) + p.max_in_flight
    return [
        ((str(r),), in_flight[r] / cap[r]) for r in sorted(cap) if cap[r]
    ]


_REGISTRY.gauge(
    "pathway_device_pad_waste_ratio",
    help="Fraction of dispatched slab tokens that were padding "
    "(pipelined ingest batches, cumulative, per dp replica)",
    labels=("replica",),
    callback=_pad_waste_by_replica,
)
_REGISTRY.gauge(
    "pathway_device_pipeline_queue_depth",
    help="Prepared batches waiting for device dispatch",
    callback=lambda: _sum_stat("queue_depth"),
)
_REGISTRY.gauge(
    "pathway_device_pipeline_in_flight",
    help="Batches dispatched to the device and not yet retired "
    "(per dp replica; SPMD dispatches occupy every replica's window)",
    labels=("replica",),
    callback=lambda: _by_replica(
        lambda p: [p.stats()["in_flight"]] * p.replicas
    ),
)
_REGISTRY.gauge(
    "pathway_device_pipeline_occupancy",
    help="In-flight batches over the double-buffer window (0..1, "
    "per dp replica)",
    labels=("replica",),
    callback=_occupancy_by_replica,
)
_REGISTRY.gauge(
    "pathway_device_pipeline_fallbacks_total",
    help="Pipeline batches replayed on the classic synchronous path",
    callback=lambda: float(_STATS["fallbacks"]) if _PIPELINES or _STATS["fallbacks"] else None,
)


def pipeline_metrics() -> MetricsRegistry:
    """Registry holding the pipeline gauges (scraped by PrometheusServer
    alongside the engine/device registries)."""
    return _REGISTRY


def pipeline_status() -> Dict[str, Any]:
    """/status payload: aggregate view over live pipelines."""
    pipes = list(_PIPELINES)
    out: Dict[str, Any] = {
        "enabled": pipeline_enabled(),
        "active": len(pipes),
        "fallbacks": _STATS["fallbacks"],
        "backpressure_scale": _PRESSURE_SCALE,
        "serving_scale": _SERVE_SCALE,
    }
    if pipes:
        agg = {
            k: sum(p.stats()[k] or 0 for p in pipes)
            for k in (
                "submitted",
                "dispatched",
                "queue_depth",
                "in_flight",
                "drains",
                "rows",
            )
        }
        out.update(agg)
        out["pad_waste_ratio"] = _pad_waste()
        out["occupancy"] = _occupancy()
    return out


def replica_status(replicas: int) -> List[Dict[str, Any]]:
    """Per-dp-replica occupancy/queue gauges for the /status `mesh` key,
    aggregated over the live mesh-armed pipelines (replica r sums the
    r-th entry of every pipeline running with that replica count)."""
    out = [
        {
            "replica": r,
            "rows": 0,
            "in_flight": 0,
            "queue_depth": 0,
            "occupancy": 0.0,
        }
        for r in range(max(1, int(replicas)))
    ]
    pipes = [p for p in _PIPELINES if p.replicas == len(out)]
    for p in pipes:
        for r, st in enumerate(p.replica_stats()):
            out[r]["rows"] += st["rows"]
            out[r]["in_flight"] += st["in_flight"]
            out[r]["queue_depth"] += st["queue_depth"]
    cap = sum(p.max_in_flight for p in pipes)
    if cap:
        for row in out:
            row["occupancy"] = row["in_flight"] / cap
    return out
