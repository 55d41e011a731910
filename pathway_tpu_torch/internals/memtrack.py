"""Live memory accounting: who owns HBM (and host RAM) RIGHT NOW.

The utilization layer (internals/utilization.py) answers "is the device
busy"; this module answers "what is the device full OF".  Every
long-lived allocation the ingest path makes — KNN index slabs
(ops/knn.py), the tp-sharded encoder parameter copy, packed slabs
in flight through the device pipeline, snapshot/commit-log staging
buffers — registers here with a component name and a tier, so the
breakdown behind a rising `bytes_in_use` is always attributable:

  pathway_memory_bytes{component,tier}   logical bytes per component
  pathway_memory_hbm_headroom_bytes      per-device HBM left (absent
                                         when capacity is unknown)
  pathway_memory_replica_peak_bytes      per-dp-replica high watermark
  pathway_memory_time_to_full_seconds    ingest-rate forecast (below)

Accounting model (documented in ARCHITECTURE.md "Memory accounting"):

  * entries record LOGICAL bytes (the nbytes of the arrays as the code
    sees them) plus two placement divisors: ``device_span`` — how many
    devices the bytes are spread across (index rows shard over dp;
    encoder matmul params shard over tp) — and ``dp_shards`` — how many
    dp replicas divide the bytes (1 = replicated per replica).  Per-
    device usage = nbytes/device_span; per-replica = nbytes/dp_shards.
  * entries are keyed by their owning object through a weakref: when a
    DeviceKnnIndex or pipeline dies, its accounting vanishes with it —
    no release call needed on teardown paths that never run.
  * the cross-check: `device_memory_stats()` surfaces the CUDA
    allocator's own bytes_in_use/peak and the card's bytes_limit when
    the process has a CUDA context, and returns None on the CPU —
    graceful, never a guess.

Time-to-full forecaster: ingest hook sites report (docs, per-device
bytes) deltas into a rolling window; docs/s x bytes/doc against the
current headroom projects exhaustion.  When headroom drops below
``PATHWAY_MEM_HEADROOM_WARN_PCT`` percent of capacity the module warns
ONCE and drops a flight-recorder event, so the operator learns the
index is 10 minutes from OOM before the OOM.

Capacity resolution (shared with analysis/capacity.py, one source of
truth): ``PATHWAY_ASSUME_HBM_BYTES`` override -> the card's total
memory from the in-process CUDA context -> None.

``PATHWAY_MEMTRACK=0`` disables everything; hook sites guard on the
module-global ``ENABLED`` so the disabled cost is one attribute read
(enforced <5% by tests/test_perf_smoke.py).  The disabled path never
touches the CUDA memory APIs.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import threading
import time
import weakref
from typing import Any, Deque, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import faults
from pathway_tpu_torch.internals.metrics import FlightRecorder, MetricsRegistry

logger = logging.getLogger("pathway_tpu_torch")

# Cheap guard read by every hook site.
ENABLED = os.environ.get("PATHWAY_MEMTRACK", "1") != "0"

# Headroom percentage below which the warn-once + flight event fires.
HEADROOM_WARN_PCT = float(
    os.environ.get("PATHWAY_MEM_HEADROOM_WARN_PCT", "10") or 10
)

# Forecast rolling-window length (seconds of ingest deltas retained).
FORECAST_WINDOW_S = float(
    os.environ.get("PATHWAY_MEM_FORECAST_WINDOW_S", "60") or 60
)

# The component names the hook sites use (label values are open — these
# are the ones wired today; ARCHITECTURE.md documents them).
COMPONENTS = (
    "knn_index",
    "encoder_params",
    "pipeline_inflight",
    "snapshot_staging",
)
TIERS = ("hbm", "host")

# component -> cost-ledger workload: how HBM-resident bytes attribute in
# the (workload, route, tenant) accounting (internals/costledger.py).
# Index, encoder weights, and in-flight ingest slabs all exist to ingest
# and serve the corpus (charged to ingest, the pipeline that grows
# them); snapshot staging is maintenance.
COMPONENT_WORKLOADS = {
    "knn_index": "ingest",
    "encoder_params": "ingest",
    "pipeline_inflight": "ingest",
    "snapshot_staging": "maintenance",
}

# Flight events from this module (headroom warnings) — merged into
# /status dumps next to the mesh backend's recorder.
RECORDER = FlightRecorder(capacity=128)


def device_memory_stats() -> Optional[Dict[str, Any]]:
    """CUDA device 0's memory stats (bytes_in_use/bytes_limit/peak) when
    this process has a CUDA context; None on the CPU or when torch was
    never imported.  Never imports torch nor creates a context itself —
    probing must not drag a backend into processes that run without
    one."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats(0)
        _free, total = torch.cuda.mem_get_info(0)
    except Exception:  # noqa: BLE001 — no backend / no stats is a valid state
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def hbm_capacity_bytes() -> Optional[float]:
    """Per-device HBM capacity — the one resolution order the forecaster,
    the gauges, and the PWT6xx capacity pass all share:
    PATHWAY_ASSUME_HBM_BYTES override -> the card's total memory -> None
    (unknown; consumers omit, never guess)."""
    env = os.environ.get("PATHWAY_ASSUME_HBM_BYTES")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    stats = device_memory_stats()
    if stats and stats.get("bytes_limit"):
        return float(stats["bytes_limit"])
    return None


class MemoryTracker:
    """Process-wide component registry + ingest-rate forecaster."""

    def __init__(self, forecast_window_s: float = FORECAST_WINDOW_S):
        self.forecast_window_s = forecast_window_s
        self._lock = threading.Lock()
        # (component, id(owner)) -> entry dict; `ref` is a weakref to the
        # owner so dead objects drop out of the accounting on next read
        self._entries: Dict[Tuple[str, int], Dict[str, Any]] = {}
        # rolling ingest deltas: (t, docs, per-device bytes)
        self._deltas: Deque[Tuple[float, int, float]] = collections.deque()
        self.dp = 1
        self.tp = 1
        # per-replica high watermark of per-replica hbm bytes
        self._replica_peak: Dict[str, float] = {}
        self._warned = False
        # headroom checks resolve capacity (possibly via a CUDA device
        # probe) — throttled to 1/s so per-batch ingest stays cheap
        self._warn_check_after = 0.0

    # -- registration (hook sites) ------------------------------------------

    def register(
        self,
        component: str,
        owner: Any,
        nbytes: float,
        *,
        tier: str = "hbm",
        device_span: int = 1,
        dp_shards: int = 1,
        **meta: Any,
    ) -> None:
        """Upsert `owner`'s allocation under `component`.  Re-registering
        the same (component, owner) replaces the entry — growth paths
        (index _grow, params upgraded to a mesh copy) just call again."""
        key = (component, id(owner))
        try:
            ref = weakref.ref(owner)
        except TypeError:  # owner not weakref-able (plain str key etc.)
            ref = None
        with self._lock:
            self._entries[key] = {
                "ref": ref,
                "nbytes": float(nbytes),
                "tier": tier,
                "device_span": max(int(device_span), 1),
                "dp_shards": max(int(dp_shards), 1),
                "meta": meta,
            }
            self._bump_watermark_locked()

    def adjust(self, component: str, owner: Any, delta: float) -> None:
        """Add `delta` bytes to an existing entry (in-flight accounting);
        registers a zero-base entry on first touch."""
        key = (component, id(owner))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                try:
                    ref = weakref.ref(owner)
                except TypeError:
                    ref = None
                entry = self._entries[key] = {
                    "ref": ref,
                    "nbytes": 0.0,
                    "tier": "hbm",
                    "device_span": 1,
                    "dp_shards": 1,
                    "meta": {},
                }
            entry["nbytes"] = max(entry["nbytes"] + float(delta), 0.0)
            self._bump_watermark_locked()

    def release(self, component: str, owner: Any) -> None:
        with self._lock:
            self._entries.pop((component, id(owner)), None)

    def set_topology(self, dp: int, tp: int) -> None:
        """Mesh backend activate/deactivate reports the replica layout so
        per-replica watermarks and placement math label correctly."""
        with self._lock:
            self.dp = max(int(dp), 1)
            self.tp = max(int(tp), 1)

    # -- forecaster ---------------------------------------------------------

    def note_ingest(self, docs: int, device_bytes: float) -> None:
        """One ingest batch landed: `docs` new documents costing
        `device_bytes` of per-device HBM (amortized — growth is bucketed,
        the steady-state rate is what forecasts)."""
        if docs <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._deltas.append((now, int(docs), float(device_bytes)))
            horizon = now - self.forecast_window_s
            while self._deltas and self._deltas[0][0] < horizon:
                self._deltas.popleft()
        self._maybe_warn()

    def forecast(self) -> Dict[str, Any]:
        """docs/s and bytes/doc over the window, projected against the
        current per-device headroom.  Every rate is None until two
        deltas cover a measurable interval; time_to_full_s is None when
        capacity is unknown (CPU with no override) or ingest is idle."""
        now = time.monotonic()
        with self._lock:
            deltas = list(self._deltas)
        docs = sum(d for _, d, _ in deltas)
        bytes_ = sum(b for _, _, b in deltas)
        window = now - deltas[0][0] if len(deltas) > 1 else 0.0
        docs_per_sec = docs / window if window > 0 else None
        bytes_per_sec = bytes_ / window if window > 0 else None
        bytes_per_doc = bytes_ / docs if docs else None
        cap = hbm_capacity_bytes()
        used = self.device_hbm_bytes()
        headroom = cap - used if cap is not None else None
        ttf = None
        if headroom is not None and bytes_per_sec:
            ttf = max(headroom, 0.0) / bytes_per_sec
        return {
            "window_s": round(window, 3),
            "docs": docs,
            "docs_per_sec": docs_per_sec,
            "bytes_per_doc": bytes_per_doc,
            "device_bytes_per_sec": bytes_per_sec,
            "hbm_capacity_bytes": cap,
            "hbm_used_bytes": used,
            "hbm_headroom_bytes": headroom,
            "headroom_pct": (
                100.0 * headroom / cap if cap else None
            ),
            "time_to_full_s": ttf,
        }

    def _maybe_warn(self) -> None:
        if self._warned:
            return
        now = time.monotonic()
        if now < self._warn_check_after:
            return
        self._warn_check_after = now + 1.0
        cap = hbm_capacity_bytes()
        if not cap:
            return
        headroom = cap - self.device_hbm_bytes()
        pct = 100.0 * headroom / cap
        if pct >= HEADROOM_WARN_PCT:
            return
        self._warned = True
        fc = self.forecast()
        ttf = fc.get("time_to_full_s")
        logger.warning(
            "device HBM headroom low: %.1f%% (%.0f of %.0f bytes) left; "
            "projected full in %s",
            pct,
            headroom,
            cap,
            f"{ttf:.0f}s" if ttf is not None else "(ingest idle)",
        )
        RECORDER.record(
            "memory_headroom_low",
            name=f"headroom_pct={pct:.2f}",
            duration_s=ttf if ttf is not None else 0.0,
            rows=int(headroom),
        )

    # -- reading ------------------------------------------------------------

    def _live_entries_locked(self) -> List[Dict[str, Any]]:
        dead = [
            k
            for k, e in self._entries.items()
            if e["ref"] is not None and e["ref"]() is None
        ]
        for k in dead:
            del self._entries[k]
        return [dict(e, key=k) for k, e in self._entries.items()]

    def entries(self, component: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            live = self._live_entries_locked()
        if component is not None:
            live = [e for e in live if e["key"][0] == component]
        return live

    def component_bytes(self) -> Dict[Tuple[str, str], float]:
        """(component, tier) -> logical bytes — the labeled gauge's data."""
        out: Dict[Tuple[str, str], float] = {}
        for e in self.entries():
            k = (e["key"][0], e["tier"])
            out[k] = out.get(k, 0.0) + e["nbytes"]
        return out

    def device_hbm_bytes(self) -> float:
        """What one device holds: sum of nbytes/device_span over hbm
        entries (uniform sharding; the per-device view headroom is
        judged against).  Injected ``mem_pressure`` fault bytes are
        added here so they flow through headroom, the forecast, and the
        warn path exactly like real allocations."""
        used = sum(
            e["nbytes"] / e["device_span"]
            for e in self.entries()
            if e["tier"] == "hbm"
        )
        if faults.ACTIVE:
            used += faults.mem_pressure_bytes()
        return used

    def _per_replica_bytes_locked(self) -> float:
        return sum(
            e["nbytes"] / e["dp_shards"]
            for e in self._live_entries_locked()
            if e["tier"] == "hbm"
        )

    def _bump_watermark_locked(self) -> None:
        per_replica = self._per_replica_bytes_locked()
        for r in range(self.dp):
            label = str(r)
            if per_replica > self._replica_peak.get(label, 0.0):
                self._replica_peak[label] = per_replica

    def replica_peaks(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._replica_peak)

    def snapshot(self) -> Dict[str, Any]:
        """The /status "memory" payload: per-component breakdown, tier
        totals, capacity/headroom, the forecast, replica watermarks, and
        the backend cross-check."""
        components: Dict[str, Dict[str, Any]] = {}
        for e in self.entries():
            comp = e["key"][0]
            slot = components.setdefault(
                comp,
                {"bytes": 0.0, "device_bytes": 0.0, "tier": e["tier"],
                 "entries": 0},
            )
            slot["bytes"] += e["nbytes"]
            slot["device_bytes"] += e["nbytes"] / e["device_span"]
            slot["entries"] += 1
        totals = {
            t: sum(
                c["bytes"] for c in components.values() if c["tier"] == t
            )
            for t in TIERS
        }
        fc = self.forecast()
        return {
            "components": components,
            "total_bytes": sum(totals.values()),
            "hbm_bytes": totals["hbm"],
            "host_bytes": totals["host"],
            "device_hbm_bytes": self.device_hbm_bytes(),
            "hbm_capacity_bytes": fc["hbm_capacity_bytes"],
            "hbm_headroom_bytes": fc["hbm_headroom_bytes"],
            "headroom_pct": fc["headroom_pct"],
            "forecast": fc,
            "replica_peak_bytes": self.replica_peaks(),
            "topology": {"dp": self.dp, "tp": self.tp},
            "device_memory_stats": device_memory_stats(),
            "headroom_warned": self._warned,
        }


_TRACKER = MemoryTracker()


def tracker() -> MemoryTracker:
    return _TRACKER


def headroom_pct() -> Optional[float]:
    """Current per-device headroom as a percentage of capacity — the
    health controller's cheap backpressure input (skips the forecast's
    rate math).  None when accounting is disabled or capacity is
    unknown (the controller then never throttles on memory)."""
    if not ENABLED:
        return None
    cap = hbm_capacity_bytes()
    if not cap:
        return None
    return 100.0 * (cap - _TRACKER.device_hbm_bytes()) / cap


def reset_for_tests(
    forecast_window_s: float = FORECAST_WINDOW_S,
) -> MemoryTracker:
    """Fresh tracker (empty registry, un-warned) — tests and bench phases
    scope accounting to exactly one measured run."""
    global _TRACKER
    _TRACKER = MemoryTracker(forecast_window_s)
    return _TRACKER


# -- gauges -------------------------------------------------------------------

# Process-wide like the utilization gauges: one series set, worker="0".
_REGISTRY = MetricsRegistry(worker="0")


def _component_cb() -> List[Tuple[Tuple[str, ...], float]]:
    if not ENABLED:
        return []
    return [
        ((comp, tier), v)
        for (comp, tier), v in sorted(_TRACKER.component_bytes().items())
    ]


def _headroom_cb() -> Optional[float]:
    if not ENABLED:
        return None
    cap = hbm_capacity_bytes()
    if cap is None:
        return None
    return cap - _TRACKER.device_hbm_bytes()


def _ttf_cb() -> Optional[float]:
    if not ENABLED:
        return None
    return _TRACKER.forecast()["time_to_full_s"]


def _replica_peak_cb() -> List[Tuple[Tuple[str, ...], float]]:
    if not ENABLED:
        return []
    return [
        ((r,), v) for r, v in sorted(_TRACKER.replica_peaks().items())
    ]


_REGISTRY.gauge(
    "pathway_memory_bytes",
    help="Logical bytes attributed to each tracked component "
    "(knn_index/encoder_params/pipeline_inflight/snapshot_staging) by "
    "memory tier (hbm/host); see internals/memtrack.py",
    labels=("component", "tier"),
    callback=_component_cb,
)
_REGISTRY.gauge(
    "pathway_memory_hbm_headroom_bytes",
    help="Per-device HBM capacity minus tracked per-device usage "
    "(absent when capacity is unknown, e.g. CPU CI without "
    "PATHWAY_ASSUME_HBM_BYTES)",
    callback=_headroom_cb,
)
_REGISTRY.gauge(
    "pathway_memory_time_to_full_seconds",
    help="Projected seconds until HBM exhaustion at the rolling-window "
    "ingest rate (absent when capacity is unknown or ingest is idle)",
    callback=_ttf_cb,
)
_REGISTRY.gauge(
    "pathway_memory_replica_peak_bytes",
    help="High watermark of per-dp-replica HBM bytes since process "
    "start (reset with the tracker)",
    labels=("replica",),
    callback=_replica_peak_cb,
)


def memory_metrics() -> MetricsRegistry:
    """Registry holding the memory gauges (scraped by PrometheusServer
    alongside the pipeline/utilization registries)."""
    return _REGISTRY


def memory_status() -> Dict[str, Any]:
    """The `"memory"` key for /status."""
    out: Dict[str, Any] = {"enabled": ENABLED}
    if ENABLED:
        out.update(_TRACKER.snapshot())
        out["recent_events"] = RECORDER.tail(16)
    return out
