"""Cost & efficiency observability: the per-tenant resource-attribution
ledger.

Utilization (internals/utilization.py), memory (internals/memtrack.py),
query tracing (internals/qtrace.py), and the serving tier
(internals/serving.py) each measure their own layer with no common key —
the runtime could not answer "who is spending the device".  This module
is the accounting layer that joins them: every unit of work is charged
to a three-part attribution key

    (workload, route, tenant)

  workload  ingest | serve | maintenance — which pipeline spent it
  route     the serving tier's per-route micro-batcher ("" for work
            with no HTTP route, e.g. ingest dispatches)
  tenant    the admission controller's resolved ``X-Tenant``, carried
            through qtrace spans into the batched dispatch ("" when the
            query was untraced — exactly what PWT801 lints)

Charged resources per cell: device-seconds (the per-dispatch
completion-to-completion estimates the utilization tracker already
computes, plus the wall time of batched searches), useful FLOPs
(internals/costmodel.py), host/device bytes moved (device-pipeline slab
accounting + exchange wire counters), queries, and docs.  HBM-resident
bytes are attributed pull-time from memtrack's component ledger via the
``COMPONENT_WORKLOADS`` mapping (no extra hook).

Charging rule for batched dispatches: qtrace charges EVERY traced query
the FULL batch device time (the dispatch is one SPMD program — shared
wall time IS each query's latency contribution).  The ledger instead
splits the batch's device seconds evenly across the queries that rode
in it, so per-cell charges SUM to the real device time and the two
layers cross-check instead of double-counting.

Conservation invariant (the PWT699 predicted-vs-live pattern): the
ledger notes every charged device-second into the utilization tracker's
window too, so ``sum(attributed) ~= utilization window total`` within
5% — ``conservation()`` reports the live ratio and
tests/test_costledger.py enforces it on the 8-device CPU mesh.

Surfaces: ``pathway_cost_device_seconds_total`` /
``pathway_cost_flops_total`` / ``pathway_cost_bytes_total`` (all labeled
``{workload,route,tenant}``) plus derived efficiency gauges
(device-seconds per 1k queries, FLOPs per ingested doc, cache-hit
savings per tenant, attributed-efficiency pct — None when the device
peak is unknown, which PWT802 lints); ``cost_status()`` is the
``"cost"`` key in /status and feeds ``pathway-tpu top``; the rolling
``workload_shares()`` window hands the serving-tier
``DeviceTimePartitioner`` a real per-workload device-share signal.

``PATHWAY_COSTLEDGER=0`` disables everything: every hook site guards on
the module attribute ``ENABLED``, so the disabled cost is one attribute
read (enforced by tests/test_perf_smoke.py).  Imports only the stdlib —
never jax.

Config:
  PATHWAY_COSTLEDGER=0        disable (default: enabled)
  PATHWAY_COST_WINDOW_S=F     rolling share window (default 30 — the
                              utilization window, so the conservation
                              cross-check compares like with like)
"""

from __future__ import annotations

import os
import threading
import time as time_mod
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

ENABLED = os.environ.get("PATHWAY_COSTLEDGER", "1") != "0"

WORKLOADS = ("ingest", "serve", "maintenance")

WINDOW_S = float(os.environ.get("PATHWAY_COST_WINDOW_S", "30") or 30)

# memtrack component -> workload for the pull-time HBM-resident gauge
# (memtrack.COMPONENT_WORKLOADS mirrors this; kept there so the two
# modules can't drift apart silently).
_CELL_FIELDS = ("device_s", "flops", "bytes", "queries", "docs")

# EWMA factor for the per-query serve cost estimate behind the
# cache-savings gauge (computed, not inferred: savings = hits x the
# live average device cost of an UNCACHED query).
_EWMA_ALPHA = 0.2


class CostLedger:
    """Process-wide attribution cells + the rolling share window.

    Locking: one lock guards the cells and the window.  Charge sites are
    per-dispatch / per-batch (not per-row), so a plain lock is cheap —
    the same granularity the utilization tracker uses.
    """

    def __init__(self) -> None:
        from pathway_tpu_torch.internals.metrics import MetricsRegistry

        self._lock = threading.Lock()
        # (workload, route, tenant) -> {device_s, flops, bytes, queries, docs}
        self._cells: Dict[Tuple[str, str, str], Dict[str, float]] = {}
        self._cache_hits: Dict[str, int] = {}
        self._cache_saved_s: Dict[str, float] = {}
        self._serve_query_cost_ewma: Optional[float] = None
        # rolling (t, workload, device_s) — the partitioner's share signal
        # and the conservation cross-check window
        self._window: Deque[Tuple[float, str, float]] = deque()
        self.window_s = WINDOW_S
        reg = self.registry = MetricsRegistry(worker="0")
        reg.counter(
            "pathway_cost_device_seconds_total",
            help="Attributed device-seconds by (workload, route, tenant) "
            "— batched dispatches split evenly across their queries so "
            "cells sum to real device time",
            labels=("workload", "route", "tenant"),
            callback=self._cell_samples("device_s"),
        )
        reg.counter(
            "pathway_cost_flops_total",
            help="Attributed useful FLOPs (internals/costmodel.py) by "
            "(workload, route, tenant)",
            labels=("workload", "route", "tenant"),
            callback=self._cell_samples("flops"),
        )
        reg.counter(
            "pathway_cost_bytes_total",
            help="Attributed host/device bytes moved (pipeline slabs, "
            "exchange wire frames) by (workload, route, tenant)",
            labels=("workload", "route", "tenant"),
            callback=self._cell_samples("bytes"),
        )
        reg.gauge(
            "pathway_cost_device_seconds_per_1k_queries",
            help="Per-tenant serve efficiency: attributed device-seconds "
            "per 1000 served queries",
            labels=("tenant",),
            callback=self._per_1k_queries_samples,
        )
        reg.gauge(
            "pathway_cost_flops_per_doc",
            help="Ingest efficiency: attributed useful FLOPs per "
            "ingested document",
            callback=self._flops_per_doc,
        )
        reg.counter(
            "pathway_cost_cache_saved_device_seconds_total",
            help="Per-tenant device-seconds saved by result-cache hits "
            "(hits x live EWMA cost of an uncached query)",
            labels=("tenant",),
            callback=self._cache_saved_samples,
        )
        reg.gauge(
            "pathway_cost_efficiency_pct",
            help="Attributed FLOPs over attributed device-seconds vs the "
            "chip peak (absent when the device peak is unknown — see "
            "analyzer PWT802)",
            callback=self._efficiency_pct,
        )
        reg.gauge(
            "pathway_cost_hbm_bytes",
            help="HBM-resident bytes attributed per workload (memtrack "
            "components mapped through COMPONENT_WORKLOADS)",
            labels=("workload",),
            callback=self._hbm_samples,
        )

    # -- charging (hook sites guard on ENABLED) ----------------------------

    def charge(
        self,
        workload: str,
        route: str = "",
        tenant: str = "",
        *,
        device_s: float = 0.0,
        flops: float = 0.0,
        bytes_moved: float = 0.0,
        queries: int = 0,
        docs: int = 0,
    ) -> None:
        key = (workload, route, tenant)
        now = time_mod.monotonic()
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = {f: 0.0 for f in _CELL_FIELDS}
            cell["device_s"] += float(device_s)
            cell["flops"] += float(flops)
            cell["bytes"] += float(bytes_moved)
            cell["queries"] += int(queries)
            cell["docs"] += int(docs)
            if device_s:
                self._window.append((now, workload, float(device_s)))
                self._prune(now)

    def charge_search(self, q_keys, elapsed: float, tracer=None) -> None:
        """Charge one batched search dispatch: split its wall time evenly
        across the queries that rode in it, attributed by the (route,
        tenant) each traced query carries.  Untraced queries charge to
        ("", "") — the unattributable bucket PWT801 warns about.  The
        full elapsed also feeds the utilization window so the
        conservation invariant holds under concurrent ingest + serving."""
        n = len(q_keys)
        if not n or elapsed <= 0:
            return
        share = elapsed / n
        attrib: Dict[Any, Tuple[str, str]] = {}
        if tracer is not None:
            attrib = tracer.attribution_for_keys(q_keys)
        per_cell: Dict[Tuple[str, str], int] = {}
        for k in q_keys:
            rt = attrib.get(k, ("", ""))
            per_cell[rt] = per_cell.get(rt, 0) + 1
        for (route, tenant), count in per_cell.items():
            self.charge(
                "serve", route, tenant,
                device_s=share * count, queries=count,
            )
        with self._lock:
            ewma = self._serve_query_cost_ewma
            self._serve_query_cost_ewma = (
                share if ewma is None
                else (1.0 - _EWMA_ALPHA) * ewma + _EWMA_ALPHA * share
            )
        from pathway_tpu_torch.internals import utilization

        if utilization.ENABLED:
            utilization.tracker().note_span("device", elapsed)

    def note_cache_hits(self, tenants) -> None:
        """Result-cache hits: count them per tenant and book the saved
        device-seconds (hits x the live EWMA cost of an uncached query —
        computed, not inferred from the hit-rate)."""
        with self._lock:
            saved_each = self._serve_query_cost_ewma or 0.0
            for tenant in tenants:
                self._cache_hits[tenant] = self._cache_hits.get(tenant, 0) + 1
                self._cache_saved_s[tenant] = (
                    self._cache_saved_s.get(tenant, 0.0) + saved_each
                )

    # -- reading -----------------------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        win = self._window
        while win and win[0][0] < horizon:
            win.popleft()

    def workload_shares(self) -> Dict[str, Any]:
        """Rolling-window device-seconds per workload + each workload's
        share of the attributed total — the partitioner's signal."""
        now = time_mod.monotonic()
        with self._lock:
            self._prune(now)
            seconds = {w: 0.0 for w in WORKLOADS}
            for _t, workload, device_s in self._window:
                seconds[workload] = seconds.get(workload, 0.0) + device_s
        total = sum(seconds.values())
        return {
            "window_s": self.window_s,
            "seconds": {w: round(s, 6) for w, s in seconds.items()},
            "total_s": round(total, 6),
            "shares": {
                w: (round(s / total, 4) if total > 0 else None)
                for w, s in seconds.items()
            },
        }

    def conservation(self) -> Dict[str, Any]:
        """Attributed window device-seconds vs the utilization tracker's
        window total (the trust check: within 5% or the attribution is
        lying).  Ratio is None while nothing was attributed."""
        from pathway_tpu_torch.internals import utilization

        shares = self.workload_shares()
        attributed = shares["total_s"]
        window_total = (
            utilization.device_window_seconds()
            if utilization.ENABLED
            else None
        )
        ratio = None
        if window_total and attributed:
            ratio = round(attributed / window_total, 4)
        return {
            "attributed_s": attributed,
            "utilization_window_s": window_total,
            "ratio": ratio,
        }

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Cumulative per-workload rollup of every cell."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for (workload, _r, _t), cell in self._cells.items():
                agg = out.setdefault(
                    workload, {f: 0.0 for f in _CELL_FIELDS}
                )
                for f in _CELL_FIELDS:
                    agg[f] += cell[f]
            return out

    def top_cells(self, n: int = 8) -> List[Dict[str, Any]]:
        """Heaviest attribution cells by device-seconds (the `top` rows)."""
        with self._lock:
            items = sorted(
                self._cells.items(),
                key=lambda kv: kv[1]["device_s"],
                reverse=True,
            )[:n]
        return [
            {
                "workload": w, "route": r, "tenant": t,
                "device_s": round(cell["device_s"], 6),
                "flops": cell["flops"],
                "bytes": cell["bytes"],
                "queries": int(cell["queries"]),
                "docs": int(cell["docs"]),
            }
            for (w, r, t), cell in items
        ]

    def status(self) -> Dict[str, Any]:
        """The ``"cost"`` key for /status."""
        from pathway_tpu_torch.internals import costmodel, mesh_backend

        totals = self.totals()
        eff = self._efficiency_pct()
        with self._lock:
            cache = {
                t: {
                    "hits": self._cache_hits[t],
                    "saved_device_s": round(self._cache_saved_s[t], 6),
                }
                for t in self._cache_hits
            }
        return {
            "enabled": True,
            "devices": mesh_backend.device_count(),
            "totals": {
                w: {
                    "device_s": round(agg["device_s"], 6),
                    "flops": agg["flops"],
                    "bytes": agg["bytes"],
                    "queries": int(agg["queries"]),
                    "docs": int(agg["docs"]),
                }
                for w, agg in totals.items()
            },
            "top": self.top_cells(),
            "shares": self.workload_shares(),
            "conservation": self.conservation(),
            "efficiency_pct": eff,
            "device_capacity_known": costmodel.device_capacity_known(),
            "cache_savings": cache,
        }

    # -- gauge callbacks (pull-time only) ----------------------------------

    def _cell_samples(self, field: str):
        def cb() -> List[Tuple[Tuple[str, str, str], float]]:
            with self._lock:
                return [
                    (key, cell[field])
                    for key, cell in self._cells.items()
                ]

        return cb

    def _per_1k_queries_samples(self) -> List[Tuple[Tuple[str], float]]:
        per_tenant: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for (workload, _r, tenant), cell in self._cells.items():
                if workload != "serve":
                    continue
                agg = per_tenant.setdefault(
                    tenant, {"device_s": 0.0, "queries": 0.0}
                )
                agg["device_s"] += cell["device_s"]
                agg["queries"] += cell["queries"]
        return [
            ((tenant,), 1000.0 * agg["device_s"] / agg["queries"])
            for tenant, agg in per_tenant.items()
            if agg["queries"]
        ]

    def _flops_per_doc(self) -> Optional[float]:
        ingest = self.totals().get("ingest")
        if not ingest or not ingest["docs"]:
            return None
        return ingest["flops"] / ingest["docs"]

    def _cache_saved_samples(self) -> List[Tuple[Tuple[str], float]]:
        with self._lock:
            return [
                ((tenant,), saved)
                for tenant, saved in self._cache_saved_s.items()
            ]

    def _efficiency_pct(self) -> Optional[float]:
        """Attributed FLOPs over attributed device-seconds against the
        chip peak.  None (never 0) when the peak is unknown — the PWT802
        condition — or when nothing was attributed yet."""
        from pathway_tpu_torch.internals import costmodel, mesh_backend

        peak = costmodel.device_peak_flops()
        if not peak:
            return None
        totals = self.totals()
        device_s = sum(agg["device_s"] for agg in totals.values())
        flops = sum(agg["flops"] for agg in totals.values())
        if not device_s:
            return None
        capacity = device_s * peak * mesh_backend.device_count()
        return round(100.0 * flops / capacity, 4)

    def _hbm_samples(self) -> List[Tuple[Tuple[str], float]]:
        from pathway_tpu_torch.internals import memtrack

        if not memtrack.ENABLED:
            return []
        per: Dict[str, float] = {}
        for (component, tier), nbytes in (
            memtrack.tracker().component_bytes().items()
        ):
            if tier != "hbm":
                continue
            workload = memtrack.COMPONENT_WORKLOADS.get(
                component, "maintenance"
            )
            per[workload] = per.get(workload, 0.0) + nbytes
        return [((w,), v) for w, v in sorted(per.items())]


# -- process-wide singleton ---------------------------------------------------

_LEDGER: Optional[CostLedger] = None
_singleton_lock = threading.Lock()


def ledger() -> CostLedger:
    global _LEDGER
    led = _LEDGER
    if led is None:
        with _singleton_lock:
            led = _LEDGER
            if led is None:
                led = _LEDGER = CostLedger()
    return led


def reset_for_tests() -> None:
    """Fresh ledger (tests/benches scoping an attribution window)."""
    global _LEDGER
    with _singleton_lock:
        _LEDGER = None


def on_run_start() -> None:
    """runner.run() hook: instantiate the ledger at dataflow start so a
    served job always exports the pathway_cost_* families."""
    if not ENABLED:
        return
    ledger()


# -- hook-site sugar (hook sites ALSO guard on ENABLED — one attribute
# read is the whole disabled cost) --------------------------------------------


def charge(
    workload: str,
    route: str = "",
    tenant: str = "",
    *,
    device_s: float = 0.0,
    flops: float = 0.0,
    bytes_moved: float = 0.0,
    queries: int = 0,
    docs: int = 0,
) -> None:
    if not ENABLED:
        return
    ledger().charge(
        workload, route, tenant,
        device_s=device_s, flops=flops, bytes_moved=bytes_moved,
        queries=queries, docs=docs,
    )


def charge_search(q_keys, elapsed: float, tracer=None) -> None:
    if not ENABLED:
        return
    ledger().charge_search(q_keys, elapsed, tracer=tracer)


def note_cache_hits(tenants) -> None:
    if not ENABLED or not tenants:
        return
    ledger().note_cache_hits(tenants)


def serve_device_share() -> Optional[float]:
    """The serving workload's share of attributed device time over the
    rolling window — the DeviceTimePartitioner's signal.  None when the
    ledger is disabled, never instantiated, or the window is empty (the
    partitioner then falls back to its binary burn heuristic)."""
    if not ENABLED:
        return None
    led = _LEDGER
    if led is None:
        return None
    return led.workload_shares()["shares"].get("serve")


def cost_metrics():
    """The ledger registry for PrometheusServer._registries(); None when
    disabled or never instantiated (pure-ingest jobs that never charged)."""
    if not ENABLED or _LEDGER is None:
        return None
    return _LEDGER.registry


def cost_status() -> Dict[str, Any]:
    """The ``"cost"`` key for /status."""
    if not ENABLED:
        return {"enabled": False}
    if _LEDGER is None:
        return {"enabled": True, "active": False}
    out = ledger().status()
    out["active"] = True
    return out
