"""Monitoring: probe stats, console dashboard, Prometheus endpoint.

TPU-native rebuild of the reference observability stack (reference:
python/pathway/internals/monitoring.py StatsMonitor:186 (rich dashboard),
src/engine/dataflow/monitoring.rs ProberStats, src/engine/http_server.rs:22
(Prometheus per worker on port 20000+process_id))."""

from __future__ import annotations

import enum
import http.server
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class MonitoringLevel(enum.Enum):
    AUTO = "auto"
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


@dataclass
class ProberStats:
    """reference: dataflow/monitoring.rs ProberStats."""

    rows_processed: int = 0
    batches_processed: int = 0
    current_time: int = 0
    input_latency_ms: float | None = None
    started_at: float = field(default_factory=time.time)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "rows_processed": self.rows_processed,
            "batches_processed": self.batches_processed,
            "current_time": self.current_time,
            "uptime_s": round(time.time() - self.started_at, 1),
        }


def node_path_stats(engine) -> list[Dict[str, Any]]:
    """Per-node execution-path counters for nodes that declare one.

    Columnar nodes (VectorJoinNode, VectorFlattenNode, VectorReduceNode)
    set ``path = "columnar"`` as a class attribute and bump
    ``rows_processed`` / ``batches_processed`` per batch; classic nodes
    leave ``path`` as None and are omitted.  This is how tests (and
    operators) prove WHICH implementation the build-time gates actually
    selected — graph shape alone does not show it."""
    out = []
    for idx, node in enumerate(engine.nodes):
        path = getattr(node, "path", None)
        if path is None:
            continue
        out.append(
            {
                "node": idx,
                "name": node.name,
                "type": type(node).__name__,
                "path": path,
                "rows_processed": node.rows_processed,
                "batches_processed": node.batches_processed,
            }
        )
    return out


def fusion_status(engine) -> Dict[str, Any] | None:
    """The fusion contract as /status reports it: per planned chain, how
    many ops it covers and whether (and how hard) the fused node actually
    ran.  None when no plan was installed (fusion disabled or a raw
    engine); `nodes_saved` is the headline — engine nodes that never
    existed because chains collapsed."""
    plan = getattr(engine, "fusion_plan", None)
    if plan is None:
        return None
    built = {
        tuple(getattr(n, "op_ids", ())): n
        for n in getattr(engine, "fused_chains", ())
    }
    chains = []
    saved = 0
    for c in plan.get("chains", ()):
        node = built.get(tuple(c["op_ids"]))
        if node is not None:
            saved += c["length"] - 1
        chains.append(
            {
                "id": c["id"],
                "ops": c["length"],
                "kinds": list(c["kinds"]),
                "built": node is not None,
                "rows_processed": (
                    node.rows_processed if node is not None else 0
                ),
                "batches_processed": (
                    node.batches_processed if node is not None else 0
                ),
            }
        )
    return {
        "enabled": bool(plan.get("enabled")),
        "chains": chains,
        "nodes_saved": saved,
    }


class StatsMonitor:
    """Console dashboard over engine stats (reference: monitoring.py
    StatsMonitor:186 — rich Live table)."""

    def __init__(self, engine):
        self.engine = engine
        self.stats = ProberStats()
        self._live = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def refresh(self) -> None:
        self.stats.rows_processed = self.engine.stats_rows
        self.stats.current_time = self.engine.current_time
        self.stats.input_latency_ms = getattr(
            self.engine, "last_batch_latency_ms", None
        )

    def render(self):
        from rich.table import Table as RichTable

        self.refresh()
        table = RichTable(title="pathway_tpu_torch")
        table.add_column("metric")
        table.add_column("value")
        snap = self.stats.snapshot()
        if self.stats.input_latency_ms is not None:
            snap["batch_latency_ms"] = round(self.stats.input_latency_ms, 2)
        m = getattr(self.engine, "metrics", None)
        if m is not None:
            snap["ticks"] = m.ticks
            lag = m._watermark_lag()
            snap["watermark_lag_s"] = round(lag, 2)
            snap["scheduled_backlog"] = len(self.engine._scheduled_times)
        for k, v in snap.items():
            table.add_row(k, str(v))
        # per-connector monitors (reference: connectors/monitoring.rs)
        for name, cs in sorted(
            getattr(self.engine, "connector_stats", {}).items()
        ):
            table.add_row(
                f"source {name}",
                f"rows={cs['rows_read']} pending={cs['pending']}"
                f" lag={cs.get('read_lag_s', 0.0):.1f}s"
                f" retries={cs.get('retries', 0)}",
            )
        for ps in node_path_stats(self.engine):
            table.add_row(
                f"{ps['name']}#{ps['node']} [{ps['path']}]",
                f"rows={ps['rows_processed']} batches={ps['batches_processed']}",
            )
        # hottest nodes by total process() time, with latency percentiles
        if m is not None:
            stats = sorted(
                m.node_latency_stats(),
                key=lambda s: s["total_s"],
                reverse=True,
            )
            for s in stats[:8]:
                if not s["calls"]:
                    continue
                table.add_row(
                    f"node {s['name']}#{s['node']} ({s['type']})",
                    f"p50={s['p50_ms']}ms p99={s['p99_ms']}ms"
                    f" calls={s['calls']} total={s['total_s']:.3f}s",
                )
            # per-sink freshness (ingest->emit lag; streaming runs only)
            for fs in m.sink_freshness_stats():
                table.add_row(
                    f"sink {fs['sink']} freshness",
                    f"p50={fs['p50_ms']}ms p99={fs['p99_ms']}ms"
                    f" last={fs['last_ms']}ms n={fs['count']}",
                )
            # async device pipeline (ingest hot path): queue/in-flight
            # occupancy + how much of each dispatched slab was padding
            from pathway_tpu_torch.internals.device_pipeline import pipeline_status

            ps = pipeline_status()
            if ps.get("active"):
                waste = ps.get("pad_waste_ratio")
                occ = ps.get("occupancy")
                row = (
                    f"queued={ps.get('queue_depth', 0)}"
                    f" in_flight={ps.get('in_flight', 0)}"
                    f" dispatched={ps.get('dispatched', 0)}"
                )
                if occ is not None:
                    row += f" occ={occ:.2f}"
                table.add_row("device pipeline", row)
                if waste is not None:
                    table.add_row(
                        "device pad waste", f"{100.0 * waste:.1f}%"
                    )
            # live utilization (internals/utilization.py): rolling MFU,
            # tokens/s, and where the window's wall time went
            from pathway_tpu_torch.internals import utilization

            if utilization.ENABLED:
                snap_u = utilization.tracker().snapshot()
                if snap_u["dispatches"]:
                    row = (
                        f"tokens/s={snap_u['tokens_per_sec']:.0f}"
                        f" docs/s={snap_u['docs_per_sec']:.1f}"
                        f" [{snap_u['bound_state']}]"
                    )
                    if snap_u["mfu_pct"] is not None:
                        row = f"mfu={snap_u['mfu_pct']:.1f}% " + row
                    table.add_row("device utilization", row)
            # memory attribution (internals/memtrack.py): who owns HBM
            # and how long until the index fills it
            from pathway_tpu_torch.internals import memtrack

            if memtrack.ENABLED:
                snap_m = memtrack.tracker().snapshot()
                if snap_m["components"]:
                    row = f"hbm={snap_m['device_hbm_bytes'] / 2**20:.1f}MiB"
                    pct = snap_m.get("headroom_pct")
                    if pct is not None:
                        row += f" headroom={pct:.1f}%"
                    parts = ", ".join(
                        f"{name}={c['bytes'] / 2**20:.1f}MiB"
                        for name, c in sorted(snap_m["components"].items())
                    )
                    table.add_row("device memory", f"{row} ({parts})")
                    ttf = snap_m["forecast"].get("time_to_full_s")
                    if ttf is not None:
                        table.add_row(
                            "memory time-to-full", f"{ttf:.0f}s"
                        )
            from pathway_tpu_torch.internals.mesh_backend import active_backend

            backend = active_backend()
            if backend is not None:
                skew = backend._skew_ratio_or_none()
                if skew is not None:
                    row = f"skew={skew:.2f}x"
                    straggler = backend.straggler()
                    if straggler:
                        row += f" STRAGGLER replica {straggler['replica']}"
                    table.add_row("mesh replica balance", row)
            # self-healing controller: show only when it has acted or is
            # actively holding pressure / a drain / a roll
            from pathway_tpu_torch.internals import health

            if health.ENABLED:
                hs = health.health_status()
                acted = any(hs.get("actions", {}).values())
                if (
                    acted
                    or hs.get("pressure")
                    or hs.get("drained_replicas")
                    or hs.get("rolling_restart", {}).get("in_progress")
                ):
                    row = f"bp_scale={hs['backpressure_scale']:.3f}"
                    if hs.get("pressure_reason"):
                        row += f" [{hs['pressure_reason']}]"
                    if hs.get("drained_replicas"):
                        row += (
                            " drained="
                            f"{sorted(hs['drained_replicas'])}"
                        )
                    roll = hs.get("rolling_restart", {})
                    if roll.get("in_progress"):
                        cur = roll.get("current") or {}
                        row += (
                            f" rolling worker {cur.get('worker')}"
                            f" ({cur.get('phase')})"
                        )
                    table.add_row("health", row)
            # serving path (internals/qtrace.py): QPS + digest-backed
            # per-stage tail latency + SLO burn state
            from pathway_tpu_torch.internals import qtrace

            if qtrace.ENABLED:
                qs = qtrace.tracker().status()
                if qs.get("completed"):
                    total = qs["stages"].get("total", {})
                    row = (
                        f"qps={qs['qps']}"
                        f" p50={total.get('p50_ms')}ms"
                        f" p99={total.get('p99_ms')}ms"
                        f" n={qs['completed']}"
                    )
                    table.add_row("queries", row)
                    slo = qs.get("slo", {})
                    if slo.get("target_p99_ms") is not None:
                        row = (
                            f"target={slo['target_p99_ms']}ms"
                            f" burn={slo.get('burn_rate')}"
                            f" violations={slo.get('violations')}"
                        )
                        if slo.get("burning"):
                            row += " BURNING"
                        table.add_row("slo", row)
                    slowest = {
                        s: st.get("p99_ms")
                        for s, st in qs["stages"].items()
                        if s != "total"
                    }
                    if slowest:
                        table.add_row(
                            "query stages p99",
                            " ".join(
                                f"{s}={v}ms"
                                for s, v in sorted(slowest.items())
                            ),
                        )
            # serving tier (internals/serving.py): batch coalescing,
            # cache effectiveness, admission sheds, priority lane
            from pathway_tpu_torch.internals import serving

            if serving.ENABLED:
                ss = serving.serving_status()
                if ss.get("active") and (
                    ss.get("batches")
                    or ss.get("admission", {}).get("shed_total")
                    or ss.get("cache", {}).get("hits")
                ):
                    row = (
                        f"batches={ss['batches']}"
                        f" occ_p50={ss.get('batch_occupancy_p50')}"
                        f" occ_p99={ss.get('batch_occupancy_p99')}"
                    )
                    cache = ss.get("cache", {})
                    if cache.get("hit_rate") is not None:
                        row += f" cache_hit={cache['hit_rate']}"
                    adm = ss.get("admission", {})
                    if adm.get("shed_total"):
                        row += f" shed={adm['shed_total']}"
                    if ss.get("partitioner", {}).get("priority"):
                        row += " PRIORITY"
                    table.add_row("serving", row)
            # cost ledger (internals/costledger.py): who is spending the
            # device, one line per workload with attributed seconds
            from pathway_tpu_torch.internals import costledger

            if costledger.ENABLED:
                cs = costledger.cost_status()
                shares = cs.get("shares", {}).get("shares") or {}
                parts = [
                    f"{w}={share:.0%}"
                    for w, share in sorted(shares.items())
                    if share is not None and share > 0
                ]
                if parts:
                    table.add_row("device share", " ".join(parts))
            # critical-path attribution for the latest sampled epoch
            tr = getattr(m, "trace", None)
            cp = tr.critical_path() if tr is not None else None
            if cp:
                table.add_row(
                    "critical path",
                    f"epoch {cp['epoch']} total={cp['total_ms']}ms",
                )
                for ent in cp["entries"]:
                    table.add_row(
                        f"  [{ent['kind']}] {ent['name']} w{ent['worker']}",
                        f"{ent['duration_ms']}ms"
                        + (
                            f" ({ent['share_pct']}%)"
                            if ent.get("share_pct") is not None
                            else ""
                        ),
                    )
        return table

    def start_live(self, refresh_per_second: float = 2.0):
        from rich.live import Live

        self._live = Live(
            self.render(), refresh_per_second=refresh_per_second
        )
        self._live.start()
        self._stop.clear()

        def updater():
            # Event.wait doubles as the frame clock and the stop signal:
            # stop() flips it and joins, so a final render can never race
            # the Live teardown
            while not self._stop.wait(1.0 / refresh_per_second):
                live = self._live
                if live is None:
                    break
                try:
                    live.update(self.render())
                except Exception:  # noqa: BLE001
                    break

        self._thread = threading.Thread(target=updater, daemon=True)
        self._thread.start()
        return self._live

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._live is not None:
            self._live.stop()
            self._live = None


class PrometheusServer:
    """Per-process metrics endpoint, port 20000+process_id (reference:
    src/engine/http_server.rs:22).

    Serves every worker visible from this process: with thread workers
    the owning engine's coordinator group lists all sibling engines, so a
    single scrape returns series for worker="0", worker="1", ... plus the
    transport registries (exchange bytes/queue depth/wait histograms).

    Routes: ``/metrics`` (and ``/``) — Prometheus exposition format;
    ``/status`` — JSON with graph topology, per-node p50/p99 latency,
    connector stats, and the flight-recorder tail per worker;
    ``/qtrace`` — Chrome-trace JSON of recent query span trees;
    ``/explain?key=...`` — backward lineage tree for one output key
    (404 unless ``PATHWAY_PROVENANCE=1``)."""

    def __init__(self, engine, process_id: int = 0, port: int | None = None):
        self.engine = engine
        self.port = port if port is not None else 20000 + process_id
        self._httpd = None

    def _engines(self) -> list:
        engines = [self.engine]
        group = getattr(getattr(self.engine, "coord", None), "group", None)
        for e in getattr(group, "engines", ()) or ():
            if e not in engines:
                engines.append(e)
        return engines

    def _registries(self) -> list:
        regs: list = []
        seen: set = set()

        def add(reg):
            if reg is not None and id(reg) not in seen:
                seen.add(id(reg))
                regs.append(reg)

        for e in self._engines():
            m = getattr(e, "metrics", None)
            add(getattr(m, "registry", None))
            coord = getattr(e, "coord", None)
            add(getattr(coord, "metrics", None))
            # thread facades share one TCP inter-process transport
            tcp = getattr(getattr(coord, "group", None), "tcp", None)
            add(getattr(tcp, "metrics", None))
        # process-wide device-health gauges (satellite of the tracing PR)
        from pathway_tpu_torch.internals import device_probe

        monitor = device_probe._monitor
        if monitor is not None:
            add(monitor.metrics)
        # async device-pipeline gauges (pad-waste ratio, queue depth,
        # in-flight window occupancy; internals/device_pipeline.py)
        from pathway_tpu_torch.internals.device_pipeline import pipeline_metrics

        add(pipeline_metrics())
        # live utilization gauges (MFU / tokens-per-sec / bound state;
        # internals/utilization.py)
        from pathway_tpu_torch.internals.utilization import utilization_metrics

        add(utilization_metrics())
        # memory attribution gauges (per-component bytes, HBM headroom,
        # time-to-full forecast; internals/memtrack.py)
        from pathway_tpu_torch.internals.memtrack import memory_metrics

        add(memory_metrics())
        # per-dp-replica device-time histograms + skew gauge when a mesh
        # backend is active (internals/mesh_backend.py)
        from pathway_tpu_torch.internals.mesh_backend import active_backend

        backend = active_backend()
        if backend is not None:
            add(backend.metrics)
        # health-controller action counters (internals/health.py):
        # pathway_health_actions_total{action}
        from pathway_tpu_torch.internals.health import health_metrics

        add(health_metrics())
        # query-path SLO observability (internals/qtrace.py): digest
        # quantiles pathway_query_latency_seconds{stage,quantile}, QPS,
        # SLO burn rate
        from pathway_tpu_torch.internals.qtrace import qtrace_metrics

        add(qtrace_metrics())
        # serving tier (internals/serving.py): batch occupancy, cache
        # hit/miss/invalidation, sheds by reason, priority-lane gauge
        from pathway_tpu_torch.internals.serving import serving_metrics

        add(serving_metrics())
        # cost ledger (internals/costledger.py): attributed
        # device-seconds/FLOPs/bytes by (workload, route, tenant) plus
        # derived efficiency gauges
        from pathway_tpu_torch.internals.costledger import cost_metrics

        add(cost_metrics())
        # consistency sanitizer (internals/sanitizer.py): invariant
        # checks performed / violations detected, by check kind
        from pathway_tpu_torch.internals.sanitizer import sanitizer_metrics

        add(sanitizer_metrics())
        # record-level lineage (internals/provenance.py): edge store
        # size/bytes, records, truncations, sampled fraction
        from pathway_tpu_torch.internals.provenance import provenance_metrics

        add(provenance_metrics())
        return regs

    def metrics_text(self) -> str:
        regs = self._registries()
        if regs:
            from pathway_tpu_torch.internals.metrics import render_registries

            return render_registries(regs)
        # metrics disabled on the engine (bench A/B mode): minimal legacy
        # counters so the endpoint still answers
        e = self.engine
        w = f'{{worker="{e.worker_id}"}}'
        return (
            "# TYPE pathway_rows_processed counter\n"
            f"pathway_rows_processed{w} {e.stats_rows}\n"
            "# TYPE pathway_engine_time gauge\n"
            f"pathway_engine_time{w} {e.current_time}\n"
            "# TYPE pathway_error_count counter\n"
            f"pathway_error_count{w} {len(e.error_log)}\n"
        )

    def status_json(self) -> Dict[str, Any]:
        workers = []
        for e in self._engines():
            m = getattr(e, "metrics", None)
            workers.append(
                {
                    "worker": e.worker_id,
                    "engine_time": e.current_time,
                    "rows_processed": e.stats_rows,
                    "errors": len(e.error_log),
                    "ticks": m.ticks if m is not None else None,
                    "watermark_lag_s": (
                        round(m._watermark_lag(), 3) if m is not None else None
                    ),
                    "scheduled_backlog": len(e._scheduled_times),
                    "connectors": dict(
                        getattr(e, "connector_stats", None) or {}
                    ),
                    "nodes": (
                        m.node_latency_stats() if m is not None else []
                    ),
                    "flight_recorder": (
                        m.recorder.tail() if m is not None else []
                    ),
                    "freshness": (
                        m.sink_freshness_stats() if m is not None else []
                    ),
                    # fault-tolerance counters (engine/engine.py): live
                    # failovers survived and snapshot-aligned sink commits
                    "failovers": getattr(e, "failover_count", 0),
                    "failover_recovery_s": getattr(
                        e, "last_failover_recovery_s", None
                    ),
                    "sink_txn_commits": getattr(e, "sink_txn_commits", 0),
                }
            )
        e0 = self.engine
        topology = [
            {
                "node": idx,
                "name": n.name,
                "type": type(n).__name__,
                "inputs": [getattr(i, "_idx", -1) for i in n.inputs],
                "path": getattr(n, "path", None),
            }
            for idx, n in enumerate(e0.nodes)
        ]
        from pathway_tpu_torch.internals.costledger import cost_status
        from pathway_tpu_torch.internals.device_pipeline import pipeline_status
        from pathway_tpu_torch.internals.device_probe import device_status
        from pathway_tpu_torch.internals.health import health_status
        from pathway_tpu_torch.internals.memtrack import memory_status
        from pathway_tpu_torch.internals.mesh_backend import mesh_status
        from pathway_tpu_torch.internals.provenance import provenance_status
        from pathway_tpu_torch.internals.qtrace import qtrace_status
        from pathway_tpu_torch.internals.sanitizer import sanitizer_status
        from pathway_tpu_torch.internals.serving import serving_status
        from pathway_tpu_torch.internals.tracing import merged_critical_path
        from pathway_tpu_torch.internals.utilization import utilization_status

        return {
            "worker_count": e0.worker_count,
            "graph": topology,
            "workers": workers,
            # per-sink freshness merged across this process's workers
            "sinks": self._merged_freshness(),
            # latency attribution for the latest sampled epoch (all
            # in-process workers; see internals/tracing.py)
            "critical_path": merged_critical_path(self._engines()),
            # accelerator health (internals/device_probe.py)
            "device": device_status(),
            # async ingest pipeline (internals/device_pipeline.py):
            # queue depth, in-flight window, cumulative pad-waste ratio
            "device_pipeline": pipeline_status(),
            # live device utilization (internals/utilization.py):
            # rolling-window MFU, tokens/s, bound-state attribution,
            # profiler-capture state
            "utilization": utilization_status(),
            # memory attribution (internals/memtrack.py): per-component
            # HBM/host bytes, capacity/headroom, ingest-rate time-to-full
            # forecast, per-replica watermarks, CUDA cross-check
            "memory": memory_status(),
            # mesh execution backend (internals/mesh_backend.py): axes,
            # per-dp-replica occupancy/queue gauges; lint-only spec dict
            # when armed without enough devices, None without a mesh
            "mesh": mesh_status(e0),
            # self-healing controller (internals/health.py): drained
            # replicas, backpressure scale, rolling-restart progress and
            # per-worker recovery times, recent actions
            "health": health_status(),
            # query-path SLO observability (internals/qtrace.py): QPS,
            # digest-backed per-stage p50/p95/p99/p999, SLO burn state,
            # slow-query exemplars
            "queries": qtrace_status(),
            # serving tier (internals/serving.py): micro-batch occupancy
            # p50/p99, result-cache hit rate, admission sheds + tenant
            # limiter states, device-time partitioner verdict
            "serving": serving_status(),
            # cost ledger (internals/costledger.py): per-(workload,
            # route, tenant) device-seconds/FLOPs/bytes, workload device
            # shares, conservation cross-check, cache savings — the view
            # `pathway-tpu top` renders
            "cost": cost_status(),
            # findings from pw.run(analysis=...): deployed graphs report
            # their own lint state (None when analysis was off)
            "analysis": getattr(e0, "analysis", None),
            # fusion contract: planned chains vs built fused nodes with
            # per-chain op counts (None when fusion was disabled)
            "fusion": fusion_status(e0),
            # consistency sanitizer (internals/sanitizer.py): invariant
            # check/violation counters, recent violations, certified UDFs
            "sanitizer": sanitizer_status(),
            # record-level lineage (internals/provenance.py): edges
            # stored, bytes, truncations, sampled fraction
            "provenance": provenance_status(),
        }

    def _merged_freshness(self) -> list:
        """Per-sink freshness p50/p99 merged across workers: bucket
        counts add (shared log2 boundaries) and the companion t-digests
        merge centroid-wise, so the merged percentiles are digest-exact
        rather than bucket midpoints."""
        from pathway_tpu_torch.internals.metrics import Histogram

        merged: Dict[str, Any] = {}
        for e in self._engines():
            m = getattr(e, "metrics", None)
            if m is None:
                continue
            for values, child in m.sink_freshness._children.items():
                sink = values[0] if values else ""
                h = merged.get(sink)
                if h is None:
                    h = merged[sink] = Histogram()
                h.merge(child)
        out = []
        for sink in sorted(merged):
            h = merged[sink]
            count = h.count
            if not count:
                continue
            p50 = h.percentile(50)
            p99 = h.percentile(99)
            out.append(
                {
                    "sink": sink,
                    "count": count,
                    "p50_ms": round(p50 * 1000, 4) if p50 is not None else None,
                    "p99_ms": round(p99 * 1000, 4) if p99 is not None else None,
                }
            )
        return out

    def _restart_request(self, path: str) -> tuple:
        """Handle ``/restart[?workers=0,1]``: queue a rolling restart of
        the process's workers through the health controller.  Returns
        (http_code, json_payload); 409 when a roll is already running,
        400 when the controller is disabled."""
        import urllib.parse

        from pathway_tpu_torch.internals import health

        if not health.ENABLED:
            return 400, {"error": "health controller disabled (PATHWAY_HEALTH=0)"}
        query = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        raw = query.get("workers", [None])[0]
        if raw:
            try:
                workers = [int(w) for w in raw.split(",") if w.strip()]
            except ValueError:
                return 400, {"error": "workers must be a comma list of ints"}
        else:
            workers = [e.worker_id for e in self._engines()]
        try:
            status = health.controller().request_rolling_restart(workers)
        except RuntimeError as exc:
            return 409, {
                "error": str(exc),
                "rolling_restart": health.controller().rolling_restart_status(),
            }
        return 200, {"requested": workers, "rolling_restart": status}

    def _profile_request(self, path: str) -> tuple:
        """Handle ``/profile?seconds=N[&dir=PATH]``: run one guarded
        jax.profiler capture and return (http_code, json_payload).  A
        concurrent second request is rejected with 409 — captures are
        one at a time, process-wide."""
        import urllib.parse

        from pathway_tpu_torch.internals import profiler

        query = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except ValueError:
            return 400, {"error": "seconds must be a number"}
        if seconds <= 0:
            return 400, {"error": "seconds must be positive"}
        out_dir = query.get("dir", [None])[0]
        try:
            result = profiler.capture(seconds, out_dir)
        except profiler.CaptureBusy as exc:
            return 409, {"error": str(exc), "active": profiler.profiler_status()["active"]}
        code = 200 if "error" not in result else 500
        return code, result

    def start(self) -> None:
        # arm the periodic device-health probe alongside the endpoint
        # (no-op when PATHWAY_DEVICE_PROBE=0; one monitor per process)
        from pathway_tpu_torch.internals.device_probe import ensure_monitor

        ensure_monitor()
        monitor = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                code = 200
                if self.path in ("/metrics", "/"):
                    body = monitor.metrics_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/status":
                    body = json.dumps(
                        monitor.status_json(), default=str
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/restart"):
                    # drain-and-respawn the workers one at a time
                    # (internals/health.py rolling restart); idempotency:
                    # a second request while a roll runs returns 409
                    code, payload = monitor._restart_request(self.path)
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif self.path.startswith("/profile"):
                    # on-demand jax.profiler capture (one at a time,
                    # process-wide; internals/profiler.py) — blocks this
                    # request thread for the capture window, the
                    # ThreadingHTTPServer keeps /metrics answering
                    code, payload = monitor._profile_request(self.path)
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif self.path.startswith("/qtrace"):
                    # Chrome/Perfetto trace_event JSON of recent query
                    # span trees (internals/qtrace.py) — save and open
                    # at ui.perfetto.dev
                    from pathway_tpu_torch.internals import qtrace

                    if qtrace.ENABLED:
                        payload = qtrace.tracker().chrome_trace()
                    else:
                        payload, code = {"error": "qtrace disabled"}, 404
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif self.path.startswith("/explain"):
                    # backward lineage tree for one output key
                    # (internals/provenance.py): /explain?key=<hex|^ptr>
                    from urllib.parse import parse_qs, urlparse

                    from pathway_tpu_torch.internals import provenance

                    qs = parse_qs(urlparse(self.path).query)
                    key = (qs.get("key") or [""])[0]
                    if not provenance.ACTIVE:
                        payload, code = (
                            {"error": "provenance disabled "
                                      "(set PATHWAY_PROVENANCE=1)"},
                            404,
                        )
                    elif not key:
                        payload, code = (
                            {"error": "missing key= query parameter"}, 400
                        )
                    else:
                        payload = provenance.tracker().explain(key)
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler
        )
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        ).start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
