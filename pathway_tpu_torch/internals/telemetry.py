"""Optional OpenTelemetry traces/metrics (reference: src/engine/telemetry.rs
OTel tracer+meter over OTLP/gRPC :45-58; python graph_runner/telemetry.py
spans `graph_runner.run`/`graph_runner.build`).

OTel is an optional dependency: without it (or without an endpoint
configured) every call is a no-op, so the engine never grows a hard
telemetry dependency. Configure with `pw.set_monitoring_config(
server_endpoint=...)` or the PATHWAY_MONITORING_SERVER env var."""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

_config: dict = {"endpoint": os.environ.get("PATHWAY_MONITORING_SERVER")}
_tracer = None


def set_monitoring_config(
    *, server_endpoint: str | None = None, **kwargs
) -> None:
    """reference: pw.set_monitoring_config / TelemetryConfig."""
    global _tracer
    _config["endpoint"] = server_endpoint
    _tracer = None  # rebuild lazily against the new endpoint
    _meter_state["meter"] = None  # metrics too (a cached noop would stick)
    # the old MeterProvider owns a PeriodicExportingMetricReader with a
    # live export thread — shut it down like the tracer provider, or each
    # reconfigure leaks a reader thread exporting to the stale endpoint
    old_provider = _meter_state.pop("provider", None)
    if old_provider is not None:
        with contextlib.suppress(Exception):
            old_provider.shutdown()


def _get_tracer():
    global _tracer
    if _tracer is not None:
        return _tracer
    endpoint = _config.get("endpoint")
    if not endpoint:
        _tracer = _NoopTracer()
        return _tracer
    try:
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        # module-owned provider: re-configuring swaps it cleanly (OTel's
        # global set_tracer_provider ignores every call after the first,
        # which would make endpoint changes silent no-ops)
        old = _config.pop("_provider", None)
        if old is not None:
            with contextlib.suppress(Exception):
                old.shutdown()
        provider = TracerProvider()
        provider.add_span_processor(
            BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
        )
        _config["_provider"] = provider
        _tracer = provider.get_tracer("pathway_tpu_torch")
    except Exception:  # noqa: BLE001 — OTel not installed / endpoint down
        _tracer = _NoopTracer()
    return _tracer


class _NoopSpan:
    def set_attribute(self, *a, **k):
        pass

    def record_exception(self, *a, **k):
        pass


class _NoopTracer:
    @contextlib.contextmanager
    def start_as_current_span(self, name: str, **kwargs):
        yield _NoopSpan()


@contextlib.contextmanager
def span(name: str, **attributes: Any):
    """`with telemetry.span("graph_runner.run", workers=4): ...`"""
    tracer = _get_tracer()
    with tracer.start_as_current_span(name) as s:
        for key, value in attributes.items():
            with contextlib.suppress(Exception):
                s.set_attribute(key, value)
        yield s


def export_engine_trace(engine) -> int:
    """Replay the engine's TraceStore spans as OTel spans (one per tick,
    node span, watermark phase).  The OTel export reads the SAME span
    store `engine.dump_trace()` serialises — a single instrumentation
    path feeds both the Chrome trace and the OTLP backend.

    No-op (returns 0) without a configured endpoint / OTel SDK, or when
    tracing was off.  Exceptions never propagate: telemetry must not be
    able to fail a run at shutdown."""
    tracer = _get_tracer()
    if isinstance(tracer, _NoopTracer):
        return 0
    m = getattr(engine, "metrics", None)
    tr = getattr(m, "trace", None) if m is not None else None
    if tr is None:
        return 0
    exported = 0
    try:
        for ev in tr.export_events():
            try:
                kind = ev[0]
                if kind == "tick":
                    _kind, worker, epoch, start, dur = ev
                    name = f"engine.tick[{epoch}]"
                    attrs = {"worker": worker, "epoch": epoch}
                elif kind == "span":
                    _kind, worker, epoch, node, name, start, dur, rows = ev
                    attrs = {
                        "worker": worker,
                        "epoch": epoch,
                        "node": node,
                        "rows": rows,
                    }
                elif kind == "wm":
                    _kind, worker, epoch, start, dur = ev
                    name = f"engine.watermark[{epoch}]"
                    attrs = {"worker": worker, "epoch": epoch}
                else:  # "edge" — point events, not spans; skip
                    continue
                span_obj = tracer.start_span(
                    name,
                    start_time=int(start * 1e9),
                    attributes=attrs,
                )
                span_obj.end(end_time=int((start + dur) * 1e9))
                exported += 1
            except Exception:  # noqa: BLE001 — skip malformed event
                continue
    except Exception:  # noqa: BLE001 — never fail the run for telemetry
        return exported
    return exported


# ---------------------------------------------------------------------------
# Metrics (reference: src/engine/telemetry.rs:49-58 — process memory/cpu,
# input/output latency gauges over a periodic OTLP reader)
# ---------------------------------------------------------------------------

_meter_state: dict = {"meter": None, "engines": []}


def register_engine(engine) -> None:
    """Attach an engine's counters to the OTel gauges (no-op without an
    endpoint or the OTel SDK).  Engines are held by weakref so repeated
    runs in one process don't pin dead dataflow state, and gauge
    callbacks only observe still-live engines."""
    import weakref

    refs = _meter_state["engines"]
    refs[:] = [r for r in refs if r() is not None]
    refs.append(weakref.ref(engine))
    _ensure_meter()


def _live_engines():
    for r in _meter_state["engines"]:
        eng = r()
        if eng is not None:
            yield eng


def _ensure_meter():
    if _meter_state["meter"] is not None:
        return
    endpoint = _config.get("endpoint")
    if not endpoint:
        _meter_state["meter"] = "noop"
        return
    try:
        from opentelemetry.exporter.otlp.proto.grpc.metric_exporter import (
            OTLPMetricExporter,
        )
        from opentelemetry.sdk.metrics import MeterProvider
        from opentelemetry.sdk.metrics.export import (
            PeriodicExportingMetricReader,
        )

        reader = PeriodicExportingMetricReader(
            OTLPMetricExporter(endpoint=endpoint),
            export_interval_millis=60_000,
        )
        provider = MeterProvider(metric_readers=[reader])
        meter = provider.get_meter("pathway_tpu_torch")

        def _mem(_options):
            import resource

            from opentelemetry.metrics import Observation

            usage = resource.getrusage(resource.RUSAGE_SELF)
            yield Observation(usage.ru_maxrss * 1024)

        def _cpu_user(_options):
            from opentelemetry.metrics import Observation

            yield Observation(os.times().user)

        def _cpu_sys(_options):
            from opentelemetry.metrics import Observation

            yield Observation(os.times().system)

        def _rows(_options):
            from opentelemetry.metrics import Observation

            for eng in _live_engines():
                yield Observation(
                    eng.stats_rows, {"worker": eng.worker_id}
                )

        def _latency(_options):
            from opentelemetry.metrics import Observation

            for eng in _live_engines():
                lat = getattr(eng, "last_batch_latency_ms", None)
                if lat is not None:
                    yield Observation(lat, {"worker": eng.worker_id})

        # gauges fed from the always-on metrics registry: the OTel export
        # observes the same histograms/gauges Prometheus serves, not a
        # second instrumentation path
        def _tick_pct(q):
            def cb(_options):
                from opentelemetry.metrics import Observation

                for eng in _live_engines():
                    m = getattr(eng, "metrics", None)
                    if m is None:
                        continue
                    v = m.tick_hist.percentile(q)
                    if v is not None:
                        yield Observation(
                            v * 1000.0, {"worker": eng.worker_id}
                        )

            return cb

        def _watermark(_options):
            from opentelemetry.metrics import Observation

            for eng in _live_engines():
                m = getattr(eng, "metrics", None)
                if m is not None:
                    yield Observation(
                        m._watermark_lag(), {"worker": eng.worker_id}
                    )

        def _backlog(_options):
            from opentelemetry.metrics import Observation

            for eng in _live_engines():
                yield Observation(
                    len(eng._scheduled_times), {"worker": eng.worker_id}
                )

        meter.create_observable_gauge(
            "process.memory.usage", callbacks=[_mem], unit="By"
        )
        meter.create_observable_gauge(
            "process.cpu.utime", callbacks=[_cpu_user], unit="s"
        )
        meter.create_observable_gauge(
            "process.cpu.stime", callbacks=[_cpu_sys], unit="s"
        )
        meter.create_observable_gauge(
            "engine.rows.processed", callbacks=[_rows]
        )
        meter.create_observable_gauge(
            "latency.input", callbacks=[_latency], unit="ms"
        )
        meter.create_observable_gauge(
            "engine.tick.p50", callbacks=[_tick_pct(50)], unit="ms"
        )
        meter.create_observable_gauge(
            "engine.tick.p99", callbacks=[_tick_pct(99)], unit="ms"
        )
        meter.create_observable_gauge(
            "engine.watermark.lag", callbacks=[_watermark], unit="s"
        )
        meter.create_observable_gauge(
            "engine.scheduled.backlog", callbacks=[_backlog]
        )
        _meter_state["meter"] = meter
        _meter_state["provider"] = provider
    except Exception:  # noqa: BLE001 — OTel not installed / endpoint down
        _meter_state["meter"] = "noop"
