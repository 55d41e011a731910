"""Graph runner: builds engine nodes from lazy tables and drives the engine.

TPU-native rebuild of the reference graph runner (reference:
python/pathway/internals/graph_runner/__init__.py:38 GraphRunner,
api.run_with_new_graph). Tree-shaking is implicit: only tables reachable from
the requested outputs/sinks are built.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from pathway_tpu_torch.engine.engine import CaptureNode, Engine
from pathway_tpu_torch.internals.parse_graph import G


class RunContext:
    """Memoized table -> engine-node builder."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._nodes: Dict[int, Any] = {}
        self._keepalive: List[Any] = []  # tables must outlive id() keys
        self.join_nodes: Dict[int, Any] = {}
        # FusionPlan consumption (analysis/fusion.py): chain-tail table id
        # -> FusionChain, installed by _install_fusion before any sink
        # builds.  node() then builds the whole chain as ONE fused node.
        self.fusion_by_tail: Optional[Dict[int, Any]] = None

    def node(self, table):
        n = self._nodes.get(id(table))
        if n is None:
            chain = None
            if self.fusion_by_tail:
                chain = self.fusion_by_tail.get(id(table))
                if chain is not None and chain.skipped:
                    chain = None
            if chain is not None:
                from pathway_tpu_torch.internals.table import build_fused_chain

                n = build_fused_chain(self, chain)
            else:
                n = table._build(self)
            if getattr(n, "trace", None) is None:
                n.trace = getattr(table, "_trace", None)
            self._nodes[id(table)] = n
            self._keepalive.append(table)
        return n


def _install_fusion(ctx: RunContext, extra_tables=()) -> None:
    """Plan select/filter fusion over the current parse graph and hand
    the plan to both sides of the contract: the RunContext (which builds
    chain tails as fused nodes) and the engine (whose serialized copy is
    what verify_fusion/PWT599 and the /status `fusion` key audit).  With
    PATHWAY_DISABLE_FUSION set the plan is None and every op builds its
    classic node."""
    from pathway_tpu_torch.analysis.fusion import plan_for_build

    plan = plan_for_build(G, extra_tables=extra_tables)
    ctx.fusion_by_tail = plan.by_tail() if plan is not None else None
    ctx.engine.fusion_plan = plan.to_dict() if plan is not None else None
    ctx.engine.fused_chains = []


def _make_engine() -> Engine:
    """Engine wired to the process-wide coordinator when running as one of
    several worker processes (PATHWAY_PROCESSES > 1; reference:
    src/engine/dataflow/config.rs:88-120 Config::from_env)."""
    from pathway_tpu_torch.internals.config import pathway_config as cfg

    if cfg.processes > 1:
        from pathway_tpu_torch.engine.exchange import global_coordinator

        return Engine(coord=global_coordinator())
    return Engine()


def run_tables(
    *tables,
    record_stream: bool = False,
    engine: Engine | None = None,
) -> List[CaptureNode]:
    """Build and run the graph needed for `tables`; return their captures.

    Multi-worker: results are gathered onto worker 0 (workers>0 return
    empty captures) so `pw.debug.compute_and_print` shows the full table
    exactly once across the process group."""
    engine = engine or _make_engine()
    ctx = RunContext(engine)
    _install_fusion(ctx, extra_tables=tables)
    captures = []
    for t in tables:
        node = ctx.node(t)
        if engine.worker_count > 1:
            from pathway_tpu_torch.engine.exchange import exchange_to_worker

            node = exchange_to_worker(engine, node, 0)
        captures.append(
            CaptureNode(
                engine,
                node,
                record_stream=record_stream,
                multiset=getattr(t, "_event_stream", False),
            )
        )
    _attach_monitoring(engine)
    engine.run_static()
    return captures


_last_engine = None


def last_engine():
    """The engine of the most recent pw.run in this process (benchmarks
    and tests inspect coordinator/tick counters post-run)."""
    return _last_engine


def _apply_analysis(
    engine: Engine, mode, mesh=None, baseline=None, slo=None
) -> None:
    """Run the static analyzer over the registered sinks, verify its
    columnar predictions and the fusion plan against the freshly built
    nodes, and attach the result to the engine (the /status endpoint
    serves it).  "warn" logs findings, "strict" refuses to run on
    warning-or-worse.  A mesh spec turns analysis on (at least "warn")
    and makes its PWT4xx ERROR findings fail fast regardless of mode —
    that fail-fast is the whole point of pw.run(mesh=...)."""
    if mesh is not None and (mode is None or mode == "off"):
        mode = "warn"
    if mode is None or mode == "off":
        return
    if mode not in ("warn", "strict"):
        raise ValueError(
            f"analysis= must be 'strict', 'warn' or 'off', got {mode!r}"
        )
    import logging

    from pathway_tpu_torch.analysis import (
        AnalysisError,
        Severity,
        analyze,
        verify_against_plan,
        verify_capacity,
        verify_fusion,
        verify_purity,
    )

    result = analyze(G, workers=engine.worker_count, mesh=mesh, slo=slo)
    verify_against_plan(engine, result)
    verify_fusion(engine, result)
    verify_capacity(engine, result)
    verify_purity(engine, result)
    baseline_info = None
    if baseline:
        from pathway_tpu_torch.analysis.baseline import apply_baseline

        baseline_info = apply_baseline(result, baseline)
    engine.analysis = result.to_dict()
    if baseline_info is not None:
        engine.analysis["baseline"] = baseline_info
    if not result.findings:
        return
    if mesh is not None and any(
        f.code.startswith("PWT4") and f.severity >= Severity.ERROR
        for f in result.findings
    ):
        raise AnalysisError(result)
    if mode == "strict" and result.max_severity() >= Severity.WARNING:
        raise AnalysisError(result)
    logging.getLogger("pathway_tpu_torch").warning(
        "static analysis:\n%s", result.render_text()
    )


def run(
    *,
    debug: bool = False,
    monitoring_level=None,
    with_http_server: bool = False,
    persistence_config=None,
    autocommit_duration_ms: float | None = None,
    analysis=None,
    analysis_baseline=None,
    mesh=None,
    slo: float | None = None,
    **kwargs,
) -> None:
    """pw.run — execute every registered sink (reference:
    internals/run.py:11).

    `mesh` ("dp=4,tp=2", mapping or MeshSpec) declares the device mesh
    the run intends to shard over: the PWT4xx mesh-compatibility pass
    runs before execution and its ERROR findings abort the run.
    `analysis_baseline` names a findings snapshot (analysis/baseline.py)
    so strict mode only trips on NEW findings.
    `slo` declares a p99 latency target in milliseconds for the traced
    query path (internals/qtrace.py): burn-rate gauges, warn-once burn
    events and slow-query exemplars key off it.  Equivalent to setting
    PATHWAY_SLO_P99_MS."""
    global _last_engine
    from pathway_tpu_torch.internals import faults, health, telemetry
    from pathway_tpu_torch.internals.config import pathway_config as cfg

    if mesh is not None:
        from pathway_tpu_torch.analysis.mesh import MeshSpec

        mesh = MeshSpec.parse(mesh)

    from pathway_tpu_torch.internals import qtrace as _qtrace

    if _qtrace.ENABLED:
        if slo is not None:
            _qtrace.tracker().set_slo(slo)
        if cfg.processes > 1:
            # this process's first global worker id: non-zero processes
            # ship their query marks to worker 0 for span merge
            _qtrace.tracker().attach_worker(
                cfg.process_id * max(1, cfg.threads)
            )

    # Instantiate the cost ledger at dataflow start so a served job
    # always exports the pathway_cost_* families (internals/costledger.py)
    from pathway_tpu_torch.internals import costledger as _costledger

    _costledger.on_run_start()

    # Arm the chaos harness once per run, before any worker starts
    # (per-worker arming would race and reset fire-once budgets).
    faults.install_from_env()

    # Arm the consistency sanitizer before the graph builds: UDF apply
    # programs compile with the replay-hash wrapper only when the
    # sanitizer is already ACTIVE at compile time.
    from pathway_tpu_torch.internals import sanitizer as _sanitizer

    _sanitizer.install_from_env()

    # Arm the lineage tracker before the graph runs; non-zero processes
    # ship their edges to worker 0 over MSG_LINEAGE for explain stitch.
    from pathway_tpu_torch.internals import provenance as _provenance

    _provenance.install_from_env()
    if _provenance.ACTIVE and cfg.processes > 1:
        _provenance.tracker().attach_worker(
            cfg.process_id * max(1, cfg.threads)
        )

    # Reset the health controller's transient per-run state (drained
    # replicas, held backpressure) so one run's degradations never leak
    # into the next; action counters stay cumulative.
    if health.ENABLED:
        health.controller().on_run_start()

    # Build the mesh execution backend BEFORE the graph builds: index
    # impls adopt it at build time (stdlib/indexing).  With too few
    # devices the backend stays inactive and the mesh remains the pure
    # lint target it was pre-backend.  Deactivation is in the finally
    # below (and at the end of _run_threaded) so one run's mesh never
    # leaks into the next.
    if mesh is not None:
        from pathway_tpu_torch.internals import mesh_backend

        mesh_backend.activate(mesh)

    if cfg.threads > 1:
        try:
            return _run_threaded(
                cfg.threads,
                monitoring_level=monitoring_level,
                with_http_server=with_http_server,
                persistence_config=persistence_config,
                autocommit_duration_ms=autocommit_duration_ms,
                analysis=analysis,
                analysis_baseline=analysis_baseline,
                mesh=mesh,
                slo=slo,
                **kwargs,
            )
        finally:
            if health.ENABLED:
                health.controller().on_run_end()
            if mesh is not None:
                mesh_backend.deactivate()

    monitor = None
    http_server = None
    engine = None
    try:
        engine = _make_engine()
        _last_engine = engine
        telemetry.register_engine(engine)
        # static connector builds need it (object cache binding at build
        # time)
        engine._persistence_config = persistence_config
        engine.mesh = mesh.to_dict() if mesh is not None else None
        ctx = RunContext(engine)
        with telemetry.span("graph_runner.build"):
            _install_fusion(ctx)
            for sink in G.sinks:
                nodes = [ctx.node(t) for t in sink.tables]
                sink.attach(ctx, nodes)
        _apply_analysis(
            engine, analysis, mesh=mesh, baseline=analysis_baseline,
            slo=slo,
        )
        _attach_monitoring(engine)
        monitor = _maybe_start_dashboard(engine, monitoring_level)
        if with_http_server:
            from pathway_tpu_torch.internals.monitoring import PrometheusServer

            http_server = PrometheusServer(
                engine, process_id=engine.worker_id
            )
            http_server.start()
        from pathway_tpu_torch.persistence import get_persistence_engine_config

        with telemetry.span(
            "graph_runner.run",
            workers=engine.worker_count,
            streaming=bool(G.sources),
        ), get_persistence_engine_config(persistence_config):
            if G.sources:
                _run_streaming(
                    engine, ctx, persistence_config, autocommit_duration_ms
                )
            else:
                engine.run_static()
    finally:
        if monitor is not None:
            monitor.stop()
        if http_server is not None:
            http_server.stop()
        # replay sampled spans to OTel (no-op without an endpoint)
        if engine is not None:
            telemetry.export_engine_trace(engine)
        # release any backpressure the controller still holds — a run's
        # throttle must not leak into the next run in this process
        if health.ENABLED:
            health.controller().on_run_end()
        if mesh is not None:
            from pathway_tpu_torch.internals import mesh_backend

            mesh_backend.deactivate()


def _run_threaded(
    threads: int,
    *,
    monitoring_level=None,
    with_http_server: bool = False,
    persistence_config=None,
    autocommit_duration_ms: float | None = None,
    analysis=None,
    analysis_baseline=None,
    mesh=None,
    slo: float | None = None,
    **kwargs,
) -> None:
    """workers = threads x processes (reference:
    src/engine/dataflow/config.rs:89-97): every thread builds its own
    engine over the shared parse graph and runs the same SPMD script;
    intra-process exchange stays in memory, cross-process traffic rides
    the process TCP mesh (engine/exchange.py ThreadGroupCoordinator)."""
    global _last_engine
    import threading as threading_mod

    from pathway_tpu_torch.engine.exchange import (
        ThreadGroupCoordinator,
        global_coordinator,
    )
    from pathway_tpu_torch.internals.config import pathway_config as cfg
    from pathway_tpu_torch.internals.license import check_worker_count

    check_worker_count(cfg.worker_count)
    tcp = global_coordinator() if cfg.processes > 1 else None
    group = ThreadGroupCoordinator(
        threads, tcp=tcp, process_id=cfg.process_id
    )
    errors: list = []

    build_lock = threading_mod.Lock()

    def worker(thread_index: int) -> None:
        global _last_engine
        try:
            engine = Engine(coord=group.facade(thread_index))
            engine._persistence_config = persistence_config
            engine.mesh = mesh.to_dict() if mesh is not None else None
            if thread_index == 0:
                _last_engine = engine
                from pathway_tpu_torch.internals import telemetry as _tm

                _tm.register_engine(engine)
            # graph building mutates shared registries (G.sources) and
            # runs user build closures — serialize it; execution below is
            # the concurrent part
            with build_lock:
                ctx = RunContext(engine)
                # the planner is deterministic over the shared parse
                # graph, so every worker derives the identical chain set
                _install_fusion(ctx)
                for sink in G.sinks:
                    nodes = [ctx.node(t) for t in sink.tables]
                    sink.attach(ctx, nodes)
                # thread 0 analyzes under the build lock: the analyzer
                # reads the shared parse graph the other threads are
                # still building from, and strict mode must raise before
                # any worker starts executing
                if thread_index == 0:
                    _apply_analysis(
                        engine, analysis, mesh=mesh,
                        baseline=analysis_baseline, slo=slo,
                    )
            _attach_monitoring(engine)
            monitor = None
            http_server = None
            if thread_index == 0:
                monitor = _maybe_start_dashboard(engine, monitoring_level)
                if with_http_server:
                    from pathway_tpu_torch.internals.monitoring import (
                        PrometheusServer,
                    )

                    http_server = PrometheusServer(
                        engine, process_id=engine.worker_id
                    )
                    http_server.start()
            try:
                if G.sources:
                    _run_streaming(
                        engine, ctx, persistence_config,
                        autocommit_duration_ms,
                    )
                else:
                    engine.run_static()
            finally:
                if monitor is not None:
                    monitor.stop()
                if http_server is not None:
                    http_server.stop()
                if thread_index == 0:
                    from pathway_tpu_torch.internals import telemetry as _tm2

                    _tm2.export_engine_trace(engine)
        except BaseException as exc:  # noqa: BLE001 — propagate to caller
            if group.note_worker_failure(thread_index, exc):
                return  # absorbed: the supervisor loop respawns this slot
            errors.append(exc)
            group.abort()

    ts = {
        i: threading_mod.Thread(
            target=worker, args=(i,), name=f"pw-worker-{i}"
        )
        for i in range(threads)
    }
    for t in ts.values():
        t.start()
    _supervise_thread_group(group, ts, worker, threads)
    if errors:
        from pathway_tpu_torch.analysis import AnalysisError

        # strict-mode refusal on thread 0 races with the abort errors it
        # triggers on the other workers; surface the real cause
        for e in errors:
            if isinstance(e, AnalysisError):
                raise e
        raise errors[0]


def _supervise_thread_group(group, ts, worker, threads: int) -> None:
    """Join the worker threads, respawning dead ones mid-job when the
    group absorbed their failure (live failover: note_worker_failure
    aborted the barrier, survivors roll back and park in
    failover_rendezvous; we join the corpse, reset the group state and
    start a replacement thread on the same slot)."""
    import os
    import time as time_mod

    try:
        rejoin_timeout = float(os.environ.get("PATHWAY_REJOIN_TIMEOUT", "30"))
    except ValueError:
        rejoin_timeout = 30.0
    while True:
        if group._failover_pending and not group._aborted:
            failed = sorted(group._failed)
            survivors = set(range(threads)) - set(failed)
            deadline = time_mod.monotonic() + rejoin_timeout
            parked = True
            with group._cv:
                while (
                    not group._aborted
                    and not survivors <= group._parked
                ):
                    remaining = deadline - time_mod.monotonic()
                    if remaining <= 0:
                        parked = False
                        break
                    group._cv.wait(min(remaining, 0.1))
            if group._aborted:
                continue
            if not parked:
                # a survivor never reached the rendezvous (wedged in user
                # code, or its own rollback failed): give up on failover
                group.abort()
                continue
            for i in failed:
                ts[i].join(timeout=5.0)
            # releases the parked survivors (generation bump) and resets
            # barrier/votes/buffers for the new timeline
            group.complete_failover()
            import threading as threading_mod

            for i in failed:
                t = threading_mod.Thread(
                    target=worker, args=(i,), name=f"pw-worker-{i}"
                )
                ts[i] = t
                t.start()
            continue
        if all(not t.is_alive() for t in ts.values()):
            break
        time_mod.sleep(0.02)
    for t in ts.values():
        t.join()


def _maybe_start_dashboard(engine: Engine, monitoring_level):
    """Rich live console dashboard (reference: internals/monitoring.py
    StatsMonitor:186). AUTO shows it only on a tty; NONE never."""
    from pathway_tpu_torch.internals.monitoring import MonitoringLevel, StatsMonitor

    if isinstance(monitoring_level, str):
        monitoring_level = MonitoringLevel(monitoring_level.lower())
    if monitoring_level is None or monitoring_level == MonitoringLevel.NONE:
        return None
    if monitoring_level == MonitoringLevel.AUTO:
        import sys

        if not sys.stderr.isatty():
            return None
    try:
        monitor = StatsMonitor(engine)
        monitor.start_live()
        return monitor
    except Exception:  # noqa: BLE001 — rich absent / no console
        return None


def run_all(**kwargs) -> None:
    run(**kwargs)


def _attach_monitoring(engine: Engine) -> None:
    import logging

    logger = logging.getLogger("pathway_tpu_torch")

    def on_error(entry):
        if entry.trace is not None:
            logger.warning(
                "%s (operator %s, created at %s)",
                entry.message,
                entry.operator,
                entry.trace,
            )
        else:
            logger.warning("%s (operator %s)", entry.message, entry.operator)

    engine.on_error = on_error


def _run_streaming(
    engine: Engine,
    ctx: RunContext,
    persistence_config=None,
    autocommit_duration_ms: float | None = None,
) -> None:
    """Drive streaming sources: start connector threads, advance engine time
    as batches arrive (reference: Connector::run, src/connectors/mod.rs:523)."""
    from pathway_tpu_torch.io._connector_runtime import StreamingDriver

    driver = StreamingDriver(
        engine,
        ctx,
        persistence_config=persistence_config,
        autocommit_ms=(
            100.0 if autocommit_duration_ms is None else autocommit_duration_ms
        ),
    )
    driver.run(G.sources)
