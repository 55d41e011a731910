"""The dataflow engine: nodes, scheduler, worker loop.

TPU-native rebuild of the reference's Rust engine entry points (reference:
src/engine/dataflow.rs run_with_new_dataflow_graph:6448, worker loop
:6552-6620). Instead of timely dataflow over OS threads, this engine drives a
topologically-ordered node list through totally-ordered micro-batch times;
data-parallel scale-out shards batches by key (engine/value.py SHARD_BITS)
across host workers, and the numeric hot path (expressions over numeric
columns, KNN, embedding) is dispatched to XLA via the ops/ package.

Scheduling model:
  * every logical `time` (int) is processed to completion before the next —
    this is the batch-boundary consistency guarantee the reference gets from
    differential frontiers;
  * within a time, nodes run in topological (creation) order, each consuming
    the deltas its inputs emitted at this time and emitting its own;
  * operators may schedule future wakeups (temporal buffers, delayed
    retractions) via `Engine.schedule_time`.
"""

from __future__ import annotations

import gc
import os
import threading
import time as time_mod
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from pathway_tpu_torch.engine.stream import Delta, TableState, consolidate
from pathway_tpu_torch.engine.value import ERROR, Error, Pointer
from pathway_tpu_torch.internals import provenance as _provenance
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import sanitizer as _sanitizer


class EngineError(Exception):
    pass


class FailoverRequired(EngineError):
    """Raised out of a coordination wait (agree/collect) when a peer worker
    died mid-run and the group is rolling back to the last persisted
    frontier instead of failing the job.  The streaming driver catches it,
    rendezvouses with the surviving workers, restores operator state and
    resumes; a replacement worker re-runs the driver from scratch."""

    def __init__(self, message: str, *, dead: Iterable[int] = ()):
        super().__init__(message)
        self.dead = tuple(dead)


class ErrorLogEntry:
    __slots__ = ("message", "operator", "time", "trace")

    def __init__(
        self, message: str, operator: str = "", time: int = 0, trace=None
    ):
        self.message = message
        self.operator = operator
        self.time = time
        self.trace = trace  # user frame that created the operator

    def __repr__(self):
        base = f"ErrorLogEntry({self.message!r}, {self.operator!r}, t={self.time})"
        if self.trace is not None:
            base += f" [{self.trace}]"
        return base


class Node:
    """Base dataflow operator (reference: one timely operator)."""

    name: str = "node"
    # Execution-path observability: operators that participate in the
    # classic-vs-columnar selection set `path` to "classic" or "columnar"
    # and bump the counters in process(). For join/flatten/reduce the
    # choice is made at build time; the exchange node decides per batch
    # (its gate is a runtime flag), so its `path` reflects the last batch
    # routed. Augmented assignment on the int class attrs creates
    # per-instance counters lazily, so plain nodes pay nothing.
    path: Optional[str] = None
    rows_processed: int = 0
    batches_processed: int = 0

    def __init__(self, engine: "Engine", inputs: List["Node"]):
        self.engine = engine
        self.inputs = inputs
        self.downstream: List[Tuple["Node", int]] = []
        self.pending: Dict[int, List[Delta]] = {}
        self._pending_clean: Dict[int, bool] = {}
        self.trace: Any = None  # user frame info
        for port, inp in enumerate(inputs):
            inp.downstream.append((self, port))
        engine.register(self)

    # -- wiring -----------------------------------------------------------
    def receive(
        self, port: int, deltas: List[Delta], clean: bool = False
    ) -> None:
        cur = self.pending.get(port)
        if cur is None:
            self.pending[port] = list(deltas)
            self._pending_clean[port] = clean
        else:
            cur.extend(deltas)
            # merged chunks may interleave per-key updates
            self._pending_clean[port] = False

    def emit(self, time: int, deltas: Iterable[Delta]) -> None:
        out = consolidate(deltas)
        if not out:
            return
        self.engine.stats_rows += len(out)
        # receive() copies into its own pending list, so sharing `out`
        # across downstream nodes is safe
        for node, port in self.downstream:
            node.receive(port, out, clean=True)

    def emit_consolidated(self, time: int, deltas: List[Delta]) -> None:
        """emit() for batches the producer guarantees are already minimal
        (no duplicate (key, values) pairs; retractions precede insertions
        per key) — skips the consolidation pass."""
        if not deltas:
            return
        self.engine.stats_rows += len(deltas)
        for node, port in self.downstream:
            node.receive(port, deltas, clean=True)

    def take(self, port: int = 0) -> List[Delta]:
        self._pending_clean.pop(port, None)
        return self.pending.pop(port, [])

    def take_with_clean(self, port: int = 0) -> Tuple[List[Delta], bool]:
        """take() plus whether the batch is known already-consolidated."""
        clean = self._pending_clean.pop(port, False)
        return self.pending.pop(port, []), clean

    def has_pending(self) -> bool:
        return bool(self.pending)

    # -- lifecycle --------------------------------------------------------
    def process(self, time: int) -> None:
        """Consume pending inputs for `time`, emit outputs for `time`."""
        raise NotImplementedError

    def on_time_end(self, time: int) -> None:
        pass

    def on_flush(self) -> None:
        """End-of-stream flush hook: runs (and drains) BEFORE on_end, so
        buffered rows reach the sinks before their completion callbacks."""

    def on_end(self) -> None:
        pass

    def log_error(self, message: str) -> None:
        self.engine.log_error(message, operator=self.name, trace=self.trace)

    # -- operator snapshots (reference: dataflow/persist.rs MaybePersist,
    # persistence/operator_snapshot.rs:231) ------------------------------
    # Class lists the attrs that constitute its persistent operator state.
    # Nodes are snapshot at a quiescent frontier (all queues drained), so
    # wiring attrs (pending/downstream) are never part of state.
    snapshot_attrs: tuple = ()

    def snapshot_state(self) -> dict | None:
        if not self.snapshot_attrs:
            return None
        return {a: getattr(self, a) for a in self.snapshot_attrs}

    def restore_state(self, state: dict) -> None:
        for a, v in state.items():
            setattr(self, a, v)
        self._after_restore()

    def _after_restore(self) -> None:
        """Hook for nodes that must rebuild derived/device structures."""


class Engine:
    """One worker's dataflow instance + scheduler.

    With a multi-worker coordinator, every `process_time` call is preceded
    by a global agreement on the time so all workers step the same total
    order of micro-batches in lockstep (the consistency the reference gets
    from differential frontiers; reference: src/engine/dataflow/config.rs
    worker wiring)."""

    def __init__(
        self,
        *,
        worker_id: int = 0,
        worker_count: int = 1,
        coord=None,
        metrics: bool = True,
    ):
        if coord is None:
            from pathway_tpu_torch.engine.exchange import Coordinator

            coord = Coordinator()
            coord.worker_id = worker_id
            coord.worker_count = worker_count
        self.coord = coord
        self.nodes: List[Node] = []
        self.worker_id = coord.worker_id
        self.worker_count = coord.worker_count
        # log-once keys for this engine — per-engine (NOT process-global)
        # so multi-engine tests and re-runs each warn once (warn_once)
        self._warned_once: set[str] = set()
        # static-analysis result dict, attached by pw.run(analysis=...)
        # and served by the /status endpoint
        self.analysis: dict | None = None
        # fusion contract (analysis/fusion.py): the serialized FusionPlan
        # the build consumed, and the FusedChainNodes it actually built —
        # verify_fusion (PWT599) and /status's `fusion` key audit the two
        self.fusion_plan: dict | None = None
        self.fused_chains: List[Node] = []
        # declared device mesh from pw.run(mesh=...), for observability
        self.mesh: dict | None = None
        self.error_log: List[ErrorLogEntry] = []
        self.error_log_nodes: List["ErrorLogNode"] = []
        self._scheduled_times: set[int] = set()
        self._gc_ticks = 0
        self._gc_disabled = False
        # per-node wall-time dump destination (the always-on metrics
        # registry is the single instrumented path; this env var only
        # selects the JSON-lines dump of it at finish())
        self._node_timing_dest: str | None = os.environ.get(
            "PATHWAY_NODE_TIMING_LOG"
        )
        self._timing_dumped = False
        self.current_time: int = 0
        self.stats_rows = 0
        # transactional sinks (io/_writer.py OutputWriter protocol): the
        # streaming driver drives prepare/commit around operator snapshots
        self._txn_sinks: List[Any] = []
        # fault-tolerance counters, exported via EngineMetrics callbacks
        # (pathway_failover_total / pathway_sink_txn_commits_total); plain
        # ints so the driver can bump them with metrics disabled
        self.failover_count = 0
        self.sink_txn_commits = 0
        self.last_failover_recovery_s: float | None = None
        self.now_fn: Callable[[], int] | None = None  # engine-time provider
        self.terminate_flag = threading.Event()
        self.on_error: Callable[[ErrorLogEntry], None] | None = None
        self.last_diagnostics: dict | None = None
        # always-on observability (internals/metrics.py): per-node latency
        # histograms, tick timing, watermark lag, flight recorder.
        # `metrics=False` exists ONLY so the perf-smoke overhead guard can
        # measure the bare loop; production runs never disable it.
        if metrics:
            from pathway_tpu_torch.internals.metrics import EngineMetrics

            self.metrics: Any | None = EngineMetrics(self)
        else:
            self.metrics = None
        # thread-worker groups track their engines so one Prometheus /
        # status server can export every worker in the process
        group = getattr(coord, "group", None)
        if group is not None and hasattr(group, "engines"):
            group.engines.append(self)
        # dead-peer errors from the coordinator pull this worker's
        # flight-recorder tail into the message (what was I doing when
        # the peer died), instead of a bare "peer N dead"
        try:
            coord.on_dead_context = self._failure_context
        except AttributeError:
            pass

    def register(self, node: Node) -> None:
        idx = len(self.nodes)
        node._idx = idx
        node._rows_out = 0
        m = self.metrics
        node._lat_child = (
            m.node_hist.labels(str(idx), node.name, type(node).__name__)
            if m is not None
            else None
        )
        self.nodes.append(node)

    def register_txn_sink(self, writer) -> None:
        """Register a transactional sink for the snapshot-aligned
        exactly-once protocol: the driver calls writer.prepare(F) before
        each operator-snapshot manifest and writer.commit(F) after it."""
        self._txn_sinks.append(writer)

    def _failure_context(self) -> str:
        """Flight-recorder tail for dead-peer diagnostics: what this
        worker was doing right before the group noticed a peer die.
        Installed on the coordinator as ``on_dead_context``."""
        m = self.metrics
        if m is None:
            return ""
        return "; ".join(
            f"t={ev['time']} {ev['kind']} "
            f"node={ev['node']}({ev['name']}) {ev['duration_s']}s"
            for ev in m.recorder.tail(8)
        )

    def reset_for_rollback(self) -> None:
        """Failover rollback: drop every in-flight delta and scheduled
        wakeup so replay from the restored frontier is not double-counted.
        Node STATE is overwritten by apply_states right after; this clears
        only transient wiring.  The driver's own pending queues survive —
        they hold future (never-yet-pushed) data."""
        for node in self.nodes:
            node.pending.clear()
            node._pending_clean.clear()
            # sink-side buffers outside the node graph (attach_writer's
            # per-epoch RowEvent batch) register a hook: rows buffered by
            # an epoch the rollback abandoned must not leak into the new
            # timeline (their epoch numbers may even collide with it)
            hook = getattr(node, "on_rollback", None)
            if hook is not None:
                hook()
        self._scheduled_times.clear()
        self.current_time = 0
        if _sanitizer.ACTIVE:
            # the time rewind that follows is a sanctioned rollback, not
            # a frontier-monotonicity violation
            _sanitizer.tracker().on_rollback(self)

    def explain(self, key: Any, **kwargs: Any) -> Dict[str, Any]:
        """Backward lineage of an output row (internals/provenance.py):
        a JSON tree from `key` down to source-connector offsets with the
        key's emit/retract history.  `key` may be a Pointer, the raw
        128-bit int, or the canonical 32-hex string the surfaces print.
        Requires PATHWAY_PROVENANCE=1 (or provenance.install())."""
        if not _provenance.ACTIVE:
            return {
                "key": str(key),
                "found": False,
                "error": "provenance disabled (set PATHWAY_PROVENANCE=1)",
            }
        return _provenance.tracker().explain(key, **kwargs)

    def schedule_time(self, time: int) -> None:
        if time > self.current_time:
            self._scheduled_times.add(time)

    def next_scheduled_time(self) -> Optional[int]:
        future = [t for t in self._scheduled_times if t > self.current_time]
        return min(future) if future else None

    # -- multi-worker helpers ---------------------------------------------
    def owns_key(self, key) -> bool:
        return self.coord.owns(key.shard)

    def global_next_time(self) -> Optional[int]:
        """Agree on the earliest scheduled time across workers (None = no
        worker has one)."""
        local = self.next_scheduled_time()
        if self.coord.worker_count == 1:
            return local
        votes = [v for v in self.coord.agree(local) if v is not None]
        return min(votes) if votes else None

    def global_any(self, flag: bool) -> bool:
        if self.coord.worker_count == 1:
            return flag
        return any(self.coord.agree(bool(flag)))

    def warn_once(self, key: str, message: str, *args) -> bool:
        """Log `message` at WARNING the first time `key` is seen on THIS
        engine.  Per-engine, not process-global: every engine of a
        multi-worker run (and every re-run) gets its warning exactly
        once.  Returns True when the message was emitted."""
        if key in self._warned_once:
            return False
        self._warned_once.add(key)
        import logging

        logging.getLogger("pathway_tpu_torch").warning(message, *args)
        return True

    def log_error(self, message: str, operator: str = "", trace=None) -> None:
        # default attribution to the node being processed right now — this
        # catches expression/UDF errors logged through bare engine loggers
        # (reference: OperatorProperties carry the user frame, graph.rs:431)
        node = getattr(self, "current_node", None)
        if node is not None:
            if not operator:
                operator = node.name
            if trace is None:
                trace = node.trace
                if trace is None:
                    # synthetic/stdlib-built operators have no user frame;
                    # fall back to the node's graph position so the entry
                    # stays attributable instead of being anonymous
                    idx = getattr(node, "_idx", None)
                    if idx is not None and "#" not in operator:
                        operator = f"{operator}#{idx}"
        entry = ErrorLogEntry(message, operator, self.current_time, trace)
        self.error_log.append(entry)
        if self.metrics is not None:
            self.metrics.recorder.record(
                "error",
                time=self.current_time,
                node=getattr(node, "_idx", -1),
                name=f"{operator}: {message[:160]}" if operator else message[:160],
                errors=1,
            )
        for n in self.error_log_nodes:
            n.push(entry)
        if self.on_error is not None:
            self.on_error(entry)

    # -- driving ----------------------------------------------------------
    def process_time(self, time: int) -> None:
        if _sanitizer.ACTIVE:
            _sanitizer.tracker().on_tick(self, time)
        self.current_time = time
        self._scheduled_times.discard(time)
        m = self.metrics
        if m is not None:
            sw = m.slow_watch
            if sw is not None:
                sw.begin(time)
            tr = m.trace
            if tr is not None and tr.should_sample(time):
                # sampled epoch: the traced loop variant also captures
                # per-node spans, and watermark advancement gets a span
                # of its own before the epoch record closes
                self._process_time_traced(time, m, tr)
                perf = time_mod.perf_counter
                wm0 = perf()
                for node in self.nodes:
                    node.on_time_end(time)
                tr.end_epoch(wm0, perf())
            else:
                self._process_time_metrics(time, m)
                for node in self.nodes:
                    node.on_time_end(time)
            if sw is not None:
                sw.end()
        else:
            try:
                for node in self.nodes:
                    self.current_node = node
                    node.process(time)
            finally:
                self.current_node = None
            for node in self.nodes:
                node.on_time_end(time)
        if _qtrace.ENABLED and self.worker_count > 1:
            # query spans: non-zero workers ship their marks to worker 0,
            # worker 0 absorbs whatever arrived (MSG_STAMP side-channel)
            _qtrace.tracker().on_tick(self)
        if _provenance.ACTIVE:
            # lineage edges: epoch accounting + memtrack refresh, and in
            # multi-process runs the MSG_LINEAGE ship/absorb toward the
            # worker-0 gather (internals/provenance.py)
            _provenance.tracker().on_tick(self)
        self._gc_pulse()

    def _process_time_metrics(self, time: int, m) -> None:
        """The always-on instrumented worker loop: per-node latency into
        the log2 histograms, per-tick wall time, and flight-recorder
        events for nodes that did work.  One perf_counter call per node —
        a node's interval ends where the next one starts, so bookkeeping
        (~0.3us) rides on the successor's bucket rather than doubling the
        timer cost."""
        perf = time_mod.perf_counter
        rec = m.recorder
        rec_append = rec.events.append
        err_log = self.error_log
        errs_seen = len(err_log)
        errs_tick = 0
        rows_tick0 = self.stats_rows
        t0 = perf()
        t_prev = t0
        try:
            for node in self.nodes:
                self.current_node = node
                rows0 = self.stats_rows
                node.process(time)
                t_now = perf()
                dt = t_now - t_prev
                t_prev = t_now
                node._lat_child.observe(dt)
                rows = self.stats_rows - rows0
                n_err = len(err_log) - errs_seen
                if rows:
                    node._rows_out += rows
                if n_err:
                    errs_seen += n_err
                    errs_tick += n_err
                if rows or n_err or dt > 1e-4:
                    rec.seq = seq = rec.seq + 1
                    rec_append(
                        (t_now, time, "node", node._idx, node.name,
                         dt, rows, n_err, seq)
                    )
        finally:
            self.current_node = None
        t_end = perf()
        m.tick_hist.observe(t_end - t0)
        m.ticks += 1
        m.last_tick_monotonic = time_mod.monotonic()
        rec.seq = seq = rec.seq + 1
        rec_append(
            (t_end, time, "tick", -1, "", t_end - t0,
             self.stats_rows - rows_tick0, errs_tick, seq)
        )

    def _process_time_traced(self, time: int, m, tr) -> None:
        """The sampled-epoch loop variant: identical to
        ``_process_time_metrics`` plus one tuple append per active node
        into the epoch's span list (internals/tracing.py TraceStore).
        Duplicated rather than flag-checked so the unsampled path keeps
        its instruction count."""
        perf = time_mod.perf_counter
        rec = m.recorder
        rec_append = rec.events.append
        err_log = self.error_log
        errs_seen = len(err_log)
        errs_tick = 0
        rows_tick0 = self.stats_rows
        t0 = perf()
        ep = tr.begin_epoch(time, t0)
        spans_append = ep.spans.append
        t_prev = t0
        try:
            for node in self.nodes:
                self.current_node = node
                rows0 = self.stats_rows
                node.process(time)
                t_now = perf()
                dt = t_now - t_prev
                node._lat_child.observe(dt)
                rows = self.stats_rows - rows0
                n_err = len(err_log) - errs_seen
                if rows:
                    node._rows_out += rows
                if n_err:
                    errs_seen += n_err
                    errs_tick += n_err
                if rows or n_err or dt > 1e-5:
                    spans_append((node._idx, node.name, t_prev, dt, rows))
                if rows or n_err or dt > 1e-4:
                    rec.seq = seq = rec.seq + 1
                    rec_append(
                        (t_now, time, "node", node._idx, node.name,
                         dt, rows, n_err, seq)
                    )
                t_prev = t_now
        finally:
            self.current_node = None
        t_end = perf()
        # device-pipeline attribution: host-prep / dispatch / wait spans
        # accrue in the host-span ring on pipeline threads between ticks
        ep.spans.extend(tr.pipeline_spans(t_end))
        ep.t1 = t_end
        m.tick_hist.observe(t_end - t0)
        m.ticks += 1
        m.last_tick_monotonic = time_mod.monotonic()
        rec.seq = seq = rec.seq + 1
        rec_append(
            (t_end, time, "tick", -1, "", t_end - t0,
             self.stats_rows - rows_tick0, errs_tick, seq)
        )

    def dump_diagnostics(self, *, reason: str = "manual") -> dict:
        """Structured post-mortem: topology + per-node p50/p99 + flight
        recorder tail + recent errors (see internals/metrics.py).  Called
        automatically when a run fails or logged errors; callable any
        time."""
        from pathway_tpu_torch.internals.metrics import dump_diagnostics

        return dump_diagnostics(self, reason=reason)

    def dump_trace(self, path: str | None = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON for every sampled epoch,
        merged across ALL workers: thread siblings are read directly,
        remote processes contribute via one coordinator ``agree`` round —
        which makes this an SPMD collective in multiprocess runs (every
        process must call it at the same point, exactly once).  Writes to
        ``path`` when given; always returns the trace dict."""
        from pathway_tpu_torch.internals.tracing import (
            build_chrome_trace,
            gather_trace_events,
            validate_chrome_trace,
        )

        events = gather_trace_events(self)
        trace = build_chrome_trace(events)
        if _qtrace.ENABLED:
            # per-query span trees ride along under their own "queries"
            # process row (internals/qtrace.py)
            trace["traceEvents"].extend(
                _qtrace.tracker().chrome_trace()["traceEvents"]
            )
        validate_chrome_trace(trace)
        if path is not None:
            import json as json_mod

            with open(path, "w") as fh:
                json_mod.dump(trace, fh)
        return trace

    def _dump_node_timing(self) -> None:
        """PATHWAY_NODE_TIMING_LOG dump (the reference's
        DIFFERENTIAL_LOG_ADDR analogue, dataflow.rs:6489-6496) — one JSON
        line per node that processed at least once, derived from the SAME
        always-on registry the Prometheus endpoint exports (there is no
        separate instrumented code path)."""
        if (
            self._node_timing_dest is None
            or self._timing_dumped
            or self.metrics is None
        ):
            return
        import json as json_mod
        import sys

        lines = []
        for idx, node in enumerate(self.nodes):
            child = getattr(node, "_lat_child", None)
            if child is None:
                continue
            calls = child.count
            if not calls:
                continue
            lines.append(
                json_mod.dumps(
                    {
                        "node": idx,
                        "name": node.name,
                        "type": type(node).__name__,
                        "calls": calls,
                        "total_s": round(child.sum, 6),
                        "rows_out": node._rows_out,
                        "worker": self.worker_id,
                    }
                )
            )
        if not lines:
            return
        # idempotent: finish() may run more than once per engine
        self._timing_dumped = True
        dest = self._node_timing_dest
        if dest in ("stderr", "-", ""):
            for line in lines:
                print(line, file=sys.stderr)
        else:
            with open(dest, "a") as fh:
                fh.write("\n".join(lines) + "\n")

    def _gc_pulse(self) -> None:
        """Keep cyclic-GC pauses off the hot loop.  Engine state (delta
        tuples, Pointers, group dicts) is acyclic but gc-tracked, so at
        millions of rows every gen-2 collection stalls a tick for seconds
        scanning live state.  Every 16 ticks: collect the young gens
        (recent cyclic garbage, cheap), then freeze survivors into the
        permanent generation so automatic collections stop rescanning
        them.  Every 1024 ticks a full unfreeze+collect reclaims any
        frozen cycles (e.g. abandoned UDF closures).  `finish()` always
        unfreezes, so repeated runs in one process don't pin garbage."""
        self._gc_ticks += 1
        if self._gc_ticks % 1024 == 0:
            gc.unfreeze()
            gc.collect()
            gc.freeze()
        elif self._gc_ticks % 16 == 0:
            gc.collect(1)
            gc.freeze()

    def run_static(self) -> None:
        """Batch mode: all inputs at time 0, then drain scheduled times
        (temporal buffers flush at +inf on end)."""
        try:
            self._gc_quiesce()
            self.process_time(0)
            while True:
                t = self.global_next_time()
                if t is None:
                    break
                self.process_time(t)
            self.finish()
        except BaseException:
            # crash-dump flight recorder: an uncaught run failure leaves a
            # structured post-mortem behind (engine.last_diagnostics and,
            # with PATHWAY_DIAGNOSTICS_DIR, a JSON file)
            if self.metrics is not None:
                try:
                    self.dump_diagnostics(reason="run_failure")
                except Exception:  # noqa: BLE001 — never mask the real error
                    pass
            raise
        finally:
            # finish() unfreezes on the success path; this covers
            # exceptions mid-run so the process's GC is never left frozen
            self._gc_unfreeze()
            self._gc_restore()

    def _gc_quiesce(self) -> None:
        """Suspend automatic cyclic GC for the run.  The batch kernels
        allocate in bursts (one tuple/Pointer per output row), and each
        burst otherwise trips threshold-triggered collections that rescan
        live engine state mid-tick — measured at >3x the actual kernel
        cost on join-heavy graphs.  `_gc_pulse` keeps collecting on its
        own explicit cadence, so garbage is still reclaimed; `finish()`
        re-enables iff we were the ones to disable."""
        if gc.isenabled():
            self._gc_disabled = True
            gc.disable()

    def _gc_restore(self) -> None:
        if self._gc_disabled:
            self._gc_disabled = False
            gc.enable()

    def _gc_unfreeze(self) -> None:
        if self._gc_ticks >= 16:
            self._gc_ticks = 0
            gc.unfreeze()

    def _drain(self) -> None:
        # A delta can traverse at most the full node chain per pass, so a
        # DAG settles within ~len(nodes) passes; the generous cap exists
        # only to turn a buggy cyclic graph into a loud error instead of a
        # hang — never to silently stop while data is still pending.
        # Multi-worker: continue while ANY worker has pending data, so
        # everyone keeps stepping times in lockstep.
        limit = 10 * len(self.nodes) + 100
        for _ in range(limit):
            if not self.global_any(any(n.has_pending() for n in self.nodes)):
                return
            self.process_time(self.current_time + 1)
        if any(n.has_pending() for n in self.nodes):
            stuck = [n.name for n in self.nodes if n.has_pending()]
            raise EngineError(
                f"dataflow failed to settle after {limit} drain passes; "
                f"nodes still pending: {stuck[:10]}"
            )

    def finish(self) -> None:
        try:
            for node in self.nodes:
                node.on_flush()
            self._drain()
            for node in self.nodes:
                node.on_end()
            self._drain()
        finally:
            self._gc_unfreeze()
            self._dump_node_timing()
            m = self.metrics
            if m is not None and m.slow_watch is not None:
                m.slow_watch.stop()
            if self.error_log and self.metrics is not None:
                try:
                    self.dump_diagnostics(reason="error_log")
                except Exception:  # noqa: BLE001 — diagnostics must not fail
                    pass


# ---------------------------------------------------------------------------
# Core nodes
# ---------------------------------------------------------------------------


class StaticSource(Node):
    """All rows present at time 0 (reference: static_table, engine.pyi).

    Accepts either a key->values dict or a prebuilt consolidated delta
    list (bulk connectors hand the latter straight from their ingest log,
    skipping a million-row dict round trip)."""

    name = "static"
    snapshot_attrs = ('_emitted',)

    def __init__(
        self,
        engine: Engine,
        rows: Dict[Pointer, tuple],
        *,
        deltas: Optional[List[Delta]] = None,
    ):
        super().__init__(engine, [])
        self.rows = rows
        self.deltas = deltas
        self._emitted = False

    def process(self, time: int) -> None:
        if not self._emitted and time >= 0:
            self._emitted = True
            # keys are unique by construction: the consolidation pass
            # (a full key-set build) would be pure overhead here
            if self.deltas is not None:
                deltas = self.deltas
            else:
                deltas = [(k, v, 1) for k, v in self.rows.items()]
            if self.engine.coord.worker_count > 1:
                owns = self.engine.owns_key
                deltas = [d for d in deltas if owns(d[0])]
            if _provenance.ACTIVE:
                _provenance.tracker().record_source(self, time, deltas)
            self.emit_consolidated(time, deltas)


class TimedSource(Node):
    """Rows arriving at explicit times (pw.debug streaming tables with
    __time__/__diff__ columns; StreamGenerator)."""

    name = "timed_source"
    snapshot_attrs = ('_by_time',)

    def __init__(self, engine: Engine, events: List[Tuple[int, Delta]]):
        super().__init__(engine, [])
        self._by_time: Dict[int, List[Delta]] = {}
        by_time = self._by_time
        try:
            # bulk shape: contiguous runs per time slice at C speed instead
            # of a per-event setdefault/append
            import numpy as _np

            times = _np.asarray([e[0] for e in events], dtype=_np.int64)
            if len(times):
                bounds = (_np.nonzero(_np.diff(times))[0] + 1).tolist()
                starts = [0] + bounds
                ends = bounds + [len(times)]
                for s, e in zip(starts, ends):
                    t = int(times[s])
                    chunk = [ev[1] for ev in events[s:e]]
                    prev = by_time.get(t)
                    if prev is None:
                        by_time[t] = chunk
                    else:
                        prev.extend(chunk)
        except (TypeError, ValueError, OverflowError):
            by_time.clear()
            for time, delta in events:
                by_time.setdefault(time, []).append(delta)
        for time in by_time:
            engine.schedule_time(time)

    def process(self, time: int) -> None:
        deltas = self._by_time.pop(time, None)
        if deltas:
            if self.engine.coord.worker_count > 1:
                # multi-worker: each worker emits only its shard of the
                # (identical) event script
                owns = self.engine.owns_key
                deltas = [d for d in deltas if owns(d[0])]
            if _provenance.ACTIVE:
                _provenance.tracker().record_source(self, time, deltas)
            self.emit(time, deltas)


class InputQueueSource(Node):
    """Streaming source fed externally (connectors push batches tagged with
    times; the runner routes them here).

    Multi-worker: `shard_filter=True` means a replicated reader (every
    worker parses the same input, keeps its key shard). Exclusive readers
    (REST servers, stateful custom subjects running on worker 0 only) set
    it False and get a scatter ExchangeNode appended instead."""

    name = "input"
    snapshot_attrs = ('_by_time',)

    def __init__(self, engine: Engine, *, shard_filter: bool = True):
        super().__init__(engine, [])
        self._by_time: Dict[int, List[Delta]] = {}
        self.shard_filter = shard_filter

    def push(self, time: int, deltas: List[Delta]) -> None:
        self._by_time.setdefault(time, []).extend(deltas)
        self.engine.schedule_time(time)

    def process(self, time: int) -> None:
        deltas = self._by_time.pop(time, None)
        if deltas:
            if self.shard_filter and self.engine.worker_count > 1:
                owns = self.engine.owns_key
                deltas = [d for d in deltas if owns(d[0])]
            if _provenance.ACTIVE:
                _provenance.tracker().record_source(self, time, deltas)
            self.emit(time, deltas)


class RowwiseNode(Node):
    """Evaluate column batch programs over (possibly several same-universe)
    inputs.

    Reference: expression_table (src/engine/dataflow.rs) + batched expression
    interpreter (src/engine/expression.rs:609). With one input it is a pure
    streaming map over the delta batch; with several it zips inputs by key,
    maintaining per-input state (the reference does this via column paths into
    one storage tuple). `batch_fn(keys, rows_per_input)` returns the output
    row tuples, so whole columns can be lowered to numpy/XLA at once.
    """

    name = "rowwise"

    def __init__(
        self,
        engine: Engine,
        inputs: List[Node],
        batch_fn: Callable[[List[Pointer], Tuple[List[tuple], ...]], List[tuple]],
        *,
        deterministic: bool = True,
        projection: tuple | None = None,
    ):
        super().__init__(engine, inputs)
        self.batch_fn = batch_fn
        self.multi = len(inputs) > 1
        self.deterministic = deterministic
        # pure column projection: emit via one itemgetter pass
        self._proj = None
        self._proj_idx: tuple | None = None
        self._ident: bool | None = None
        if projection is not None and not self.multi and deterministic:
            import operator as _op

            self._proj_idx = projection
            if len(projection) == 1:
                idx = projection[0]
                self._proj = lambda v, _i=idx: (v[_i],)
            else:
                self._proj = _op.itemgetter(*projection)
        if self.multi or not deterministic:
            self.in_states = [TableState() for _ in inputs]
            self.out_state: Dict[Pointer, tuple] = {}

    def snapshot_state(self) -> dict | None:
        if self.multi or not self.deterministic:
            return {"in_states": self.in_states, "out_state": self.out_state}
        return None

    def process(self, time: int) -> None:
        if not self.multi and self.deterministic:
            deltas, clean = self.take_with_clean(0)
            if not deltas:
                return
            proj = self._proj
            if proj is not None:
                if self._ident is None and deltas:
                    # identity projection: same columns, same order
                    w = len(deltas[0][1])
                    self._ident = self._proj_idx == tuple(range(w))
                if self._ident:
                    # rows pass through untouched; a clean input batch
                    # stays clean (keys, values, diffs all unchanged)
                    if clean:
                        self.emit_consolidated(time, deltas)
                    else:
                        self.emit(time, deltas)
                    return
                # non-identity projections can collapse distinct values
                # into cancellable pairs, so always re-consolidate
                self.emit(time, [(k, proj(v), d) for k, v, d in deltas])
                return
            keys = [d[0] for d in deltas]
            rows = ([d[1] for d in deltas],)
            new_rows = self.batch_fn(keys, rows)
            self.emit(
                time,
                [
                    (k, nv, d[2])
                    for k, nv, d in zip(keys, new_rows, deltas)
                ],
            )
            return

        touched: list = []
        seen: set = set()
        for port in range(len(self.inputs)):
            deltas = self.take(port)
            if deltas:
                self.in_states[port].apply(deltas, source=self.name)
                for k, _, _ in deltas:
                    if k not in seen:
                        seen.add(k)
                        touched.append(k)
        if not touched:
            return
        out: List[Delta] = []
        live_keys = []
        for key in touched:
            if key not in self.in_states[0].rows:
                old = self.out_state.pop(key, None)
                if old is not None:
                    out.append((key, old, -1))
            else:
                live_keys.append(key)
        if live_keys:
            rows = tuple(
                [s.rows.get(k) for k in live_keys] for s in self.in_states
            )
            new_rows = self.batch_fn(live_keys, rows)
            from pathway_tpu_torch.engine.stream import values_equal_tuple

            for key, nv in zip(live_keys, new_rows):
                old = self.out_state.get(key)
                if old is not None:
                    if values_equal_tuple(old, nv):
                        continue
                    out.append((key, old, -1))
                out.append((key, nv, 1))
                self.out_state[key] = nv
        self.emit(time, out)


class FilterNode(Node):
    """Keep rows where predicate holds (reference: filter_table)."""

    name = "filter"

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        pred_fn: Callable[[List[Pointer], Tuple[List[tuple], ...]], List[Any]],
    ):
        super().__init__(engine, [input_])
        self.pred_fn = pred_fn

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        mask = self.pred_fn(keys, rows)
        out = []
        for (key, values, diff), keep in zip(deltas, mask):
            if isinstance(keep, Error):
                self.log_error("Error value in filter condition")
            elif keep:
                out.append((key, values, diff))
        self.emit(time, out)


class ReindexNode(Node):
    """Re-key rows by a computed pointer (reference: reindex_table /
    with_id_from)."""

    name = "reindex"

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        key_fn: Callable[[List[Pointer], Tuple[List[tuple], ...]], List[Pointer]],
    ):
        super().__init__(engine, [input_])
        self.key_fn = key_fn

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        new_keys = self.key_fn(keys, rows)
        out = []
        for (key, values, diff), new_key in zip(deltas, new_keys):
            if isinstance(new_key, Error) or new_key is None:
                self.log_error("invalid key in reindex")
                continue
            out.append((new_key, values, diff))
        self.emit(time, out)


class CaptureNode(Node):
    """Materializes its input (for debug output, exports, and the runner's
    result extraction). Also records the update stream when asked."""

    name = "capture"
    snapshot_attrs = ('state', 'stream')

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        *,
        record_stream: bool = False,
        multiset: bool = False,
    ):
        super().__init__(engine, [input_])
        self.state = TableState(multiset=multiset)
        self.record_stream = record_stream
        self.stream: List[Tuple[int, Delta]] = []

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self.state.apply(deltas, source=self.name)
        if self.record_stream:
            self.stream.extend([(time, d) for d in deltas])


class SubscribeNode(Node):
    """Calls user callbacks on changes (reference: subscribe_table,
    engine.pyi:714-725)."""

    name = "subscribe"
    snapshot_attrs = ('_saw_data_at',)

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        *,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
        column_names: List[str] | None = None,
        sink_name: str | None = None,
    ):
        super().__init__(engine, [input_])
        self._on_change = on_change
        self._on_time_end = on_time_end
        self._on_end = on_end
        self.column_names = column_names or []
        self.sink_name = sink_name
        self._saw_data_at: set[int] = set()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self._saw_data_at.add(time)
        if self._on_change is not None:
            for key, values, diff in deltas:
                row = dict(zip(self.column_names, values))
                self._on_change(key=key, row=row, time=time, is_addition=diff > 0)

    def on_time_end(self, time: int) -> None:
        if time in self._saw_data_at:
            if self._on_time_end is not None:
                self._on_time_end(time)
            # sink freshness: the epoch's rows have now fully left the
            # graph through this sink (callbacks included)
            m = self.engine.metrics
            if m is not None:
                m.note_sink_emit(
                    self.sink_name or f"{self.name}#{self._idx}", time
                )

    def on_end(self) -> None:
        if self._on_end is not None:
            self._on_end()


class ErrorLogNode(Node):
    """Exposes the engine error log as a table (reference: Graph::error_log,
    graph.rs:932)."""

    name = "error_log"
    snapshot_attrs = ('_pending_entries', '_count')

    def __init__(self, engine: Engine):
        super().__init__(engine, [])
        engine.error_log_nodes.append(self)
        self._pending_entries: List[ErrorLogEntry] = []
        self._count = 0

    def push(self, entry: ErrorLogEntry) -> None:
        self._pending_entries.append(entry)

    def has_pending(self) -> bool:
        return bool(self._pending_entries) or super().has_pending()

    def process(self, time: int) -> None:
        if not self._pending_entries:
            return
        from pathway_tpu_torch.engine.value import ref_scalar

        out = []
        for entry in self._pending_entries:
            self._count += 1
            key = ref_scalar("error", self._count)
            out.append((key, (entry.message, entry.operator), 1))
        self._pending_entries.clear()
        self.emit(time, out)
