"""Query-path SLO observability: per-request spans, digest-backed
latency percentiles, SLO burn tracking, and slow-query exemplars.

The other observability layers — metrics (always-on histograms), epoch
tracing, utilization, memtrack, health — watch the *dataflow*: ticks,
nodes, devices.  Nothing else follows an individual query from HTTP
ingress to response, and without per-stage attribution we cannot say
whether a tail spike is network, queueing, or device time.  This module
closes that gap with deliberately read-only instrumentation:

  * **Spans** — the rest connector stamps each query's engine key as the
    query id at ingress; hook sites along the path record marks
    (``enqueued``, ``picked``, ``search_start``, ``device_end``,
    ``emitted``) and the response handler closes the span.  Marks are
    ``time.perf_counter`` readings, the clock of the host-span ring
    (internals/tracing.py); wall time is derived at export and on the
    TCP wire (``to_wall``).  Stage durations derive from consecutive
    marks:

        network  ingress  -> enqueued      (parse/validate/handoff)
        queue    enqueued -> picked        (buffered before the engine tick)
        batch    picked   -> search_start  (batch formation / tokenize)
        device   search_start -> device_end (fused dispatch; charged time
                                            when the index reports it)
        merge    device_end -> emitted     (result propagation + top-k merge)
        emit     emitted  -> respond       (subscribe -> future -> response)

    A query whose row went through a batched UDF (an LLM's generate
    call on ``/v2/answer``) also carries ``udf_start`` / ``udf_end``, the
    first start and the last end of that batch's evaluation, and its
    ``merge`` splits in three:

        merge    device_end -> udf_start   (results joined, prompt built)
        udf      udf_start  -> udf_end     (the batched UDF's calls)
        post_udf udf_end    -> emitted     (the rest of the dataflow)

    Finished spans stay in a bounded ring (``finished_between``).

  * **Digests** — per-stage and total latencies feed mergeable t-digest
    quantile sketches (``internals/metrics.Digest``), exported as
    ``pathway_query_latency_seconds{stage,quantile}`` with accurate
    p50/p95/p99/p999 (log2 buckets cannot certify an SLO).

  * **SLO** — a declarative p99 target (``PATHWAY_SLO_P99_MS`` or
    ``pw.run(slo=...)``) drives a rolling burn-rate gauge (violation
    fraction over the error budget); sustained burn warns once per
    episode and drops a flight-recorder event.

  * **Exemplars** — a query whose latency exceeds ``p99 x K`` keeps its
    full span tree (marks, stage breakdown, per-replica device times) in
    a capped ring, so a tail spike points at the stage and replica
    responsible.  Charged device time counts toward the trigger, so
    emulated-mesh fault factors (``slow_replica``) surface as exemplars
    even when wall time is unaffected.

Cross-worker merge: same-process workers share this process-wide
tracker; TCP workers ship their marks to worker 0 as ``qspan`` wire
messages (the MSG_STAMP side-channel pattern: Python-codec only, never
counted toward punctuation, per-peer FIFO so spans for an epoch arrive
before the punctuation that completes it).

``PATHWAY_QTRACE=0`` disables everything: every hook site guards on the
module attribute ``ENABLED``, so the disabled cost is one attribute
read.  This module imports only the stdlib (never jax).

Config:
  PATHWAY_QTRACE=0            disable (default: enabled)
  PATHWAY_QTRACE_SAMPLE=N     trace every Nth query (default 1 = all)
  PATHWAY_SLO_P99_MS=F        declarative p99 target in ms
  PATHWAY_SLO_WINDOW_S=F      burn-rate window (default 60)
  PATHWAY_SLO_BURN_SUSTAIN_S=F  sustained-burn threshold (default 30)
  PATHWAY_QTRACE_EXEMPLAR_K=F exemplar trigger factor over p99 (default 1.5)
"""

from __future__ import annotations

import logging
import os
import threading
import time as time_mod
from collections import deque
from operator import itemgetter
from typing import Any, Dict, List, Optional

_BY_VALUE = itemgetter(1)

ENABLED = os.environ.get("PATHWAY_QTRACE", "1") != "0"

logger = logging.getLogger("pathway_tpu_torch.qtrace")

# span taxonomy: marks in path order; stages between consecutive marks
MARKS = (
    "ingress", "enqueued", "picked", "search_start", "device_end",
    "udf_start", "udf_end", "emitted", "respond",
)
STAGES = (
    "network", "queue", "batch", "device", "merge", "udf", "post_udf", "emit",
)
# (stage, closing mark) pairs, precomputed for the finish hot path: the
# chain of a query without batched-UDF marks, and of one with them
_STAGE_PAIRS = (
    ("network", "enqueued"), ("queue", "picked"), ("batch", "search_start"),
    ("device", "device_end"), ("merge", "emitted"), ("emit", "respond"),
)
_UDF_STAGE_PAIRS = _STAGE_PAIRS[:4] + (
    ("merge", "udf_start"), ("udf", "udf_end"), ("post_udf", "emitted"),
    ("emit", "respond"),
)
_CORE_STAGES = tuple(stage for stage, _mark in _STAGE_PAIRS)
# finished spans kept for finished_between: a traced benchmark window of
# 32 closed-loop clients finishes a few hundred
FINISHED_CAPACITY = 4096

_SLO_BUDGET = 0.01  # SLO semantics: at most 1% of queries over target
_QUANTILES = (0.5, 0.95, 0.99, 0.999)
# Chrome-trace pid for the "queries" process row: distinct from worker
# pids so query spans merge cleanly into engine.dump_trace() output
_TRACE_PID = 9999


def _wall_offset() -> float:
    """time.time() - time.perf_counter(): the wall clock read between two
    perf_counter reads, the tightest of three brackets (a thread switch
    inside one would skew it)."""
    best = None
    for _ in range(3):
        p0 = time_mod.perf_counter()
        wall = time_mod.time()
        p1 = time_mod.perf_counter()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + p1) / 2)
    return best[1]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class QueryTracer:
    """Process-wide per-query span store + digest/SLO/exemplar surfaces.

    Locking: one lock guards the pending map and the finish-side
    aggregates.  Hook sites are per-query (serving rates, not ingest
    rates), so a plain lock is cheap; the ingest hot path only touches
    ``mark_batch``, which early-outs on an empty pending map without
    taking the lock.
    """

    def __init__(self) -> None:
        from pathway_tpu_torch.internals.metrics import (
            Digest,
            FlightRecorder,
            MetricsRegistry,
        )

        self._lock = threading.Lock()
        self._digest_cls = Digest
        # qid -> {"route", "marks": {name: perf_counter}, "meta": {...}}
        self._pending: Dict[str, dict] = {}
        # engine key object -> qid (lets mark_batch avoid str() per row)
        self._pending_keys: Dict[Any, str] = {}
        # eviction pacing: the stale scan is O(pending), so a burst that
        # legitimately holds >4096 spans in flight must not pay it on
        # every begin (nothing would be stale yet anyway)
        self._last_evict = 0.0
        self.sample_every = max(
            1, int(_env_float("PATHWAY_QTRACE_SAMPLE", 1))
        )
        self._seq = 0
        # "cache" is an extra reporting stage (not in the mark chain):
        # result-cache hits book their search_start->device_end wall
        # there with ZERO device charge, so cached and uncached latency
        # distributions stay separable
        self.stage_digests: Dict[str, Any] = {
            s: Digest() for s in STAGES + ("cache",)
        }
        self.total_digest = Digest()
        self.completed = 0
        self._finish_walls: deque = deque(maxlen=8192)  # for QPS
        # slow-query exemplars: full span trees, capped ring
        self.exemplars: deque = deque(maxlen=32)
        self.exemplar_k = _env_float("PATHWAY_QTRACE_EXEMPLAR_K", 1.5)
        self._recent: deque = deque(maxlen=64)  # last finished spans
        self._finished: deque = deque(maxlen=FINISHED_CAPACITY)
        # perf_counter -> wall-clock offset, sampled once (TraceStore's
        # convention): marks stamp the cheap clock, export converts
        self._wall_off = _wall_offset()
        # exemplar threshold cache: quantile() compresses the digest, so
        # computing p99 on EVERY finish would put a sort on the serving
        # hot path — refresh only right after a natural compress, when
        # the buffer is empty and quantile() is a cheap centroid walk
        # (tail thresholds don't need per-query freshness)
        self._p99_cache: Optional[float] = None
        self.recorder = FlightRecorder(capacity=128)
        # SLO burn state
        self.slo_p99_ms: Optional[float] = None
        env_slo = os.environ.get("PATHWAY_SLO_P99_MS")
        if env_slo:
            try:
                self.slo_p99_ms = float(env_slo)
            except ValueError:
                pass
        self.slo_window_s = _env_float("PATHWAY_SLO_WINDOW_S", 60.0)
        self.burn_sustain_s = _env_float("PATHWAY_SLO_BURN_SUSTAIN_S", 30.0)
        self._slo_samples: deque = deque(maxlen=8192)  # (perf, violated)
        self.slo_violations = 0
        self._burn_since: Optional[float] = None
        self._burn_warned = False
        self.burn_episodes = 0
        # concurrent device pressure: (perf, seconds, source) notes from
        # knn search dispatches and pipeline completions — tail context
        # ("was ingest hammering the chip while this query ran slow?")
        self._device_window: deque = deque(maxlen=512)
        # cross-worker shipping (TCP mode): marks recorded here while a
        # non-zero worker is attached are queued for worker 0
        self._worker_id = 0
        self._remote_out: List[dict] = []
        # registry: pull-time callbacks only — scrapes never touch the
        # hot path
        reg = self.registry = MetricsRegistry(worker=str(self._worker_id))
        reg.gauge(
            "pathway_query_latency_seconds",
            help="digest-backed per-stage query latency quantiles "
            "(stage 'total' is ingress->response)",
            labels=("stage", "quantile"),
            callback=self._latency_samples,
        )
        reg.gauge(
            "pathway_query_qps",
            help="completed queries per second over the trailing window",
            callback=lambda: round(self.qps(), 4),
        )
        reg.counter(
            "pathway_queries_total",
            help="queries completed through the traced serving path",
            callback=lambda: self.completed,
        )
        reg.gauge(
            "pathway_query_inflight",
            help="queries between ingress and response right now",
            callback=lambda: len(self._pending),
        )
        reg.gauge(
            "pathway_slo_target_p99_ms",
            help="declarative p99 target (PATHWAY_SLO_P99_MS / pw.run(slo=))",
            callback=lambda: self.slo_p99_ms,
        )
        reg.gauge(
            "pathway_slo_burn_rate",
            help="violation fraction over the error budget (>1 = burning)",
            callback=lambda: self.burn_rate(),
        )
        reg.counter(
            "pathway_slo_violations_total",
            help="queries over the SLO target",
            callback=lambda: self.slo_violations,
        )

    # -- span lifecycle ----------------------------------------------------
    def begin(
        self,
        qid: str,
        *,
        route: str = "",
        key: Any = None,
        tenant: str = "",
    ) -> bool:
        """Open a span at HTTP ingress.  Returns False when this query
        falls outside the sampling stride (callers then skip the
        remaining hooks for free — absent qids no-op everywhere).
        `tenant` is the admission controller's resolved X-Tenant — it
        rides the span into exemplars, per-stage digests, and the cost
        ledger's batched-dispatch attribution."""
        self._seq += 1
        if self._seq % self.sample_every:
            return False
        now = time_mod.perf_counter()
        with self._lock:
            if len(self._pending) > 4096 and now - self._last_evict > 5.0:
                self._evict_stale_locked(now)
            rec = {
                "qid": qid,
                "route": route,
                "tenant": tenant,
                "marks": {"ingress": now},
                "meta": {},
                "key": key,
            }
            self._pending[qid] = rec
            if key is not None:
                self._pending_keys[key] = qid
        return True

    def mark(self, qid: str, name: str, *, latest: bool = False,
             **meta: Any) -> None:
        """Stamp `name` on a pending query: its first stamp stays, or
        with `latest` the last one does."""
        rec = self._pending.get(qid)
        if rec is None:
            return
        if latest:
            rec["marks"][name] = time_mod.perf_counter()
        else:
            rec["marks"].setdefault(name, time_mod.perf_counter())
        if meta:
            rec["meta"].update(meta)
        if self._worker_id != 0:
            off = self._wall_off
            self._remote_out.append(
                {"qid": qid,
                 "marks": {k: v + off for k, v in rec["marks"].items()},
                 "meta": dict(rec["meta"])}
            )

    def to_wall(self, t: float) -> float:
        """A mark (perf_counter) as wall-clock seconds."""
        return t + self._wall_off

    def mark_batch(self, batch, name: str = "picked") -> None:
        """Stamp every pending query whose engine key appears in a flushed
        delta batch.  Early-outs without the lock when no query is in
        flight, so ingest-only pipelines pay one truthiness check."""
        keys = self._pending_keys
        if not keys:
            return
        for entry in batch:
            qid = keys.get(entry[0])
            if qid is not None:
                self.mark(qid, name)

    def mark_keys(self, keys, name: str, *, latest: bool = False,
                  **meta: Any) -> None:
        """Stamp pending queries by engine key (index/search operators
        see keys, not qids).  Free when nothing is in flight."""
        pk = self._pending_keys
        if not pk:
            return
        for k in keys:
            qid = pk.get(k)
            if qid is not None:
                self.mark(qid, name, latest=latest, **meta)

    def note_batch_occupancy(
        self, keys, occupancy: int, waited_ms: Optional[float] = None
    ) -> None:
        """Annotate pending queries with the serving micro-batch they
        rode in: how many queries shared the flush and how long the first
        arrival waited for company.  Meta-only (no timestamp mark) — the
        span timeline already has 'enqueued' at flush time."""
        pk = self._pending_keys
        if not pk:
            return
        meta: Dict[str, Any] = {"batch_occupancy": int(occupancy)}
        if waited_ms is not None:
            meta["batch_wait_ms"] = round(float(waited_ms), 3)
        for k in keys:
            qid = pk.get(k)
            if qid is not None:
                rec = self._pending.get(qid)
                if rec is not None:
                    rec["meta"].update(meta)

    def attribution_for_keys(self, keys) -> Dict[Any, tuple]:
        """(route, tenant) per traced engine key — the cost ledger's
        attribution source when it splits a batched dispatch across the
        queries that rode in it.  Untraced keys are simply absent (the
        ledger charges them to the ("", "") bucket)."""
        pk = self._pending_keys
        out: Dict[Any, tuple] = {}
        if not pk:
            return out
        for k in keys:
            qid = pk.get(k)
            if qid is None:
                continue
            rec = self._pending.get(qid)
            if rec is not None:
                out[k] = (rec.get("route", ""), rec.get("tenant", ""))
        return out

    def note_cache_hits(self, keys) -> List[str]:
        """Mark traced queries as result-cache hits: their span books the
        search_start->device_end wall under the distinct "cache" stage
        with ZERO device charge (the dispatch never happened for them).
        Returns the tenants of the traced hits so the ledger's
        cache-savings gauge attributes them."""
        pk = self._pending_keys
        tenants: List[str] = []
        if not pk:
            return tenants
        for k in keys:
            qid = pk.get(k)
            if qid is None:
                continue
            rec = self._pending.get(qid)
            if rec is not None:
                rec["meta"]["cache_hit"] = True
                tenants.append(rec.get("tenant", ""))
        return tenants

    def note_device_keys(
        self,
        keys,
        seconds: float,
        *,
        replica_times: Optional[Dict[int, float]] = None,
    ) -> None:
        """Charge one batched device dispatch to every traced query in
        it.  The dispatch is one SPMD program — wall time is shared — so
        each query is charged the full batch device time (that IS its
        latency contribution), mirroring the mesh backend's charging
        convention."""
        pk = self._pending_keys
        if not pk:
            return
        for k in keys:
            qid = pk.get(k)
            if qid is not None:
                self.note_device(qid, seconds, replica_times=replica_times)

    def note_device(
        self,
        qid: str,
        seconds: float,
        *,
        replica_times: Optional[Dict[int, float]] = None,
    ) -> None:
        """Charge device time to a query.  Per-replica times pass through
        the fault harness's ``slow_replica`` factor — the same charging
        rule the mesh backend applies — so injected stragglers surface in
        exemplars even on an emulated mesh where wall time is real."""
        rec = self._pending.get(qid)
        if rec is None:
            return
        from pathway_tpu_torch.internals import faults

        if faults.ACTIVE:
            if replica_times:
                replica_times = {
                    int(r): t * faults.replica_factor(r)
                    for r, t in replica_times.items()
                }
            else:
                # no per-replica detail from the caller: probe the fault
                # harness directly so an armed slow_replica still shows up
                # (replica_slowed is read-only; replica_factor charges)
                slowed = [r for r in range(8) if faults.replica_slowed(r)]
                if slowed:
                    replica_times = {
                        r: seconds * faults.replica_factor(r) for r in slowed
                    }
            if replica_times:
                seconds = max(seconds, max(replica_times.values()))
        meta: Dict[str, Any] = {"device_s": seconds}
        if replica_times:
            meta["replica_times"] = {
                str(r): round(t, 6) for r, t in replica_times.items()
            }
        self.mark(qid, "device_end", **meta)

    def note_device_window(self, seconds: float, *, source: str = "search") -> None:
        """Record device busy time from any dispatcher (knn search,
        ingest pipeline completion) into the rolling pressure window."""
        self._device_window.append(
            (time_mod.perf_counter(), float(seconds), source)
        )

    def device_busy_s(self, window_s: float = 30.0) -> float:
        """Total noted device-busy seconds over the trailing window."""
        now = time_mod.perf_counter()
        return round(
            sum(s for w, s, _ in self._device_window if now - w <= window_s),
            6,
        )

    def finish(self, qid: str) -> Optional[dict]:
        """Close the span at response time; feed digests, SLO window, and
        the exemplar ring.  Returns the finished record (tests)."""
        now = time_mod.perf_counter()
        with self._lock:
            rec = self._pending.pop(qid, None)
            if rec is None:
                return None
            key = rec.get("key")
            if key is not None:
                self._pending_keys.pop(key, None)
            elif self._pending_keys:
                # reverse map may hold this qid under an engine key
                for k, q in list(self._pending_keys.items()):
                    if q == qid:
                        del self._pending_keys[k]
                        break
        rec["marks"]["respond"] = now
        stages = self._stage_breakdown(rec)
        rec["stages_ms"] = {s: v * 1000.0 for s, v in stages.items()}
        total_wall = now - rec["marks"]["ingress"]
        # charged stage time counts toward the effective total so that
        # fault-scaled device charges trip the exemplar/SLO machinery
        total = max(total_wall, sum(stages.values()))
        rec["total_ms"] = total * 1000.0
        slowest = max(stages.items(), key=_BY_VALUE)[0] if stages else None
        rec["slowest_stage"] = slowest
        with self._lock:
            for s, v in stages.items():
                self.stage_digests[s].observe(v)
            self.total_digest.observe(total)
            self.completed += 1
            self._finish_walls.append(now)
            self._recent.append(rec)
            self._finished.append(rec)
            self._note_slo_locked(now, total * 1000.0)
            self._maybe_exemplar_locked(rec, total * 1000.0)
        return rec

    def finished_between(self, t0: float, t1: float) -> List[dict]:
        """Finished spans (records with their marks, perf_counter) whose
        ingress..respond overlaps [t0, t1], oldest first; nothing is
        consumed."""
        with self._lock:
            return [
                r for r in self._finished
                if r["marks"]["ingress"] <= t1 and r["marks"]["respond"] >= t0
            ]

    def _stage_breakdown(self, rec: dict) -> Dict[str, float]:
        marks = rec["marks"]
        # walk the mark chain; a missing mark collapses its stage to 0
        # and out-of-order marks clamp to the previous point (never
        # negative) — deltas are >= 0 by construction
        stages = {}
        last = marks.get("ingress", 0.0)
        pairs = _UDF_STAGE_PAIRS if "udf_start" in marks else _STAGE_PAIRS
        for stage, name in pairs:
            t = marks.get(name, last)
            if t < last:
                t = last
            stages[stage] = t - last
            last = t
        if rec["meta"].get("cache_hit"):
            # result-cache hit: the search_start->device_end wall is
            # cache-lookup time, not device time — book it under the
            # distinct "cache" stage and drop "device" entirely (a zero
            # observation would pollute the uncached device distribution)
            stages["cache"] = stages.pop("device")
            return stages
        device_s = rec["meta"].get("device_s")
        if device_s is not None and device_s > stages["device"]:
            stages["device"] = float(device_s)
        return stages

    def _evict_stale_locked(self, now: float) -> None:
        self._last_evict = now
        for qid, rec in list(self._pending.items()):
            if now - rec["marks"].get("ingress", now) > 600.0:
                self._pending.pop(qid, None)
        alive = set(self._pending)
        self._pending_keys = {
            k: q for k, q in self._pending_keys.items() if q in alive
        }

    # -- SLO ---------------------------------------------------------------
    def set_slo(self, p99_ms: Optional[float]) -> None:
        self.slo_p99_ms = float(p99_ms) if p99_ms is not None else None

    def _note_slo_locked(self, now: float, total_ms: float) -> None:
        target = self.slo_p99_ms
        if target is None:
            return
        violated = total_ms > target
        if violated:
            self.slo_violations += 1
        self._slo_samples.append((now, violated))
        burn = self._burn_rate_locked(now)
        if burn is not None and burn >= 1.0:
            if self._burn_since is None:
                self._burn_since = now
            elif (
                not self._burn_warned
                and now - self._burn_since >= self.burn_sustain_s
            ):
                self._burn_warned = True
                self.burn_episodes += 1
                self.recorder.record(
                    "slo_burn",
                    name=f"p99 target {target}ms",
                    duration_s=now - self._burn_since,
                    rows=self.slo_violations,
                )
                logger.warning(
                    "SLO burn: >%d%% of queries over %.1fms for %.0fs "
                    "(burn rate %.2f)",
                    int(_SLO_BUDGET * 100), target,
                    now - self._burn_since, burn,
                )
        else:
            self._burn_since = None
            self._burn_warned = False

    def _burn_rate_locked(self, now: float) -> Optional[float]:
        if self.slo_p99_ms is None:
            return None
        cutoff = now - self.slo_window_s
        while self._slo_samples and self._slo_samples[0][0] < cutoff:
            self._slo_samples.popleft()
        if not self._slo_samples:
            return 0.0
        bad = sum(1 for _, v in self._slo_samples if v)
        return (bad / len(self._slo_samples)) / _SLO_BUDGET

    def burn_rate(self) -> Optional[float]:
        with self._lock:
            rate = self._burn_rate_locked(time_mod.perf_counter())
        return round(rate, 4) if rate is not None else None

    # -- exemplars ---------------------------------------------------------
    def _maybe_exemplar_locked(self, rec: dict, total_ms: float) -> None:
        # need a populated digest before p99 x K means anything; until
        # then only an explicit SLO target can trigger capture
        thresh = None
        if self.total_digest.count >= 32:
            if self._p99_cache is None or not self.total_digest._buf:
                self._p99_cache = self.total_digest.quantile(0.99)
            if self._p99_cache is not None:
                thresh = self._p99_cache * 1000.0 * self.exemplar_k
        if self.slo_p99_ms is not None:
            thresh = (
                self.slo_p99_ms
                if thresh is None
                else min(thresh, self.slo_p99_ms * self.exemplar_k)
            )
        if thresh is None or total_ms <= thresh:
            return
        replica = None
        rt = rec["meta"].get("replica_times")
        if rt:
            replica = int(max(rt, key=lambda r: rt[r]))
        exemplar = dict(rec)
        # capture is the rare path: round the display fields here rather
        # than on every finish
        exemplar["total_ms"] = round(rec["total_ms"], 4)
        exemplar["stages_ms"] = {
            s: round(v, 4) for s, v in rec["stages_ms"].items()
        }
        exemplar["threshold_ms"] = round(thresh, 4)
        exemplar["replica"] = replica
        exemplar["wall"] = self.to_wall(rec["marks"]["respond"])
        exemplar["device_busy_s_30s"] = self.device_busy_s()
        # slow-query exemplars carry the result row's lineage when the
        # provenance tracker is armed — "why was THIS row slow AND where
        # did it come from" in one /status read
        from pathway_tpu_torch.internals import provenance as _provenance

        if _provenance.ACTIVE and rec.get("key") is not None:
            try:
                exemplar["lineage"] = _provenance.tracker().explain_brief(
                    rec["key"]
                )
            except Exception:
                pass
        self.exemplars.append(exemplar)
        self.recorder.record(
            "slow_query",
            name=f"{rec.get('route', '')}:{rec['qid']}",
            duration_s=total_ms / 1000.0,
        )

    # -- cross-worker merge --------------------------------------------------
    def attach_worker(self, worker_id: int) -> None:
        """Declare which worker this process plays in a multi-process
        run; non-zero workers queue their marks for shipment."""
        self._worker_id = worker_id
        self.registry.const_labels["worker"] = str(worker_id)

    def on_tick(self, engine) -> None:
        """Per-tick transport hook (engine.process_time tail): non-zero
        workers flush queued marks toward worker 0; worker 0 absorbs
        whatever arrived.  Same-process workers share this tracker, so
        thread mode never queues."""
        coord = getattr(engine, "coord", None)
        if coord is None:
            return
        if self._worker_id != 0:
            if self._remote_out:
                out, self._remote_out = self._remote_out, []
                try:
                    coord.send_qspans(0, self._worker_id, {"spans": out})
                except Exception:  # noqa: BLE001 — diagnostics never fail a run
                    pass
        else:
            self.absorb(coord)

    def absorb(self, coord) -> None:
        """Merge qspan payloads shipped from other processes into local
        pending records (or recent ones, for marks that arrive after the
        response already closed)."""
        try:
            payloads = coord.take_qspans()
        except Exception:  # noqa: BLE001
            return
        for origin, payload in payloads:
            for span in payload.get("spans", ()):
                self._absorb_span(origin, span)

    def _absorb_span(self, origin: int, span: dict) -> None:
        qid = span.get("qid")
        if not qid:
            return
        marks = span.get("marks") or {}
        meta = dict(span.get("meta") or {})
        meta["worker"] = origin
        with self._lock:
            rec = self._pending.get(qid)
            if rec is None:
                for r in reversed(self._recent):
                    if r["qid"] == qid:
                        rec = r
                        break
            if rec is None:
                return
            off = self._wall_off
            for name, wall in marks.items():
                rec["marks"].setdefault(name, wall - off)
            rec["meta"].update(meta)

    # -- surfaces ----------------------------------------------------------
    def qps(self, window_s: float = 10.0) -> float:
        with self._lock:
            return self._qps_locked(time_mod.perf_counter(), window_s)

    def _qps_locked(self, now: float, window_s: float = 10.0) -> float:
        recent = [w for w in self._finish_walls if now - w <= window_s]
        if not recent:
            return 0.0
        span = max(now - recent[0], 1e-9)
        return len(recent) / min(span, window_s) if span else 0.0

    def _latency_samples(self):
        out = []
        with self._lock:
            items = list(self.stage_digests.items()) + [
                ("total", self.total_digest)
            ]
            for stage, digest in items:
                if not digest.count:
                    continue
                for q in _QUANTILES:
                    v = digest.quantile(q)
                    if v is not None:
                        out.append(((stage, str(q)), round(v, 9)))
        return out

    def status(self) -> Dict[str, Any]:
        """The ``"queries"`` key for /status."""
        with self._lock:
            stages = {}
            for stage, digest in list(self.stage_digests.items()) + [
                ("total", self.total_digest)
            ]:
                if not digest.count:
                    continue
                stages[stage] = {
                    "count": int(digest.count),
                    "p50_ms": _ms(digest.quantile(0.5)),
                    "p95_ms": _ms(digest.quantile(0.95)),
                    "p99_ms": _ms(digest.quantile(0.99)),
                    "p999_ms": _ms(digest.quantile(0.999)),
                }
            now = time_mod.perf_counter()
            burn = self._burn_rate_locked(now)
            exemplars = [
                {
                    k: e.get(k)
                    for k in (
                        "qid", "route", "tenant", "total_ms",
                        "slowest_stage", "stages_ms", "replica",
                        "threshold_ms", "wall", "device_busy_s_30s",
                        "lineage",
                    )
                }
                for e in list(self.exemplars)[-8:]
            ]
            return {
                "enabled": True,
                "completed": self.completed,
                "inflight": len(self._pending),
                "qps": round(self._qps_locked(now), 3),
                "stages": stages,
                "slo": {
                    "target_p99_ms": self.slo_p99_ms,
                    "burn_rate": round(burn, 4) if burn is not None else None,
                    "burning": bool(burn is not None and burn >= 1.0),
                    "violations": self.slo_violations,
                    "burn_episodes": self.burn_episodes,
                },
                "device_busy_s_30s": self.device_busy_s(),
                "exemplars": exemplars,
                "events": self.recorder.tail(16),
            }

    def chrome_trace(self, qid: Optional[str] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON for recent finished
        queries (or one specific qid): one "queries" process row, one
        thread per query, a complete ("X") span per stage plus an
        enclosing span for the whole request.  Wall-clock marks are
        rebased to the earliest exported ingress so the timeline starts
        near zero (epoch-since-1970 microseconds break trace viewers)."""
        with self._lock:
            recs = [
                r
                for r in list(self._recent) + list(self.exemplars)
                if qid is None or r["qid"] == qid
            ]
        seen = set()
        te: List[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": _TRACE_PID,
                "tid": 0,
                "args": {"name": "queries"},
            }
        ]
        t_base = min(
            (r["marks"].get("ingress") for r in recs
             if r["marks"].get("ingress") is not None),
            default=0.0,
        )
        tid = 0
        for rec in recs:
            if rec["qid"] in seen:
                continue
            seen.add(rec["qid"])
            tid += 1
            marks = rec["marks"]
            t0 = marks.get("ingress")
            t1 = marks.get("respond")
            if t0 is None or t1 is None:
                continue
            te.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": _TRACE_PID,
                    "tid": tid,
                    "args": {"name": f"query {rec['qid']}"},
                }
            )
            te.append(
                {
                    "ph": "X",
                    "cat": "query",
                    "name": rec.get("route") or "query",
                    "pid": _TRACE_PID,
                    "tid": tid,
                    "ts": round((t0 - t_base) * 1e6, 1),
                    "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                    "args": {
                        "qid": rec["qid"],
                        "total_ms": rec.get("total_ms"),
                        "slowest_stage": rec.get("slowest_stage"),
                    },
                }
            )
            cursor = t0
            stages_ms = rec.get("stages_ms") or {}
            for stage in STAGES if "udf" in stages_ms else _CORE_STAGES:
                dur_ms = stages_ms.get(stage, 0.0)
                dur = dur_ms / 1000.0
                te.append(
                    {
                        "ph": "X",
                        "cat": "stage",
                        "name": stage,
                        "pid": _TRACE_PID,
                        "tid": tid,
                        "ts": round((cursor - t_base) * 1e6, 1),
                        "dur": round(dur * 1e6, 1),
                        "args": {"qid": rec["qid"], "stage_ms": dur_ms},
                    }
                )
                cursor += dur
        return {"traceEvents": te, "displayTimeUnit": "ms"}


def stage_intervals(rec: dict) -> List[tuple]:
    """(stage, start, end) of a span's stages between its marks, on the
    marks' clock (perf_counter): the mark chain as _stage_breakdown
    walks it, without charged device time; empty stages left out."""
    marks = rec["marks"]
    pairs = _UDF_STAGE_PAIRS if "udf_start" in marks else _STAGE_PAIRS
    out = []
    last = marks.get("ingress", 0.0)
    for stage, name in pairs:
        t = max(marks.get(name, last), last)
        if t > last:
            out.append((stage, last, t))
        last = t
    return out


def _ms(v: Optional[float]) -> Optional[float]:
    return round(v * 1000.0, 4) if v is not None else None


# -- process-wide singleton ---------------------------------------------------

_tracker: Optional[QueryTracer] = None
_tracker_lock = threading.Lock()


def tracker() -> QueryTracer:
    global _tracker
    t = _tracker
    if t is None:
        with _tracker_lock:
            t = _tracker
            if t is None:
                t = _tracker = QueryTracer()
    return t


def reset() -> None:
    """Fresh tracker (tests/benches scoping a measurement window)."""
    global _tracker
    with _tracker_lock:
        _tracker = None


def qtrace_metrics():
    """The registry for PrometheusServer._registries(); None when off."""
    if not ENABLED:
        return None
    return tracker().registry


def qtrace_status() -> Dict[str, Any]:
    """The ``"queries"`` key for /status."""
    if not ENABLED:
        return {"enabled": False}
    return tracker().status()
