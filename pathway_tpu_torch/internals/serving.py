"""Serving tier: continuous query micro-batching, admission control,
retraction-driven result caching, and latency-aware device-time
partitioning.

The ingest path has enjoyed packed ragged batching and an async
double-buffered pipeline since PR 7/9; the query path still paid one
engine flush — and one device dispatch — per REST request.  This module
closes that gap with four cooperating pieces, all process-wide and all
gated on one module attribute (``PATHWAY_SERVING=0`` reduces every hook
to a single ``ENABLED`` read, enforced by tests/test_perf_smoke.py):

  continuous micro-batcher (:class:`MicroBatcher`)
      REST handlers park each request on an arrival queue instead of
      committing it; a flush thread drains the queue on a time-or-size
      trigger (``PATHWAY_SERVE_BATCH_WINDOW_MS`` /
      ``PATHWAY_SERVE_MAX_BATCH``) and pushes the whole batch into the
      connector under ONE commit.  The engine then sees N queries in one
      tick, `ExternalIndexNode` batches them into one
      ``FusedEmbedSearch`` program (reusing ``tokenizer.pack_batch``
      slabs when ``PATHWAY_SERVE_PACK_QUERIES=1``), and the existing
      per-key response futures de-multiplex the results — per-query
      qtrace spans stay intact, annotated with the batch occupancy they
      rode in.

  admission control (:class:`AdmissionController`)
      a bounded in-flight queue plus per-tenant token buckets
      (``PATHWAY_SERVE_QUEUE``, ``PATHWAY_SERVE_TENANT_RATE``,
      ``PATHWAY_SERVE_TENANT_BURST``).  Overload is rejected at HTTP
      ingress with 429 + ``Retry-After`` — load is shed BEFORE the
      device, not after — and while the health controller holds
      backpressure the admission bound halves, so ingest pressure
      tightens serving admission too.

  retraction-driven result cache (:class:`ResultCache`)
      query results keyed on normalized query text.  Invalidation rides
      the retraction/delta stream the incremental engine already emits:
      ``ops/knn.py`` bumps a generation from its ``add``/``remove``
      paths — removals bump only the touched key's result cluster (a
      removal can only change queries whose results contained that key),
      while inserts/updates bump the global generation (a new or
      re-embedded doc can enter ANY query's top-k).  Zero stale reads,
      by construction.

  latency-aware device-time partitioner (:class:`DeviceTimePartitioner`)
      arbitrates device time between ingest dispatches and serving
      batches using the utilization tracker's bound-state gauge and the
      SLO burn rate (internals/qtrace.py).  When p99 burn rises past
      1.0, serving batches get priority slots — the ingest pipelines'
      in-flight windows shrink (``device_pipeline.set_serving_scale``)
      so serving dispatches stop queueing behind a full ingest window.
      When the burn clears (or the device goes idle), ingest reclaims
      the slots.  Transitions are recorded as health-controller actions
      (``serve_priority`` / ``serve_release``).

Surfaces: ``serving_status()`` is the ``"serving"`` key in /status
(batch occupancy p50/p99, cache hit rate, shed counts, tenant limiter
states), ``serving_metrics()`` joins the Prometheus exposition, and
`pathway-tpu status` + StatsMonitor render matching rows.
"""

from __future__ import annotations

import os
import threading
import time as time_mod
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

# Cheap guard read by every hook site (HTTP ingress, knn add/remove,
# index-node search, health tick).
ENABLED = os.environ.get("PATHWAY_SERVING", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def batch_window_ms() -> float:
    """Arrival-queue hold time before a partial batch flushes.  0
    disables coalescing (every request commits alone — the per-query
    baseline arm of serving_bench)."""
    return max(0.0, _env_float("PATHWAY_SERVE_BATCH_WINDOW_MS", 2.0))


def max_batch() -> int:
    """Size trigger: a batch this large flushes without waiting out the
    window."""
    return max(1, _env_int("PATHWAY_SERVE_MAX_BATCH", 64))


def pack_queries() -> bool:
    """Opt-in packed multi-query search (tokenizer.pack_batch slabs for
    the query batch).  Off by default: packed encoding is numerically
    equivalent but not bitwise identical to the classic bucketed encode,
    and the coalescing win does not depend on it."""
    return os.environ.get("PATHWAY_SERVE_PACK_QUERIES", "0") != "0"


def tenant_rate() -> float:
    """The armed per-tenant admission rate (PATHWAY_SERVE_TENANT_RATE,
    tokens/s); 0.0 means tenant limits are off.  Read at build time by
    analyzer PWT801 (limits armed while query tracing is off means shed
    decisions are unattributable)."""
    return max(0.0, _env_float("PATHWAY_SERVE_TENANT_RATE", 0.0))


# Result-key cluster count for remove-precision invalidation.  A removed
# key invalidates only cached entries whose results shared its cluster.
N_CLUSTERS = 256

# Serving-priority scale applied to ingest pipelines while the SLO burns
# (fraction of their configured queue/in-flight ceilings they keep).
PRIORITY_SCALE = _env_float("PATHWAY_SERVE_PRIORITY_SCALE", 0.5)

# Burn-rate hysteresis: engage priority at >= ON, release at < OFF.
BURN_ON = _env_float("PATHWAY_SERVE_BURN_ON", 1.0)
BURN_OFF = _env_float("PATHWAY_SERVE_BURN_OFF", 0.5)

# Serving's target share of attributed device time while the SLO burns.
# With the cost ledger live the partitioner steers to this share instead
# of the binary engage/release heuristic: priority engages only while
# serving actually holds LESS device time than the target, and releases
# as soon as it reaches it — burn caused by something other than device
# contention (e.g. host-bound tokenize) no longer starves ingest.
SERVE_SHARE_TARGET = _env_float("PATHWAY_SERVE_SHARE_TARGET", 0.5)

# Partitioner tick pacing (wall clock).
_PARTITION_TICK_S = 0.25


class _TokenBucket:
    """Classic token bucket; take() is called under the admission lock."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = time_mod.monotonic()

    def take(self, now: float) -> Optional[float]:
        """None when a token was taken; otherwise seconds until one
        accrues (the Retry-After hint)."""
        # max(0, ...): `now` may predate bucket creation by a few µs
        # (captured outside the admission lock) — a new tenant's first
        # request must never be shed over that skew.
        self.tokens = min(
            self.burst, self.tokens + max(0.0, now - self.last) * self.rate
        )
        self.last = max(self.last, now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0


class AdmissionController:
    """Bounded in-flight queue + per-tenant token buckets, consulted at
    HTTP ingress — overload sheds with 429 before any engine or device
    work happens."""

    def __init__(self):
        self.bound = max(1, _env_int("PATHWAY_SERVE_QUEUE", 256))
        self.rate = max(0.0, _env_float("PATHWAY_SERVE_TENANT_RATE", 0.0))
        default_burst = max(1.0, self.rate) if self.rate > 0 else 1.0
        self.burst = max(
            1.0, _env_float("PATHWAY_SERVE_TENANT_BURST", default_burst)
        )
        self._lock = threading.Lock()
        self.depth = 0
        self._tenants: Dict[str, _TokenBucket] = {}
        self.sheds: Dict[str, int] = {
            "queue_full": 0, "tenant_limit": 0, "backpressure": 0,
        }
        self.admitted = 0

    def _effective_bound(self) -> Tuple[int, bool]:
        """The live queue bound: halves while the health controller holds
        backpressure (shed/priority coupling — serving sheds earlier when
        the runtime is already pressured)."""
        from pathway_tpu_torch.internals import health

        ctrl = health._CONTROLLER if health.ENABLED else None
        if ctrl is not None and ctrl._pressure:
            return max(1, self.bound // 2), True
        return self.bound, False

    def admit(self, tenant: str) -> Optional[Tuple[float, str]]:
        """None = admitted (caller MUST release()); else (retry_after_s,
        reason) for the 429."""
        bound, pressured = self._effective_bound()
        now = time_mod.monotonic()
        with self._lock:
            if self.depth >= bound:
                reason = "backpressure" if pressured else "queue_full"
                self.sheds[reason] += 1
                return (1.0, reason)
            if self.rate > 0:
                bucket = self._tenants.get(tenant)
                if bucket is None:
                    bucket = self._tenants[tenant] = _TokenBucket(
                        self.rate, self.burst
                    )
                retry = bucket.take(now)
                if retry is not None:
                    self.sheds["tenant_limit"] += 1
                    return (retry, "tenant_limit")
            self.depth += 1
            self.admitted += 1
            return None

    def release(self) -> None:
        with self._lock:
            self.depth = max(0, self.depth - 1)

    def shed_total(self) -> int:
        return sum(self.sheds.values())

    def status(self) -> Dict[str, Any]:
        with self._lock:
            tenants = {
                t: {
                    "tokens": round(b.tokens, 3),
                    "rate": b.rate,
                    "burst": b.burst,
                }
                for t, b in list(self._tenants.items())[:8]
            }
            return {
                "queue_bound": self.bound,
                "queue_depth": self.depth,
                "admitted": self.admitted,
                "sheds": dict(self.sheds),
                "shed_total": sum(self.sheds.values()),
                "tenant_rate": self.rate,
                "tenant_burst": self.burst,
                "tenants": tenants,
                "tenant_count": len(self._tenants),
            }


class ResultCache:
    """LRU query-result cache keyed on normalized query text, invalidated
    by the index's retraction/delta stream.

    Generations: every insert/update bumps ``gen_global`` (a new or
    re-embedded doc can enter any query's top-k); a removal bumps only
    ``cluster_gens[hash(key) % N_CLUSTERS]`` (removing a doc can only
    change queries whose cached results contained it).  An entry is live
    iff its fill-time global generation AND the generations of every
    cluster its result keys live in are unchanged — so reads are never
    stale, while removals keep unrelated hot entries warm."""

    def __init__(self):
        self.capacity = max(0, _env_int("PATHWAY_SERVE_CACHE", 1024))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.gen_global = 0
        self.cluster_gens = [0] * N_CLUSTERS
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    @staticmethod
    def _cluster(key: Any) -> int:
        return hash(key) % N_CLUSTERS

    def note_add(self, n: int = 1) -> None:
        with self._lock:
            self.gen_global += 1

    def note_remove(self, key: Any) -> None:
        with self._lock:
            self.cluster_gens[self._cluster(key)] += 1

    @staticmethod
    def make_key(index_id: int, value: Any, k: Any, filt: Any):
        """Normalized cache key, or None for uncacheable queries (only
        plain text queries are cached — vector queries have no stable
        normal form worth hashing on the hot path)."""
        if not isinstance(value, str):
            return None
        norm = " ".join(value.lower().split())
        return (index_id, norm, int(k) if k is not None else None, filt)

    def get(self, key: tuple):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            if entry["gen"] != self.gen_global or any(
                self.cluster_gens[c] != g
                for c, g in entry["clusters"].items()
            ):
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry["result"]

    def put(self, key: tuple, result: List[tuple]) -> None:
        if self.capacity <= 0:
            return
        clusters = {}
        for match in result:
            c = self._cluster(match[0])
            clusters[c] = None  # filled under the lock for atomicity
        with self._lock:
            self._entries[key] = {
                "result": result,
                "gen": self.gen_global,
                "clusters": {
                    c: self.cluster_gens[c] for c in clusters
                },
            }
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def hit_rate(self) -> Optional[float]:
        total = self.hits + self.misses
        return self.hits / total if total else None

    def status(self) -> Dict[str, Any]:
        with self._lock:
            hits, misses = self.hits, self.misses
            return {
                "capacity": self.capacity,
                "entries": len(self._entries),
                "hits": hits,
                "misses": misses,
                "hit_rate": (
                    round(hits / (hits + misses), 4)
                    if hits + misses else None
                ),
                "invalidations": self.invalidations,
                "generation": self.gen_global,
            }


class MicroBatcher:
    """Arrival queue + flush thread: items coalesce for up to
    ``window_ms`` (or until ``max_batch`` arrive), then flush as one
    batch on the batcher thread.  Armed-but-idle the thread blocks on a
    condition — zero polling, zero engine-path cost."""

    def __init__(
        self,
        flush_fn: Callable[[List[Any]], None],
        *,
        window_ms: float,
        max_batch: int,
        name: str = "serve-batch",
        on_flush: Optional[Callable[[int, float], None]] = None,
    ):
        self._flush_fn = flush_fn
        self.window_s = max(0.0, window_ms) / 1000.0
        self.max_batch = max(1, max_batch)
        self._on_flush = on_flush
        self._cond = threading.Condition()
        self._items: List[Tuple[Any, float]] = []
        self._stop = False
        self.flushes = 0
        self.flushed_items = 0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, item: Any) -> None:
        with self._cond:
            self._items.append((item, time_mod.monotonic()))
            self._cond.notify_all()

    def _take_batch(self) -> Optional[List[Tuple[Any, float]]]:
        """Block until a batch is ready (time-or-size trigger) or stop."""
        with self._cond:
            while not self._items and not self._stop:
                self._cond.wait()
            if not self._items:
                return None  # stopping with an empty queue
            deadline = self._items[0][1] + self.window_s
            while (
                len(self._items) < self.max_batch
                and not self._stop
            ):
                remaining = deadline - time_mod.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch = self._items[: self.max_batch]
            del self._items[: len(batch)]
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = time_mod.monotonic()
            waited_ms = (now - batch[0][1]) * 1000.0
            try:
                self._flush_fn([item for item, _t in batch])
            except Exception:  # noqa: BLE001 — per-request futures carry
                # their own error path; a poisoned batch must not kill
                # the flush thread for every later request
                import logging

                logging.getLogger("pathway_tpu_torch").exception(
                    "serving: batch flush failed (%d queries)", len(batch)
                )
            self.flushes += 1
            self.flushed_items += len(batch)
            if self._on_flush is not None:
                self._on_flush(len(batch), waited_ms)

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5)


class DeviceTimePartitioner:
    """Arbitrates device time between ingest dispatches and serving
    batches: SLO burn engages priority (ingest pipelines' in-flight
    windows shrink to PRIORITY_SCALE of their ceilings), idle/cleared
    burn releases it (ingest reclaims the slots).  When the cost ledger
    is live its per-workload device share refines the decision — engage
    only while serving holds less than SERVE_SHARE_TARGET of attributed
    device time, release once it reaches it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_tick = 0.0
        self.priority = False
        self.shifts = 0
        self.reason: Optional[str] = None
        self.serve_share: Optional[float] = None

    def maybe_tick(self) -> None:
        now = time_mod.monotonic()
        if now < self._next_tick:
            return
        with self._lock:
            if now < self._next_tick:
                return
            self._next_tick = now + _PARTITION_TICK_S
        from pathway_tpu_torch.internals import costledger, qtrace, utilization

        burn = None
        if qtrace.ENABLED:
            burn = qtrace.tracker().burn_rate()
        bound_state = (
            utilization.current_bound_state()
            if utilization.ENABLED
            else "idle"
        )
        # Serving's attributed device share; None when the ledger is off
        # or the window is empty — then the binary burn heuristic below
        # is the whole decision, exactly the pre-ledger behavior.
        share = costledger.serve_device_share()
        self.serve_share = share
        if not self.priority:
            if burn is not None and burn >= BURN_ON:
                if share is not None and share >= SERVE_SHARE_TARGET:
                    return  # burning, but serving already holds its share
                self._engage(
                    f"slo burn {burn:.2f} >= {BURN_ON:g}, serve share "
                    f"{'n/a' if share is None else f'{share:.2f}'} < "
                    f"{SERVE_SHARE_TARGET:g} [{bound_state}]"
                )
        else:
            if (
                burn is None
                or burn < BURN_OFF
                or bound_state == "idle"
                or (share is not None and share >= SERVE_SHARE_TARGET)
            ):
                self._release(
                    f"burn {burn if burn is not None else 0:.2f} < "
                    f"{BURN_OFF:g}, share "
                    f"{'n/a' if share is None else f'{share:.2f}'}, "
                    f"or idle [{bound_state}]"
                )

    def _engage(self, reason: str) -> None:
        from pathway_tpu_torch.internals import device_pipeline

        device_pipeline.set_serving_scale(PRIORITY_SCALE)
        self.priority = True
        self.shifts += 1
        self.reason = reason
        self._health_act("serve_priority", reason)

    def _release(self, reason: str) -> None:
        from pathway_tpu_torch.internals import device_pipeline

        device_pipeline.set_serving_scale(1.0)
        self.priority = False
        self.reason = None
        self._health_act("serve_release", reason)

    @staticmethod
    def _health_act(action: str, reason: str) -> None:
        from pathway_tpu_torch.internals import health

        if health.ENABLED and health._CONTROLLER is not None:
            health._CONTROLLER._act(action, name=reason)

    def release_for_tests(self) -> None:
        if self.priority:
            self._release("reset")

    def status(self) -> Dict[str, Any]:
        from pathway_tpu_torch.internals import device_pipeline

        return {
            "priority": self.priority,
            "serving_scale": device_pipeline.serving_scale(),
            "priority_scale": PRIORITY_SCALE,
            "shifts": self.shifts,
            "reason": self.reason,
            "serve_share": self.serve_share,
            "share_target": SERVE_SHARE_TARGET,
        }


class ServingTier:
    """Process-wide serving state: the REST connectors' micro-batchers, the
    admission controller, the result cache, the partitioner, and their
    metrics."""

    def __init__(self):
        from pathway_tpu_torch.internals.metrics import (
            Digest,
            FlightRecorder,
            MetricsRegistry,
        )

        self.window_ms = batch_window_ms()
        self.max_batch = max_batch()
        self.admission = AdmissionController()
        self.cache = ResultCache()
        self.partitioner = DeviceTimePartitioner()
        self.recorder = FlightRecorder(capacity=64)
        self._lock = threading.Lock()
        # the live REST connectors' batchers, and the counts of those
        # whose connector's run has ended
        self._batchers: List[MicroBatcher] = []
        self._retired_flushes = 0
        self._retired_items = 0
        self.occupancy = Digest()
        self.batch_wait_ms = Digest()

        reg = self.metrics = MetricsRegistry(worker="0")
        reg.gauge(
            "pathway_serving_batch_occupancy",
            help="Digest quantiles of queries per flushed serving batch",
            labels=("quantile",),
            callback=self._occupancy_samples,
        )
        reg.counter(
            "pathway_serving_batches_total",
            help="Serving micro-batches flushed into the engine",
            callback=lambda: self._flush_counts()[0],
        )
        reg.counter(
            "pathway_serving_shed_total",
            help="Requests rejected at admission (429) by reason",
            labels=("reason",),
            callback=lambda: [
                ((r,), float(n))
                for r, n in self.admission.sheds.items()
            ],
        )
        reg.gauge(
            "pathway_serving_queue_depth",
            help="Admitted requests between ingress and response",
            callback=lambda: self.admission.depth,
        )
        reg.counter(
            "pathway_serving_cache_hits_total",
            help="Result-cache hits on the query search path",
            callback=lambda: self.cache.hits,
        )
        reg.counter(
            "pathway_serving_cache_misses_total",
            help="Result-cache misses on the query search path",
            callback=lambda: self.cache.misses,
        )
        reg.counter(
            "pathway_serving_cache_invalidations_total",
            help="Cache entries dropped by retraction-stream generations",
            callback=lambda: self.cache.invalidations,
        )
        reg.gauge(
            "pathway_serving_priority",
            help="1 while serving batches hold priority slots in the "
            "ingest pipelines' in-flight windows",
            callback=lambda: 1.0 if self.partitioner.priority else 0.0,
        )

    def _occupancy_samples(self):
        out = []
        for q, label in ((0.5, "p50"), (0.99, "p99")):
            v = self.occupancy.quantile(q)
            if v is not None:
                out.append(((label,), v))
        return out

    # -- batcher plumbing --------------------------------------------------

    def batcher(
        self, name: str, flush_fn: Callable[[List[Any]], None]
    ) -> MicroBatcher:
        """A new micro-batcher for one REST connector's run (`name` is
        its route).  Its flush thread keeps the connector's commits
        serialized; the connector hands it back to `retire` when its
        run ends."""
        b = MicroBatcher(
            flush_fn,
            window_ms=self.window_ms,
            max_batch=self.max_batch,
            name=f"serve-batch:{name}",
            on_flush=self._note_flush,
        )
        with self._lock:
            self._batchers.append(b)
        return b

    def retire(self, b: MicroBatcher) -> None:
        """Close a batcher whose connector's run has ended (its thread
        exits, and it lets go of the connector); its flushes stay
        counted."""
        b.close()
        with self._lock:
            if b in self._batchers:
                self._batchers.remove(b)
                self._retired_flushes += b.flushes
                self._retired_items += b.flushed_items

    def _flush_counts(self) -> Tuple[int, int]:
        """(batches flushed, queries in them), retired batchers included."""
        with self._lock:
            return (
                self._retired_flushes + sum(b.flushes for b in self._batchers),
                self._retired_items
                + sum(b.flushed_items for b in self._batchers),
            )

    def _note_flush(self, occupancy: int, waited_ms: float) -> None:
        self.occupancy.observe(float(occupancy))
        self.batch_wait_ms.observe(waited_ms)
        self.partitioner.maybe_tick()

    # -- cached search (called from engine/index_node.py) ------------------

    def cached_search(
        self,
        values: List[Any],
        ks: List[Any],
        filters: List[Any],
        search_fn: Callable[[List[Any], List[Any], List[Any]], List[list]],
        index_id: int = 0,
        q_keys: Optional[List[Any]] = None,
    ) -> List[list]:
        """search_many wrapped with the result cache: serve hits from the
        generation-checked cache, search only the misses, fill on the way
        out.  Order-preserving.  Hits are reported to qtrace (the span
        books its wall under a distinct ``cache`` stage with zero device
        charge, keeping cached latency out of the device digest) and to
        the cost ledger (per-tenant cache-savings — computed from the
        live uncached-query cost, not inferred from the hit rate)."""
        cache = self.cache
        if cache.capacity <= 0:
            return search_fn(values, ks, filters)
        results: List[Any] = [None] * len(values)
        cache_keys: List[Any] = [None] * len(values)
        miss: List[int] = []
        hit_idx: List[int] = []
        for i, (v, k, f) in enumerate(zip(values, ks, filters)):
            ck = cache.make_key(index_id, v, k, f)
            if ck is None:
                miss.append(i)
                continue
            hit = cache.get(ck)
            if hit is None:
                cache_keys[i] = ck
                miss.append(i)
            else:
                results[i] = hit
                hit_idx.append(i)
        if hit_idx and q_keys is not None:
            self._note_cache_hits([q_keys[i] for i in hit_idx])
        if miss:
            searched = search_fn(
                [values[i] for i in miss],
                [ks[i] for i in miss],
                [filters[i] for i in miss],
            )
            for i, res in zip(miss, searched):
                results[i] = res
                if cache_keys[i] is not None:
                    cache.put(cache_keys[i], res)
        return results

    @staticmethod
    def _note_cache_hits(keys: List[Any]) -> None:
        from pathway_tpu_torch.internals import costledger, provenance, qtrace

        tenants: List[str] = []
        if qtrace.ENABLED:
            tenants = qtrace.tracker().note_cache_hits(keys)
        if costledger.ENABLED:
            # untraced hits land in the "" tenant bucket — still counted
            costledger.note_cache_hits(
                tenants + [""] * (len(keys) - len(tenants))
            )
        if provenance.ACTIVE:
            # tag the served rows' lineage edges "knn:cache_hit" so
            # explain distinguishes fresh scores from cache replays
            provenance.tracker().note_cache_hits(keys)

    # -- lifecycle / status ------------------------------------------------

    def close(self) -> None:
        with self._lock:
            batchers, self._batchers = self._batchers, []
        for b in batchers:
            b.close()
        self.partitioner.release_for_tests()

    def status(self) -> Dict[str, Any]:
        flushes, flushed = self._flush_counts()
        return {
            "enabled": True,
            "batch_window_ms": self.window_ms,
            "max_batch": self.max_batch,
            "batches": flushes,
            "batched_queries": flushed,
            "batch_occupancy_p50": self.occupancy.quantile(0.5),
            "batch_occupancy_p99": self.occupancy.quantile(0.99),
            "batch_wait_p99_ms": (
                round(self.batch_wait_ms.quantile(0.99), 3)
                if self.batch_wait_ms.count
                else None
            ),
            "cache": self.cache.status(),
            "admission": self.admission.status(),
            "partitioner": self.partitioner.status(),
        }


# -- process singleton --------------------------------------------------------

_TIER: Optional[ServingTier] = None
_singleton_lock = threading.Lock()


def tier() -> ServingTier:
    global _TIER
    t = _TIER
    if t is None:
        with _singleton_lock:
            t = _TIER
            if t is None:
                t = _TIER = ServingTier()
    return t


def reset_for_tests() -> ServingTier:
    """Fresh tier (re-reads every knob, zero counters) — tests and bench
    arms scope their measurements to one configuration."""
    global _TIER
    with _singleton_lock:
        old, _TIER = _TIER, None
    if old is not None:
        old.close()
    return tier()


def shutdown() -> None:
    """Close the tier without recreating it (run teardown)."""
    global _TIER
    with _singleton_lock:
        old, _TIER = _TIER, None
    if old is not None:
        old.close()


# -- hook-site sugar (one ENABLED read + one None check when idle) ------------


def note_index_add(n: int = 1) -> None:
    """ops/knn.py insert/update hook: bump the cache's global generation
    (a new or re-embedded doc can enter any query's top-k)."""
    t = _TIER
    if t is not None:
        t.cache.note_add(n)


def note_index_remove(key: Any) -> None:
    """ops/knn.py removal hook: bump only the removed key's result
    cluster — cached queries that never returned this key stay warm."""
    t = _TIER
    if t is not None:
        t.cache.note_remove(key)


def serving_metrics():
    """The serving registry for the monitoring server (None when the
    tier never instantiated or serving is disabled)."""
    if not ENABLED or _TIER is None:
        return None
    return _TIER.metrics


def serving_status() -> Dict[str, Any]:
    """The ``"serving"`` key for /status.  Never instantiates the tier —
    a pure-ingest job reports only the gate state."""
    if not ENABLED:
        return {"enabled": False}
    if _TIER is None:
        return {"enabled": True, "active": False}
    out = _TIER.status()
    out["active"] = True
    return out
