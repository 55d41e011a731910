"""Always-on engine metrics: counters, gauges, log2 latency histograms,
and the flight-recorder ring buffer.

TPU-native rebuild of the reference's operational telemetry (reference:
src/engine/telemetry.rs gauges over a periodic OTLP reader,
src/engine/dataflow/monitoring.rs ProberStats with input/output latency,
src/engine/http_server.rs per-worker Prometheus). The registry is designed
to run unconditionally — observe() is a float add plus one frexp-indexed
array bump, gauges are pull-time callbacks with zero hot-path cost — so
latency *distributions* and backpressure signals exist on every run, not
only when an env var was set before the incident.

Layout: each Engine owns one ``MetricsRegistry`` (worker-labeled);
coordinators own small registries of their own.  ``render_registries``
merges any number of them into a single valid exposition document (one
``# TYPE`` block per metric name, per-registry constant labels applied to
every sample).
"""

from __future__ import annotations

import json
import math
import os
import time as time_mod
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# log2 bucket upper bounds: 2^-20 s (~1 us) .. 2^4 s (16 s); one extra
# implicit +Inf slot.  Powers of two make observe() a frexp, and merged
# histograms from different workers always share boundaries.
_MIN_EXP = -20
_MAX_EXP = 4
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    2.0**e for e in range(_MIN_EXP, _MAX_EXP + 1)
)
_N_BUCKETS = len(BUCKET_BOUNDS)
_frexp = math.frexp


def escape_label_value(value: Any) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote, newline
    (in that order — escaping the escapes first)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(value: str) -> str:
    """HELP-line escaping: backslash and newline only (spec: quotes are
    legal in help text)."""
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v != v:  # NaN
            return "NaN"
        return format(v, ".10g")
    return str(v)


class Counter:
    """Monotonic counter child."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def samples(self, name: str, labels: str) -> Iterable[str]:
        yield f"{name}{labels} {_fmt_value(self.value)}"


class Gauge:
    """Set-based gauge child (callback gauges live on the family)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def samples(self, name: str, labels: str) -> Iterable[str]:
        yield f"{name}{labels} {_fmt_value(self.value)}"


class Histogram:
    """Log2-bucket latency histogram child.

    ``observe`` is the hot path: one float add + frexp + list bump — no
    locks (int/float mutations are atomic under the GIL; readers see a
    monotonic, possibly slightly stale view, which is what Prometheus
    scrapes want)."""

    kind = "histogram"
    __slots__ = ("counts", "sum", "digest")

    def __init__(self) -> None:
        self.counts = [0] * (_N_BUCKETS + 1)  # last slot = +Inf
        self.sum = 0.0
        # companion quantile digest: exposition still renders the log2
        # buckets (stable scrape format), but percentile() answers from
        # the digest so dashboard p50/p99 stop being bucket midpoints
        self.digest = Digest()

    def observe(self, x: float) -> None:
        self.sum += x
        self.digest.observe(x)
        if x > 0.0:
            # frexp: x = m * 2**e with 0.5 <= m < 1, so 2**(e-1) <= x < 2**e
            # and the le=2**e bucket (index e - _MIN_EXP) contains x.
            i = _frexp(x)[1] - _MIN_EXP
            if i < 0:
                i = 0
            elif i > _N_BUCKETS:
                i = _N_BUCKETS
            self.counts[i] += 1
        else:
            self.counts[0] += 1

    @property
    def count(self) -> int:
        return sum(self.counts)

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same fixed boundaries) into this one —
        multi-worker aggregation."""
        cs, os_ = self.counts, other.counts
        for i in range(len(cs)):
            cs[i] += os_[i]
        self.sum += other.sum
        other_digest = getattr(other, "digest", None)
        if other_digest is not None:
            self.digest.merge(other_digest)

    def percentile(self, q: float) -> Optional[float]:
        """Quantile (0..100): digest-backed when observations flowed
        through this process; geometric bucket midpoint as the fallback
        for histograms reconstructed from bare bucket counts."""
        if self.digest.count:
            return self.digest.percentile(q)
        total = sum(self.counts)
        if total == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * total))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if i >= _N_BUCKETS:
                    return BUCKET_BOUNDS[-1]
                hi = BUCKET_BOUNDS[i]
                lo = hi / 2.0
                return math.sqrt(lo * hi)
        return BUCKET_BOUNDS[-1]  # pragma: no cover

    def samples(self, name: str, labels: str) -> Iterable[str]:
        # labels arrives pre-rendered WITHOUT braces ("" or 'a="b",c="d"')
        acc = 0
        for i, bound in enumerate(BUCKET_BOUNDS):
            acc += self.counts[i]
            le = f'le="{_fmt_value(bound)}"'
            lbl = f"{labels},{le}" if labels else le
            yield f"{name}_bucket{{{lbl}}} {acc}"
        acc += self.counts[_N_BUCKETS]
        lbl = f'{labels},le="+Inf"' if labels else 'le="+Inf"'
        yield f"{name}_bucket{{{lbl}}} {acc}"
        braced = f"{{{labels}}}" if labels else ""
        yield f"{name}_sum{braced} {_fmt_value(self.sum)}"
        yield f"{name}_count{braced} {acc}"


class Digest:
    """Mergeable streaming quantile digest (merging t-digest).

    Log2 buckets answer "which power of two" — good enough for node
    latency dashboards, useless for certifying an SLO (a p99 that is
    really a bucket midpoint can be off by ~40%).  This keeps a bounded
    set of (mean, weight) centroids whose size is governed by the k1
    scale function, so tails stay near-exact (clusters near q=0/1 hold
    ~1 sample) while the middle compresses.  Properties the query path
    relies on:

      * ``observe`` is an amortized O(1) list append; compression runs
        every ``_BUF_LIMIT`` samples (one sort of ~buffer+centroids);
      * ``merge`` treats the other digest's centroids as weighted
        samples — merge order changes centroid layout slightly but
        quantiles agree within the accuracy bound (pinned by test);
      * ``to_dict``/``from_dict`` round-trip through JSON so digests
        ship across workers like registries do.
    """

    __slots__ = (
        "compression", "_means", "_weights", "_buf", "_buf_limit",
        "count", "sum", "min", "max",
    )

    # delta for the k1 scale: sized so p999 tail clusters stay at ~1
    # sample on 10k-observation windows (the 1% accuracy pin in
    # tests/test_qtrace.py) — ~1.3k centroids / ~20 KB per digest
    def __init__(self, compression: int = 2048):
        self.compression = compression
        self._means: List[float] = []
        self._weights: List[float] = []
        self._buf: List[float] = []
        # buffer scales with delta so the per-observe amortized compress
        # cost stays flat as compression grows (a compress pass is
        # O(centroids + buffer), and centroids ~ 0.65*delta)
        self._buf_limit = max(512, compression)
        self.count = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self._buf.append(x)
        self.count += 1.0
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._buf) >= self._buf_limit:
            self._compress()

    # Histogram-compatible alias
    add = observe

    def merge(self, other: "Digest") -> None:
        if other.count == 0:
            return
        pts = list(zip(other._means, other._weights))
        pts.extend((v, 1.0) for v in other._buf)
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        self._means.extend(m for m, _ in pts)
        self._weights.extend(w for _, w in pts)
        self._compress()

    def _k(self, q: float) -> float:
        # k1 scale: steep near 0/1 => tail clusters stay tiny
        return (self.compression / (2.0 * math.pi)) * math.asin(
            2.0 * q - 1.0
        )

    def _q_limit(self, k: float) -> float:
        # inverse of _k: the largest q a cluster starting at scale
        # position k-1 may extend to.  Computed once per OUTPUT cluster
        # so the inner compress loop is pure arithmetic (the per-point
        # asin of the textbook formulation dominates compress cost)
        if k >= self.compression / 4.0:  # _k(1.0)
            return 1.0
        return 0.5 * (
            math.sin(k * (2.0 * math.pi) / self.compression) + 1.0
        )

    def _compress(self) -> None:
        pts = sorted(
            list(zip(self._means, self._weights))
            + [(v, 1.0) for v in self._buf]
        )
        self._buf.clear()
        if not pts:
            return
        total = self.count
        means: List[float] = []
        weights: List[float] = []
        cur_m, cur_w = pts[0]
        w_before = 0.0  # weight fully to the left of the current cluster
        q_limit = self._q_limit(self._k(0.0) + 1.0)
        for m, w in pts[1:]:
            q_hi = (w_before + cur_w + w) / total
            if q_hi <= q_limit:  # i.e. _k(q_hi) - k_lo <= 1 (monotonic)
                # weighted-mean fold into the current cluster
                cur_m += (m - cur_m) * (w / (cur_w + w))
                cur_w += w
            else:
                means.append(cur_m)
                weights.append(cur_w)
                w_before += cur_w
                q_limit = self._q_limit(self._k(w_before / total) + 1.0)
                cur_m, cur_w = m, w
        means.append(cur_m)
        weights.append(cur_w)
        self._means = means
        self._weights = weights

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` (0..1); None when empty."""
        if self.count == 0:
            return None
        if self._buf:
            self._compress()
        means, weights = self._means, self._weights
        if len(means) == 1:
            return means[0]
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        # centroid i's mass is centered at cum_before + w_i/2; a
        # weight-1 centroid is an EXACT sample (the k1 scale keeps tail
        # clusters at ~1 sample precisely so p999 doesn't smear) — inside
        # its unit of mass we return its mean instead of interpolating
        cum = 0.0
        prev_c = 0.0
        prev_m = self.min
        prev_w = 0.0
        for m, w in zip(means, weights):
            center = cum + w / 2.0
            if target < center:
                # a singleton at cumulative weight c owns the mass
                # interval (c, c+1]: an exact integer target resolves to
                # order statistic ceil(target), matching the rank
                # convention of Histogram.percentile's bucket fallback
                if prev_w == 1.0 and target <= cum:
                    return prev_m  # still inside the previous singleton
                if w <= 1.0 and target > cum:
                    return m  # inside this singleton's own mass
                span = center - prev_c
                if span <= 0.0:
                    return m
                frac = (target - prev_c) / span
                return prev_m + (m - prev_m) * frac
            prev_c, prev_m, prev_w = center, m, w
            cum += w
        # beyond the last centroid center: interpolate toward max
        if prev_w == 1.0:
            return prev_m if target <= cum else self.max
        span = self.count - prev_c
        if span <= 0.0:
            return self.max
        frac = (target - prev_c) / span
        return min(prev_m + (self.max - prev_m) * frac, self.max)

    def percentile(self, p: float) -> Optional[float]:
        """Histogram-compatible percentile (0..100)."""
        return self.quantile(p / 100.0)

    def to_dict(self) -> Dict[str, Any]:
        if self._buf:
            self._compress()
        return {
            "compression": self.compression,
            "means": [round(m, 9) for m in self._means],
            "weights": list(self._weights),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Digest":
        out = cls(compression=int(d.get("compression", 2048)))
        out._means = [float(m) for m in d.get("means", ())]
        out._weights = [float(w) for w in d.get("weights", ())]
        out.count = float(d.get("count", sum(out._weights)))
        out.sum = float(d.get("sum", 0.0))
        mn, mx = d.get("min"), d.get("max")
        out.min = float(mn) if mn is not None else math.inf
        out.max = float(mx) if mx is not None else -math.inf
        return out


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric + its labeled children (or a pull callback)."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        labelnames: Tuple[str, ...] = (),
        callback: Callable[[], Any] | None = None,
    ):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.callback = callback
        self._children: Dict[tuple, Any] = {}

    def labels(self, *values: Any, **kw: Any) -> Any:
        if kw:
            values = tuple(kw[n] for n in self.labelnames)
        else:
            values = tuple(values)
        child = self._children.get(values)
        if child is None:
            child = self._children[values] = _CHILD_TYPES[self.kind]()
        return child

    # unlabeled conveniences -------------------------------------------------
    def __call__(self):
        return self.labels()

    def inc(self, n: float = 1) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, x: float) -> None:
        self.labels().observe(x)

    # rendering --------------------------------------------------------------
    def _label_str(self, const: Dict[str, Any], values: tuple) -> str:
        parts = [
            f'{k}="{escape_label_value(v)}"' for k, v in const.items()
        ]
        parts.extend(
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self.labelnames, values)
        )
        return ",".join(parts)

    def render_samples(self, const: Dict[str, Any]) -> Iterable[str]:
        if self.callback is not None:
            try:
                got = self.callback()
            except Exception:  # noqa: BLE001 — scrape must never fail a run
                return
            if not self.labelnames:
                got = [((), got)]
            for values, v in got:
                if v is None:
                    continue
                lbl = self._label_str(const, tuple(values))
                braced = f"{{{lbl}}}" if lbl else ""
                yield f"{self.name}{braced} {_fmt_value(v)}"
            return
        for values, child in list(self._children.items()):
            lbl = self._label_str(const, values)
            if self.kind == "histogram":
                yield from child.samples(self.name, lbl)
            else:
                yield from child.samples(self.name, f"{{{lbl}}}" if lbl else "")


class MetricsRegistry:
    """A set of metric families sharing constant labels (e.g. worker id)."""

    def __init__(self, **const_labels: Any):
        self.const_labels: Dict[str, Any] = dict(const_labels)
        self._families: Dict[str, MetricFamily] = {}

    def _family(
        self, name: str, kind: str, help: str, labels, callback
    ) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = MetricFamily(
                name, kind, help, tuple(labels), callback
            )
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} registered as {fam.kind}, requested {kind}"
            )
        return fam

    def counter(self, name, help="", labels=(), callback=None) -> MetricFamily:
        return self._family(name, "counter", help, labels, callback)

    def gauge(self, name, help="", labels=(), callback=None) -> MetricFamily:
        return self._family(name, "gauge", help, labels, callback)

    def histogram(self, name, help="", labels=()) -> MetricFamily:
        return self._family(name, "histogram", help, labels, None)

    def families(self) -> List[MetricFamily]:
        return list(self._families.values())

    def render(self) -> str:
        return render_registries([self])


def render_registries(registries: Iterable["MetricsRegistry"]) -> str:
    """Merge registries into ONE valid exposition document: a single
    ``# HELP``/``# TYPE`` block per metric name (the spec forbids repeats),
    every sample carrying its registry's constant labels."""
    by_name: Dict[str, List[Tuple[MetricsRegistry, MetricFamily]]] = {}
    order: List[str] = []
    seen_regs: List[int] = []
    for reg in registries:
        if reg is None or id(reg) in seen_regs:
            continue
        seen_regs.append(id(reg))
        for fam in reg.families():
            if fam.name not in by_name:
                by_name[fam.name] = []
                order.append(fam.name)
            by_name[fam.name].append((reg, fam))
    lines: List[str] = []
    for name in order:
        entries = by_name[name]
        first = entries[0][1]
        if first.help:
            lines.append(f"# HELP {name} {escape_help(first.help)}")
        lines.append(f"# TYPE {name} {first.kind}")
        for reg, fam in entries:
            if fam.kind != first.kind:
                continue  # kind clash across registries: skip, stay valid
            lines.extend(fam.render_samples(reg.const_labels))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Flight recorder (reference analogue: the reference relies on OTel traces
# for post-mortems; a bounded in-memory ring of recent per-tick events makes
# multi-worker crash dumps self-contained)
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent engine events.

    The hot path appends raw tuples
    ``(perf_t, engine_time, kind, node_idx, name, duration_s, rows,
    errors, seq)`` straight into a deque (one C-level append per event);
    ``tail()`` converts to dicts with wall-clock timestamps only when a
    dump is actually requested.

    ``seq`` is a per-recorder monotonic sequence number and every tail
    entry also carries the worker id, so multi-worker diagnostics merge
    in causal order by (engine_time, seq, worker) — wall clocks skew
    across processes, (epoch, seq) does not (SPMD lockstep)."""

    def __init__(self, capacity: int = 512, worker: int = 0):
        self.events: deque = deque(maxlen=capacity)
        self.worker = worker
        self.seq = 0
        # perf_counter -> epoch offset, sampled once: events stamp the
        # cheap monotonic clock and dumps convert to wall time
        self._epoch = time_mod.time() - time_mod.perf_counter()

    def record(
        self,
        kind: str,
        *,
        time: int = 0,
        node: int = -1,
        name: str = "",
        duration_s: float = 0.0,
        rows: int = 0,
        errors: int = 0,
    ) -> None:
        self.seq = seq = self.seq + 1
        self.events.append(
            (
                time_mod.perf_counter(),
                time,
                kind,
                node,
                name,
                duration_s,
                rows,
                errors,
                seq,
            )
        )

    def tail(self, n: int = 128) -> List[Dict[str, Any]]:
        evs = list(self.events)[-n:]
        epoch = self._epoch
        worker = self.worker
        return [
            {
                "wall": round(t + epoch, 6),
                "time": tm,
                "kind": kind,
                "node": node,
                "name": name,
                "duration_s": round(dur, 6),
                "rows": rows,
                "errors": errs,
                "seq": seq,
                "worker": worker,
            }
            for t, tm, kind, node, name, dur, rows, errs, seq in evs
        ]


# ---------------------------------------------------------------------------
# Engine wiring
# ---------------------------------------------------------------------------


class EngineMetrics:
    """The per-engine metric surface: registry + flight recorder + the
    pre-resolved children the engine loop bumps directly."""

    def __init__(self, engine) -> None:
        from pathway_tpu_torch.internals.tracing import SlowTickWatchdog, TraceStore

        self.engine = engine
        reg = self.registry = MetricsRegistry(worker=str(engine.worker_id))
        self.recorder = FlightRecorder(
            capacity=int(os.environ.get("PATHWAY_FLIGHT_RECORDER_SIZE", 512)),
            worker=engine.worker_id,
        )
        # epoch tracing (sampled span store; see internals/tracing.py)
        self.trace = TraceStore(engine.worker_id)
        # slow-tick stack sampler: only armed when PATHWAY_SLOW_TICK_MS
        # is set — the engine loop None-checks it, so the default cost
        # is a single attribute load per tick
        self.slow_watch = None
        slow_ms = os.environ.get("PATHWAY_SLOW_TICK_MS")
        if slow_ms:
            try:
                threshold = float(slow_ms)
            except ValueError:
                threshold = 0.0
            if threshold > 0:
                self.slow_watch = SlowTickWatchdog(
                    engine, self.recorder, threshold
                )
        self.node_hist = reg.histogram(
            "pathway_node_process_seconds",
            help="per-node process() wall time per tick",
            labels=("node", "name", "type"),
        )
        self.tick_hist = reg.histogram(
            "pathway_tick_seconds",
            help="wall time of one process_time() tick",
        ).labels()
        self.ticks = 0
        self.last_tick_monotonic: float | None = None
        # per-sink freshness: connector runtime stamps ingest wall-time
        # per epoch, SubscribeNode sinks stamp emit wall-time at
        # on_time_end — the difference is end-to-end lag through the graph
        self.sink_freshness = reg.histogram(
            "pathway_sink_freshness_seconds",
            help="ingest->emit lag per sink (epoch end-to-end latency)",
            labels=("sink",),
        )
        self._epoch_ingest: Dict[int, float] = {}
        self._sink_last_ms: Dict[str, float] = {}

        reg.counter(
            "pathway_rows_processed",
            help="total delta rows emitted by all nodes",
            callback=lambda: engine.stats_rows,
        )
        reg.gauge(
            "pathway_engine_time",
            help="current engine logical time",
            callback=lambda: engine.current_time,
        )
        reg.counter(
            "pathway_error_count",
            help="entries in the engine error log",
            callback=lambda: len(engine.error_log),
        )
        reg.counter(
            "pathway_ticks_total",
            help="process_time() calls",
            callback=lambda: self.ticks,
        )
        reg.gauge(
            "pathway_scheduled_backlog",
            help="future engine times currently scheduled (temporal wakeups)",
            callback=lambda: len(engine._scheduled_times),
        )
        reg.gauge(
            "pathway_watermark_lag_seconds",
            help="wall-clock seconds since the engine last advanced a tick",
            callback=self._watermark_lag,
        )
        # per-node path counters (columnar/classic selection) — same data
        # node_path_stats() returns, rendered through the registry so the
        # exposition document has exactly one TYPE block per name
        reg.counter(
            "pathway_node_rows_processed",
            help="rows through path-gated nodes",
            labels=("node", "name", "path"),
            callback=lambda: self._path_counts("rows_processed"),
        )
        reg.counter(
            "pathway_node_batches_processed",
            help="batches through path-gated nodes",
            labels=("node", "name", "path"),
            callback=lambda: self._path_counts("batches_processed"),
        )
        # fault tolerance (engine ints so they work with metrics off)
        reg.counter(
            "pathway_failover_total",
            help="live worker-failover recoveries completed by this worker",
            callback=lambda: getattr(engine, "failover_count", 0),
        )
        reg.counter(
            "pathway_sink_txn_commits_total",
            help="snapshot-aligned transactional sink commits",
            callback=lambda: getattr(engine, "sink_txn_commits", 0),
        )
        # connector runtime (reference: src/connectors/monitoring.rs)
        for metric, key, kind, hlp in (
            ("pathway_connector_rows_read", "rows_read", "counter",
             "rows read from the source so far"),
            ("pathway_connector_pending_rows", "pending", "gauge",
             "rows buffered between reader and engine"),
            ("pathway_connector_read_lag_seconds", "read_lag_s", "gauge",
             "seconds since the source last produced an event"),
            ("pathway_connector_retries", "retries", "counter",
             "reader retry/reconnect attempts"),
            ("pathway_connector_backoff_seconds", "backoff_s", "counter",
             "total seconds the reader spent in retry backoff"),
        ):
            getattr(reg, kind)(
                metric,
                help=hlp,
                labels=("source",),
                callback=self._connector_cb(key),
            )

    def _watermark_lag(self) -> float:
        last = self.last_tick_monotonic
        if last is None:
            return 0.0
        return time_mod.monotonic() - last

    # -- sink freshness ------------------------------------------------------
    def note_ingest(self, time: int, wall: float | None = None) -> None:
        """Record the wall-time (monotonic) a batch for epoch ``time``
        entered the process.  Called by the streaming driver right before
        ``process_time``; static runs never call it, so freshness simply
        stays empty there."""
        ingest = self._epoch_ingest
        ingest[time] = time_mod.monotonic() if wall is None else wall
        if len(ingest) > 1024:
            # bounded: epochs whose sinks never fired (no rows reached
            # them) would otherwise pin entries forever
            for t in sorted(ingest)[:256]:
                del ingest[t]

    def note_sink_emit(
        self, sink: str, time: int, wall: float | None = None
    ) -> None:
        """Record that sink ``sink`` finished emitting epoch ``time`` and
        observe the ingest->emit lag.  No-op when the epoch has no ingest
        stamp (static runs, replayed epochs)."""
        ingest = self._epoch_ingest.get(time)
        if ingest is None:
            return
        now = time_mod.monotonic() if wall is None else wall
        lag = now - ingest
        if lag < 0.0:
            lag = 0.0
        self.sink_freshness.labels(sink).observe(lag)
        self._sink_last_ms[sink] = round(lag * 1000, 4)

    def sink_freshness_stats(self) -> List[Dict[str, Any]]:
        """Per-sink freshness summary (p50/p99 ms) for the dashboard and
        /status."""
        out = []
        for values, child in sorted(self.sink_freshness._children.items()):
            count = child.count
            if not count:
                continue
            p50 = child.percentile(50)
            p99 = child.percentile(99)
            sink = values[0] if values else ""
            out.append(
                {
                    "sink": sink,
                    "count": count,
                    "p50_ms": round(p50 * 1000, 4) if p50 is not None else None,
                    "p99_ms": round(p99 * 1000, 4) if p99 is not None else None,
                    "last_ms": self._sink_last_ms.get(sink),
                }
            )
        return out

    def _path_counts(self, field: str):
        out = []
        for idx, node in enumerate(self.engine.nodes):
            path = getattr(node, "path", None)
            if path is None:
                continue
            out.append(
                ((str(idx), node.name, path), getattr(node, field, 0))
            )
        return out

    def _connector_cb(self, key: str):
        def cb():
            stats = getattr(self.engine, "connector_stats", None) or {}
            return [
                ((name,), cs.get(key)) for name, cs in stats.items()
            ]

        return cb

    # -- node stats ----------------------------------------------------------
    def node_latency_stats(self) -> List[Dict[str, Any]]:
        """Per-node latency summary (p50/p99 from the log2 histograms) for
        the dashboard and the /status endpoint."""
        out = []
        for idx, node in enumerate(self.engine.nodes):
            child = getattr(node, "_lat_child", None)
            if child is None:
                continue
            count = child.count
            p50 = child.percentile(50)
            p99 = child.percentile(99)
            out.append(
                {
                    "node": idx,
                    "name": node.name,
                    "type": type(node).__name__,
                    "calls": count,
                    "total_s": round(child.sum, 6),
                    "p50_ms": round(p50 * 1000, 4) if p50 is not None else None,
                    "p99_ms": round(p99 * 1000, 4) if p99 is not None else None,
                    "rows_out": getattr(node, "_rows_out", 0),
                }
            )
        return out


def dump_diagnostics(engine, *, reason: str = "manual") -> Dict[str, Any]:
    """Structured post-mortem snapshot: graph topology, per-node latency
    stats, the flight-recorder tail, and recent errors.  Stored on
    ``engine.last_diagnostics``; also written as JSON under
    ``PATHWAY_DIAGNOSTICS_DIR`` when that is set."""
    m = getattr(engine, "metrics", None)
    nodes = []
    for idx, node in enumerate(engine.nodes):
        nodes.append(
            {
                "node": idx,
                "name": node.name,
                "type": type(node).__name__,
                "inputs": [
                    getattr(i, "_idx", -1) for i in node.inputs
                ],
                "path": getattr(node, "path", None),
            }
        )
    stats = m.node_latency_stats() if m is not None else []
    by_idx = {s["node"]: s for s in stats}
    for n in nodes:
        n.update(
            {
                k: v
                for k, v in by_idx.get(n["node"], {}).items()
                if k not in ("node", "name", "type")
            }
        )
    diag = {
        "reason": reason,
        "worker": engine.worker_id,
        "worker_count": engine.worker_count,
        "engine_time": engine.current_time,
        "rows_processed": engine.stats_rows,
        "ticks": m.ticks if m is not None else None,
        "errors": [
            {
                "message": e.message,
                "operator": e.operator,
                "time": e.time,
                "trace": str(e.trace) if e.trace is not None else None,
            }
            for e in engine.error_log[-32:]
        ],
        "nodes": nodes,
        "flight_recorder": m.recorder.tail() if m is not None else [],
        "freshness": m.sink_freshness_stats() if m is not None else [],
    }
    engine.last_diagnostics = diag
    dest = os.environ.get("PATHWAY_DIAGNOSTICS_DIR")
    if dest:
        try:
            os.makedirs(dest, exist_ok=True)
            path = os.path.join(
                dest,
                f"pathway_diag_w{engine.worker_id}_p{os.getpid()}.json",
            )
            with open(path, "w") as fh:
                json.dump(diag, fh, indent=1, default=str)
        except OSError:
            pass
    return diag
