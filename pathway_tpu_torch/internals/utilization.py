"""Live device-utilization accounting for the ingest hot path.

MFU existed only as a post-hoc bench computation; this module is the
runtime version: the async device pipeline (internals/device_pipeline.py)
reports every dispatched batch (rows, real/slab tokens, useful FLOPs
from internals/costmodel.py) and every prep/dispatch/wait/drain span
into a process-wide rolling window, and three gauges answer "is the
device fed RIGHT NOW":

  pathway_device_mfu_pct        useful FLOPs over the window's wall
                                time vs the chip's peak (None when the
                                peak is unknown, e.g. CPU CI)
  pathway_device_tokens_per_sec real (mask) tokens/s over the window
  pathway_device_bound_state    one-hot state set: where the window's
                                wall time went

Bound-state rules (documented in ARCHITECTURE.md "Device utilization"),
computed over the window from the dispatcher's span sums — prep runs on
worker threads, dispatch+wait serialize on the dispatcher thread:

  idle            no dispatches in the window
  compute-bound   wait_s / window >= 25% — the dispatcher blocks on the
                  in-flight window, i.e. the device is saturated
  dispatch-bound  else dispatch_s / window >= 25% — the synchronous part
                  of enqueue (host->device transfer, tracing cache
                  misses) dominates
  host-bound      else — the dispatcher sits idle waiting for prepared
                  batches; tokenize/pack can't keep up

Per-dispatch device time is estimated completion-to-completion: batch
i's interval is wait_end(i) - max(wait_end(i-1), dispatch_end(i)).  The
device executes the dispatch chain in-order, so consecutive completion
timestamps bracket its busy time; when a wait returns instantly the
batch had already finished and the interval over-counts the gap — it is
an upper bound between observations, good enough for skew/attribution,
and never used for MFU (MFU is judged on wall time, same as bench.py).

``PATHWAY_DEVICE_UTIL=0`` disables everything; hook sites guard on the
module-global ``ENABLED`` so the disabled cost is one attribute read
(enforced <5% by tests/test_perf_smoke.py, like internals/faults.py).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals.metrics import MetricsRegistry

# Cheap guard read by every hook site (device_pipeline dispatch loop).
ENABLED = os.environ.get("PATHWAY_DEVICE_UTIL", "1") != "0"

# Rolling-window length: long enough to smooth chunked ingest, short
# enough that /status answers about NOW.
WINDOW_S = float(os.environ.get("PATHWAY_UTIL_WINDOW_S", "30") or 30)

# Bound-state thresholds (module constants so tests and ARCHITECTURE.md
# pin the same numbers).
WAIT_BOUND_SHARE = 0.25
DISPATCH_BOUND_SHARE = 0.25

BOUND_STATES = ("idle", "host-bound", "dispatch-bound", "compute-bound")


def classify_bound_state(
    window_s: float,
    prep_s: float,
    dispatch_s: float,
    wait_s: float,
    dispatches: int,
) -> str:
    """Pure classification over a window's span sums (rules above)."""
    if dispatches <= 0 or window_s <= 0:
        return "idle"
    if wait_s / window_s >= WAIT_BOUND_SHARE:
        return "compute-bound"
    if dispatch_s / window_s >= DISPATCH_BOUND_SHARE:
        return "dispatch-bound"
    return "host-bound"


class UtilizationTracker:
    """Process-wide rolling window over dispatched-batch accounting."""

    def __init__(self, window_s: float = WINDOW_S):
        self.window_s = window_s
        self._lock = threading.Lock()
        # (t, rows, real_tokens, slab_tokens, useful_flops)
        self._batches: Deque[Tuple[float, int, int, int, float]] = (
            collections.deque()
        )
        # kind -> deque of (t, duration_s)
        self._spans: Dict[str, Deque[Tuple[float, float]]] = {
            k: collections.deque()
            for k in ("prep", "dispatch", "wait", "drain", "device")
        }

    # -- feeding (device_pipeline hook sites) ------------------------------

    def note_batch(
        self,
        rows: int,
        real_tokens: int,
        slab_tokens: int,
        useful_flops: float,
    ) -> None:
        now = time.monotonic()
        with self._lock:
            self._batches.append(
                (now, int(rows), int(real_tokens), int(slab_tokens),
                 float(useful_flops))
            )
            self._prune(now)

    def note_span(self, kind: str, duration_s: float) -> None:
        dq = self._spans.get(kind)
        if dq is None:
            return
        now = time.monotonic()
        with self._lock:
            dq.append((now, float(duration_s)))
            self._prune(now)

    # -- reading -----------------------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._batches and self._batches[0][0] < horizon:
            self._batches.popleft()
        for dq in self._spans.values():
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def snapshot(self) -> Dict[str, Any]:
        """The window summary the gauges and /status expose.  The window
        denominator is the elapsed time actually covered (first batch to
        now, capped at window_s) so a 2-second-old run isn't judged over
        30 seconds of assumed idleness."""
        from pathway_tpu_torch.internals import costmodel

        now = time.monotonic()
        with self._lock:
            self._prune(now)
            batches = list(self._batches)
            spans = {
                k: sum(d for _, d in dq) for k, dq in self._spans.items()
            }
        dispatches = len(batches)
        if dispatches:
            window = min(self.window_s, max(now - batches[0][0], 1e-9))
        else:
            window = self.window_s
        rows = sum(b[1] for b in batches)
        real = sum(b[2] for b in batches)
        slab = sum(b[3] for b in batches)
        flops = sum(b[4] for b in batches)
        state = classify_bound_state(
            window, spans["prep"], spans["dispatch"], spans["wait"],
            dispatches,
        )
        peak = costmodel.device_peak_flops()
        return {
            "window_s": round(window, 3),
            "dispatches": dispatches,
            "rows": rows,
            "real_tokens": real,
            "slab_tokens": slab,
            "docs_per_sec": rows / window if dispatches else 0.0,
            "tokens_per_sec": real / window if dispatches else 0.0,
            "useful_tflops_per_sec": flops / window / 1e12 if dispatches else 0.0,
            "mfu_pct": (
                100.0 * flops / window / peak
                if dispatches and peak
                else None
            ),
            "pad_waste_ratio": (1.0 - real / slab) if slab else None,
            "bound_state": state,
            "span_seconds": {
                k: round(v, 6) for k, v in spans.items()
            },
            "device_peak_tflops_bf16": (
                round(peak / 1e12, 1) if peak else None
            ),
        }


_TRACKER = UtilizationTracker()


def tracker() -> UtilizationTracker:
    return _TRACKER


def current_bound_state() -> str:
    """Cheap control input for the health controller's backpressure
    loop: just the window's span sums and the classification — none of
    the costmodel/MFU work a full snapshot() pays.  "idle" when the
    accounting is disabled (the controller then never throttles on it)."""
    if not ENABLED:
        return "idle"
    t = _TRACKER
    now = time.monotonic()
    with t._lock:
        t._prune(now)
        batches = t._batches
        dispatches = len(batches)
        window = (
            min(t.window_s, max(now - batches[0][0], 1e-9))
            if dispatches
            else t.window_s
        )
        prep = sum(d for _, d in t._spans["prep"])
        dispatch = sum(d for _, d in t._spans["dispatch"])
        wait = sum(d for _, d in t._spans["wait"])
    return classify_bound_state(window, prep, dispatch, wait, dispatches)


def device_window_seconds() -> float:
    """Total noted device-busy seconds over the rolling window — the
    denominator of the cost ledger's conservation cross-check
    (internals/costledger.py): attributed device-seconds must sum to
    within 5% of this."""
    t = _TRACKER
    now = time.monotonic()
    with t._lock:
        t._prune(now)
        return sum(d for _, d in t._spans["device"])


def reset_window(window_s: float = WINDOW_S) -> UtilizationTracker:
    """Replace the process tracker with a fresh (empty) window — used by
    tests and by bench.py to scope the live-MFU cross-check to exactly
    one measured phase."""
    global _TRACKER
    _TRACKER = UtilizationTracker(window_s)
    return _TRACKER


# -- gauges -------------------------------------------------------------------

# Process-wide like the pipeline gauges: one series set, worker="0".
_REGISTRY = MetricsRegistry(worker="0")


def _gauge(key: str):
    def cb() -> Optional[float]:
        if not ENABLED:
            return None
        snap = _TRACKER.snapshot()
        v = snap.get(key)
        return float(v) if v is not None else None

    return cb


def _bound_state_cb() -> List[Tuple[Tuple[str, ...], float]]:
    if not ENABLED:
        return []
    state = _TRACKER.snapshot()["bound_state"]
    return [((s,), 1.0 if s == state else 0.0) for s in BOUND_STATES]


_REGISTRY.gauge(
    "pathway_device_mfu_pct",
    help="Useful-FLOPs model utilization over the rolling window "
    "(mask tokens only; internals/costmodel.py; absent when the device "
    "peak is unknown)",
    callback=_gauge("mfu_pct"),
)
_REGISTRY.gauge(
    "pathway_device_tokens_per_sec",
    help="Real (mask) tokens/s dispatched over the rolling window",
    callback=_gauge("tokens_per_sec"),
)
_REGISTRY.gauge(
    "pathway_device_bound_state",
    help="Rolling-window bottleneck attribution (one-hot over "
    "idle/host-bound/dispatch-bound/compute-bound; see "
    "internals/utilization.py for the classification rules)",
    labels=("state",),
    callback=_bound_state_cb,
)


def utilization_metrics() -> MetricsRegistry:
    """Registry holding the utilization gauges (scraped by
    PrometheusServer alongside the pipeline/device registries)."""
    return _REGISTRY


def utilization_status() -> Dict[str, Any]:
    """The `"utilization"` key for /status: the rolling-window snapshot
    plus profiler-capture state."""
    from pathway_tpu_torch.internals import profiler

    out: Dict[str, Any] = {"enabled": ENABLED}
    if ENABLED:
        out.update(_TRACKER.snapshot())
    out["profiler"] = profiler.profiler_status()
    return out
