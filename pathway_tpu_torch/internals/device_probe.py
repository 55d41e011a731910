"""Accelerator health probe (counterpart of
pathway_tpu/internals/device_probe.py).

The probe runs a small torch matmul on the CUDA card in a SUBPROCESS with
a hard timeout (a wedged device can hang even a trivial launch, and an
in-process hang cannot be interrupted), and the ``DeviceMonitor`` repeats
it on a period, exporting

  pathway_device_rtt_ms   gauge — round trip of one tiny matmul + sync
  pathway_device_healthy  gauge — 1 healthy / 0 down

plus a ``"device"`` key in the /status JSON.  A process with no CUDA card
fails the probe: it reports the error and never falls back to the CPU.

Config: ``PATHWAY_DEVICE_PROBE=0`` disables the monitor entirely;
``PATHWAY_DEVICE_PROBE_INTERVAL_S`` sets the period (default 300 s —
the probe spawns a Python subprocess, so it must stay rare).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time as time_mod
from typing import Any, Dict, Optional, Tuple

# run once, then time a SECOND launch: the first pays for the CUDA context
# and the cuBLAS handle, which is not the round trip we are after
_PROBE_CODE = (
    "import time, torch;"
    "x = torch.ones((64, 64), device='cuda');"
    "(x @ x).sum();"
    "torch.cuda.synchronize();"
    "t0 = time.perf_counter();"
    "(x @ x).sum();"
    "torch.cuda.synchronize();"
    "print((time.perf_counter()-t0)*1000.0)"
)


def device_probe(
    timeout_s: float = 120.0,
) -> Tuple[Optional[float], Optional[str]]:
    """One subprocess probe.  Returns ``(rtt_ms, None)`` when healthy,
    ``(None, error_string)`` when the device is unusable."""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            capture_output=True,
            timeout=timeout_s,
            text=True,
        )
        if proc.returncode != 0:
            return None, f"device probe failed: {proc.stderr[-300:]}"
        try:
            rtt = float(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            rtt = None
        return rtt, None
    except subprocess.TimeoutExpired:
        return None, f"device probe hung for {timeout_s}s"


def device_healthy(timeout_s: float = 120.0) -> Optional[str]:
    """bench.py-compatible wrapper: error string when the device is
    unusable, None when healthy."""
    _rtt, err = device_probe(timeout_s)
    return err


class DeviceMonitor:
    """Periodic device-health prober with its own metrics registry.

    The registry uses pull-time callback gauges over ``self.last``, so a
    scrape never triggers a probe — the daemon thread owns the cadence.
    ``probe`` is injectable for tests (the default spawns a subprocess)."""

    def __init__(
        self,
        *,
        interval_s: float | None = None,
        timeout_s: float = 120.0,
        probe=device_probe,
    ):
        from pathway_tpu_torch.internals.metrics import MetricsRegistry

        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get("PATHWAY_DEVICE_PROBE_INTERVAL_S", 300)
                )
            except ValueError:
                interval_s = 300.0
        self.interval_s = max(1.0, interval_s)
        self.timeout_s = timeout_s
        self.probe = probe
        self.last: Dict[str, Any] = {"status": "not_started"}
        # degradation state machine: HEALTHY <-> DEGRADED.  A failed (or
        # fault-injected) probe flips to DEGRADED — device-phase work
        # routes to the host path (see stdlib/indexing) — and the monitor
        # re-probes on a capped exponential backoff instead of the slow
        # steady-state period, so re-promotion is prompt after a blip but
        # a hard outage doesn't burn a subprocess per second.
        from pathway_tpu_torch.internals.backoff import Backoff

        self.state = "healthy"  # optimistic until a probe says otherwise
        self.flaps = 0  # healthy->degraded transitions
        self.promotions = 0  # degraded->healthy transitions
        self.degraded_since: Optional[float] = None
        self._reprobe = Backoff(
            base=1.0, cap=self.interval_s, jitter=0.25, seed=0
        )
        reg = self.metrics = MetricsRegistry()
        reg.gauge(
            "pathway_device_degraded",
            help="1 while device-phase work is routed to the host path "
            "(probe failed or fault-injected flap), 0 when healthy",
            callback=lambda: 1 if self.state == "degraded" else 0,
        )
        reg.gauge(
            "pathway_device_rtt_ms",
            help="round-trip of one tiny jit dispatch on the accelerator "
            "(subprocess probe; absent until the first probe completes)",
            callback=lambda: self.last.get("rtt_ms"),
        )
        reg.gauge(
            "pathway_device_healthy",
            help="1 when the last device probe succeeded, 0 when it "
            "failed or hung",
            callback=lambda: (
                None
                if "healthy" not in self.last
                else (1 if self.last["healthy"] else 0)
            ),
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe_once(self) -> Dict[str, Any]:
        from pathway_tpu_torch.internals import faults

        if faults.ACTIVE and faults.probe_flap():
            rtt, err = None, "injected device flap (PATHWAY_FAULTS)"
        else:
            rtt, err = self.probe(self.timeout_s)
        self._transition(err is None)
        self.last = {
            "status": "healthy" if err is None else "down",
            "healthy": err is None,
            "state": self.state,
            "rtt_ms": round(rtt, 3) if rtt is not None else None,
            "error": err,
            "checked_at": time_mod.time(),
            "flaps": self.flaps,
            "promotions": self.promotions,
            "degraded_since": self.degraded_since,
        }
        return self.last

    def _transition(self, healthy: bool) -> None:
        if healthy:
            if self.state == "degraded":
                self.promotions += 1
            self.state = "healthy"
            self.degraded_since = None
            self._reprobe.reset()
        else:
            if self.state != "degraded":
                self.flaps += 1
                self.degraded_since = time_mod.time()
            self.state = "degraded"

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pw-device-probe"
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                self.probe_once()
            except Exception as exc:  # noqa: BLE001 — monitor must survive
                self._transition(False)
                self.last = {"status": "down", "healthy": False,
                             "state": self.state,
                             "error": f"{type(exc).__name__}: {exc}"}
            # degraded: re-probe on capped exponential backoff so
            # re-promotion doesn't wait out the steady-state period
            if self.state == "degraded":
                delay = min(self._reprobe.next_delay(), self.interval_s)
            else:
                delay = self.interval_s
            if self._stop.wait(delay):
                return

    def stop(self) -> None:
        self._stop.set()


# one monitor per process, however many PrometheusServers start
_monitor: Optional[DeviceMonitor] = None
_monitor_lock = threading.Lock()


def ensure_monitor() -> Optional[DeviceMonitor]:
    """Start (once) and return the process-wide device monitor; None when
    PATHWAY_DEVICE_PROBE=0."""
    global _monitor
    if os.environ.get("PATHWAY_DEVICE_PROBE") == "0":
        return None
    with _monitor_lock:
        if _monitor is None:
            _monitor = DeviceMonitor()
            _monitor.start()
        return _monitor


def device_status() -> Dict[str, Any]:
    """The ``"device"`` key for /status."""
    if os.environ.get("PATHWAY_DEVICE_PROBE") == "0":
        return {"status": "disabled"}
    if _monitor is None:
        return {"status": "not_started"}
    out = dict(_monitor.last)
    # roofline context for the utilization gauges — only when this process
    # already has a CUDA context (this module otherwise probes via a
    # SUBPROCESS exactly so a wedged device can't hang /status)
    import sys as _sys

    torch = _sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        from pathway_tpu_torch.internals import costmodel, memtrack

        peak = costmodel.device_peak_flops()
        if peak:
            out["peak_tflops_bf16"] = round(peak / 1e12, 1)
        # device memory: the CUDA allocator's own numbers (a process
        # without a CUDA context reports None, the contract every consumer
        # expects — never a guess)
        stats = memtrack.device_memory_stats()
        out["memory_total_bytes"] = (
            stats.get("bytes_limit") if stats else None
        )
        out["memory_available_bytes"] = (
            stats["bytes_limit"] - stats["bytes_in_use"]
            if stats and "bytes_limit" in stats and "bytes_in_use" in stats
            else None
        )
    return out


def device_degraded() -> bool:
    """Hot-path gate for host-path fallback: True while the monitor holds
    the device DEGRADED.  One global read + one attribute read when no
    monitor is running, so device-phase consumers can consult it per
    dispatch batch."""
    m = _monitor
    return m is not None and m.state == "degraded"
