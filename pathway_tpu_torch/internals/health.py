"""Self-healing runtime: the closed-loop health controller.

The observability PRs built the sensors — the mesh straggler detector
(internals/mesh_backend.py), the bound-state classifier
(internals/utilization.py), the memory headroom forecaster
(internals/memtrack.py), the device monitor (internals/device_probe.py).
This module closes the loop: a process-wide :class:`HealthController`
subscribes to those gauges from the streaming driver's flush tick and
drives three actuators instead of leaving every degradation to the
all-or-nothing sync fallback:

  replica drain & re-admit
      when the straggler detector flags a dp replica (organically, or
      via the ``slow_replica`` / ``device_flap`` fault directives), the
      controller routes NEW ingest around it (``MeshBackend
      .drain_replica`` — the replica's index shard stays searchable, so
      retrieval remains ranking-exact), barriers the in-flight pipeline
      windows from a one-shot helper thread, and re-admits the replica
      after ``PATHWAY_HEALTH_READMIT_PROBES`` consecutive healthy ticks.

  rolling restart
      ``pathway-tpu restart`` (or GET /restart on the monitoring server)
      enqueues every worker; the controller drains and respawns them ONE
      at a time by raising :class:`~.faults.WorkerRestart` out of the
      target's flush tick — the epoch-fenced failover path built for
      injected kills (supervisor + failover_rendezvous) absorbs it, and
      exactly-once sink commits hold across the roll.  Per-worker
      recovery time is recorded when the respawned worker's next tick
      arrives.

  adaptive backpressure (AIMD)
      when the bound-state classifier reports host- or dispatch-bound,
      the memory forecaster's headroom crosses the warn threshold, or a
      ``mem_pressure`` fault directive is active, the controller halves
      the pipeline queue/in-flight budget
      (``device_pipeline.set_backpressure_scale``), shrinks the driver's
      event-drain budget, and paces connector ingest with a
      Backoff-derived throttle delay.  When pressure clears the budget
      re-expands additively (+0.25 per tick) back to 1.0 — classic AIMD,
      so throughput recovers within one ramp after a pressure episode.

Every action increments ``pathway_health_actions_total{action}`` and
drops a flight-recorder event, so /status's ``"health"`` key shows what
the controller did and why.  Under ``PATHWAY_FAULTS`` the control inputs
are pure functions of logical epochs, so chaos runs are deterministic.

``PATHWAY_HEALTH=0`` disables everything; hook sites guard on the
module-global ``ENABLED`` so the disabled cost is one attribute read
(enforced <5% by tests/test_perf_smoke.py, like faults/utilization).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from pathway_tpu_torch.internals.backoff import Backoff
from pathway_tpu_torch.internals.metrics import FlightRecorder, MetricsRegistry

logger = logging.getLogger("pathway_tpu_torch")

# Cheap guard read by every hook site (driver flush tick, event drain).
ENABLED = os.environ.get("PATHWAY_HEALTH", "1") != "0"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# Consecutive healthy ticks a drained replica must show before re-admit.
READMIT_PROBES = _env_int("PATHWAY_HEALTH_READMIT_PROBES", 3)

# AIMD constants (documented in ARCHITECTURE.md "Self-healing runtime"):
# multiplicative decrease under pressure, additive increase on clear.
BP_DECREASE = _env_float("PATHWAY_HEALTH_BP_DECREASE", 0.5)
BP_INCREASE = _env_float("PATHWAY_HEALTH_BP_INCREASE", 0.25)
BP_MIN_SCALE = _env_float("PATHWAY_HEALTH_BP_MIN_SCALE", 0.125)

# Wall-clock pacing of the (slightly costlier) memory/bound-state reads
# when no fault harness is armed; with faults ACTIVE every tick
# evaluates so chaos runs stay deterministic in logical time.
PRESSURE_CHECK_S = _env_float("PATHWAY_HEALTH_PRESSURE_CHECK_S", 0.2)

_ACTIONS = (
    "drain", "readmit", "restart", "restart_done", "throttle", "relax",
    # serving-tier device-time partitioner transitions (internals/
    # serving.py): priority slots granted to / reclaimed from serving
    "serve_priority", "serve_release",
)


class HealthController:
    """Process-wide state machine over the runtime's health gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry(worker="0")
        self._actions = self.metrics.counter(
            "pathway_health_actions_total",
            help="Health-controller actuations by kind (drain/readmit/"
            "restart/restart_done/throttle/relax; see internals/health.py)",
            labels=("action",),
        )
        self.recorder = FlightRecorder(capacity=128)
        # -- drain / re-admit state -----------------------------------
        # replica -> {"drained_at", "healthy_probes", "reason"}
        self._drained: Dict[int, Dict[str, Any]] = {}
        # -- rolling restart state ------------------------------------
        self._roll_queue: collections.deque = collections.deque()
        # {"worker", "phase": "pending"|"killed", "killed_at"}
        self._roll_current: Optional[Dict[str, Any]] = None
        self._roll_recovery: List[Dict[str, Any]] = []
        self._roll_started: Optional[float] = None
        self._roll_last: Optional[Dict[str, Any]] = None
        # -- backpressure state ---------------------------------------
        self._bp_scale = 1.0
        self._pressure = False
        self._pressure_reason: Optional[str] = None
        self._throttle_s = 0.0
        self._next_pressure_check = 0.0
        # escalating ingest-throttle pacing while pressure holds; reset
        # on clear so each episode starts gentle (seeded: deterministic)
        self._throttle_backoff = Backoff(
            base=0.002, cap=0.05, jitter=0.0, seed=0
        )

    # -- action plumbing ---------------------------------------------------

    def _act(self, action: str, name: str = "", node: int = 0,
             duration_s: float = 0.0) -> None:
        self._actions.labels(action).inc()
        self.recorder.record(
            f"health_{action}", name=name, node=node, duration_s=duration_s
        )

    def action_counts(self) -> Dict[str, int]:
        return {
            a: int(self._actions.labels(a).value) for a in _ACTIONS
        }

    # -- the per-epoch tick ------------------------------------------------

    def on_epoch(self, worker: int, epoch: int, engine: Any = None) -> None:
        """One control-loop tick, called from the streaming driver's
        flush (right after faults.on_epoch, before the coordination
        vote).  May raise WorkerRestart when `worker` is the rolling
        restart's current target — the failover path absorbs it."""
        self._tick_roll(worker, epoch)
        if worker != 0:
            # sensors and actuators are process-wide; one worker ticking
            # them is enough, and keeps multi-worker runs deterministic
            return
        self._tick_drain(epoch)
        self._tick_pressure(epoch)
        self._tick_serving()

    def _tick_serving(self) -> None:
        """Give the serving partitioner a control-loop heartbeat from the
        driver side: during mixed ingest+serve phases the batcher's own
        flush callback already ticks it, but a pure-ingest stretch (no
        queries arriving) still has to RELEASE priority promptly once the
        burn clears — this tick is what does that."""
        from pathway_tpu_torch.internals import serving

        if serving.ENABLED and serving._TIER is not None:
            serving._TIER.partitioner.maybe_tick()

    # -- actuator 1: replica drain & re-admit ------------------------------

    def _tick_drain(self, epoch: int) -> None:
        from pathway_tpu_torch.internals.mesh_backend import active_backend

        backend = active_backend()
        if backend is None:
            if self._drained:
                self._drained.clear()
            return
        straggler = backend.straggler()
        if straggler is not None:
            replica = int(straggler["replica"])
            if replica not in self._drained:
                self._drain_replica(backend, replica, straggler, epoch)
        if self._drained:
            self._tick_readmit(backend, epoch)

    def _drain_replica(self, backend, replica: int, straggler: Dict[str, Any],
                       epoch: int) -> None:
        reason = (
            f"straggler {straggler.get('skew_ratio')}x over "
            f"{straggler.get('streak')} dispatches"
        )
        if not backend.drain_replica(replica, reason=reason):
            return  # already drained, or it is the last active replica
        self._drained[replica] = {
            "drained_at": time.monotonic(),
            "epoch": epoch,
            "healthy_probes": 0,
            "reason": reason,
        }
        self._act("drain", name=reason, node=replica)
        logger.warning(
            "health: draining dp replica %d (%s) — new ingest re-routes "
            "to the surviving replicas; search stays ranking-exact",
            replica, reason,
        )
        # The routing change is already live (dp_shard_of detours).  The
        # replica's in-flight dispatches drain via the pipeline barrier —
        # from a helper thread, because this tick may run on a thread the
        # dispatcher's completion path feeds (barrier here would deadlock
        # a full window).
        threading.Thread(
            target=self._barrier_pipelines,
            args=(replica,),
            name=f"health-drain-{replica}",
            daemon=True,
        ).start()

    def _barrier_pipelines(self, replica: int) -> None:
        from pathway_tpu_torch.internals.device_pipeline import _PIPELINES

        t0 = time.monotonic()
        try:
            for p in list(_PIPELINES):
                p.barrier()
        except Exception as exc:  # noqa: BLE001 — pipeline fallback owns it
            logger.warning(
                "health: pipeline barrier during replica %d drain failed "
                "(%s) — the sync-fallback path will replay", replica, exc,
            )
        info = self._drained.get(replica)
        if info is not None:
            info["drain_barrier_s"] = round(time.monotonic() - t0, 6)
        self.recorder.record(
            "health_drain_complete",
            name=f"replica {replica}",
            node=replica,
            duration_s=time.monotonic() - t0,
        )

    def _tick_readmit(self, backend, epoch: int) -> None:
        from pathway_tpu_torch.internals import device_probe, faults

        straggler = backend.straggler()
        flagged = (
            int(straggler["replica"]) if straggler is not None else None
        )
        for replica, info in list(self._drained.items()):
            healthy = flagged != replica
            if healthy and faults.ACTIVE and faults.replica_slowed(replica):
                healthy = False  # the injected slowdown is still armed
            if healthy and device_probe.device_degraded():
                healthy = False
            if not healthy:
                info["healthy_probes"] = 0
                continue
            info["healthy_probes"] += 1
            if info["healthy_probes"] < READMIT_PROBES:
                continue
            if backend.readmit_replica(replica):
                out_s = time.monotonic() - info["drained_at"]
                self._act(
                    "readmit",
                    name=f"after {info['healthy_probes']} healthy probes",
                    node=replica,
                    duration_s=out_s,
                )
                logger.info(
                    "health: re-admitted dp replica %d after %.3fs "
                    "(%d healthy probes)",
                    replica, out_s, info["healthy_probes"],
                )
            del self._drained[replica]

    # -- actuator 2: rolling restart ---------------------------------------

    def request_rolling_restart(
        self, workers: Sequence[int]
    ) -> Dict[str, Any]:
        """Queue a one-at-a-time drain-and-respawn of `workers`.  Raises
        RuntimeError when a roll is already in progress (rolls do not
        overlap — that would violate one-at-a-time)."""
        with self._lock:
            if self._roll_current is not None or self._roll_queue:
                raise RuntimeError(
                    "a rolling restart is already in progress"
                )
            workers = [int(w) for w in workers]
            if not workers:
                raise RuntimeError("no workers to restart")
            self._roll_queue.extend(workers)
            self._roll_recovery = []
            self._roll_started = time.monotonic()
            self._roll_current = {
                "worker": self._roll_queue.popleft(),
                "phase": "pending",
                "killed_at": None,
            }
        self.recorder.record(
            "health_roll_requested",
            name=f"workers {workers}",
            rows=len(workers),
        )
        return self.rolling_restart_status()

    def _tick_roll(self, worker: int, epoch: int) -> None:
        from pathway_tpu_torch.internals.faults import WorkerRestart

        if self._roll_current is None:
            return  # lock-free fast path; requests are rare and the
            # next tick observes them under the lock
        with self._lock:
            cur = self._roll_current
            if cur is None or worker != cur["worker"]:
                return
            if cur["phase"] == "pending":
                cur["phase"] = "killed"
                cur["killed_at"] = time.monotonic()
                target = cur["worker"]
            else:
                # the respawned worker's first tick: recovery complete
                recovery_s = time.monotonic() - cur["killed_at"]
                self._roll_recovery.append(
                    {"worker": cur["worker"],
                     "recovery_s": round(recovery_s, 3)}
                )
                self._act(
                    "restart_done",
                    name=f"worker {cur['worker']}",
                    node=cur["worker"],
                    duration_s=recovery_s,
                )
                if self._roll_queue:
                    self._roll_current = {
                        "worker": self._roll_queue.popleft(),
                        "phase": "pending",
                        "killed_at": None,
                    }
                else:
                    total = time.monotonic() - (
                        self._roll_started or cur["killed_at"]
                    )
                    self._roll_last = {
                        "workers": [r["worker"] for r in self._roll_recovery],
                        "recovery": list(self._roll_recovery),
                        "total_s": round(total, 3),
                        "max_recovery_s": max(
                            r["recovery_s"] for r in self._roll_recovery
                        ),
                    }
                    self._roll_current = None
                    self.recorder.record(
                        "health_roll_complete",
                        name=f"{len(self._roll_recovery)} workers",
                        duration_s=total,
                    )
                return
        # raise OUTSIDE the lock: the exception unwinds the worker's run
        # loop and the failover path must be able to tick this controller
        self._act("restart", name=f"worker {target} at epoch {epoch}",
                  node=target)
        raise WorkerRestart(
            f"rolling restart: worker {target} at epoch {epoch}"
        )

    def rolling_restart_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "in_progress": self._roll_current is not None,
                "current": dict(self._roll_current)
                if self._roll_current
                else None,
                "queued": list(self._roll_queue),
                "recovery": list(self._roll_recovery),
                "last": dict(self._roll_last) if self._roll_last else None,
            }

    # -- actuator 3: adaptive backpressure ---------------------------------

    def _tick_pressure(self, epoch: int) -> None:
        from pathway_tpu_torch.internals import faults

        now = time.monotonic()
        if not faults.ACTIVE and now < self._next_pressure_check:
            return  # pace the wall-clock sensors; chaos evaluates every tick
        self._next_pressure_check = now + PRESSURE_CHECK_S
        reason = self._pressure_reason_now(faults)
        if reason is not None:
            self._on_pressure(reason)
        elif self._bp_scale < 1.0 or self._pressure:
            self._on_pressure_clear()

    def _pressure_reason_now(self, faults) -> Optional[str]:
        if faults.ACTIVE:
            # determinism contract: an armed harness PINS the sensors —
            # only injected pressure counts, the wall-clock gauges
            # (headroom, bound state) are ignored so a chaos run's
            # actions depend on its directives alone
            if faults.mem_pressure_bytes() > 0:
                return (
                    f"injected mem_pressure "
                    f"({faults.mem_pressure_bytes()}B)"
                )
            return None
        from pathway_tpu_torch.internals import memtrack, utilization

        pct = memtrack.headroom_pct()
        if pct is not None and pct < memtrack.HEADROOM_WARN_PCT:
            return f"hbm headroom {pct:.1f}% < {memtrack.HEADROOM_WARN_PCT}%"
        state = utilization.current_bound_state()
        if state in ("host-bound", "dispatch-bound"):
            return f"bound_state={state}"
        return None

    def _on_pressure(self, reason: str) -> None:
        from pathway_tpu_torch.internals import device_pipeline

        first = not self._pressure
        self._pressure = True
        self._pressure_reason = reason
        new_scale = max(BP_MIN_SCALE, self._bp_scale * BP_DECREASE)
        if new_scale < self._bp_scale or first:
            self._bp_scale = device_pipeline.set_backpressure_scale(
                max(new_scale, BP_MIN_SCALE)
            )
            self._act("throttle", name=reason)
            logger.warning(
                "health: backpressure engaged (%s) — pipeline budget "
                "scaled to %.3f", reason, self._bp_scale,
            )
        # escalate the ingest throttle while pressure holds
        self._throttle_s = self._throttle_backoff.next_delay()

    def _on_pressure_clear(self) -> None:
        from pathway_tpu_torch.internals import device_pipeline

        was_pressure = self._pressure
        self._pressure = False
        self._throttle_s = 0.0
        self._throttle_backoff.reset()
        if self._bp_scale < 1.0:
            self._bp_scale = device_pipeline.set_backpressure_scale(
                min(1.0, self._bp_scale + BP_INCREASE)
            )
            if self._bp_scale >= 1.0:
                self._act(
                    "relax",
                    name=self._pressure_reason or "pressure cleared",
                )
                logger.info(
                    "health: backpressure released — pipeline budget "
                    "restored"
                )
                self._pressure_reason = None
        elif was_pressure:
            self._pressure_reason = None

    def throttle_delay(self) -> float:
        """Seconds the ingest driver should sleep this tick (0.0 when no
        pressure) — one attribute read on the hot path."""
        return self._throttle_s

    def ingest_budget(self, default: int) -> int:
        """The driver's per-tick event-drain bound, scaled down with the
        backpressure scale (floor 256 so ingest never stalls outright)."""
        if self._bp_scale >= 1.0:
            return default
        return max(256, int(default * self._bp_scale))

    # -- /status -----------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "backpressure_scale": self._bp_scale,
            "pressure": self._pressure,
            "pressure_reason": self._pressure_reason,
            "throttle_delay_s": round(self._throttle_s, 6),
            "readmit_probes_required": READMIT_PROBES,
            "drained_replicas": {
                str(r): {
                    "reason": info["reason"],
                    "healthy_probes": info["healthy_probes"],
                    "drained_for_s": round(
                        time.monotonic() - info["drained_at"], 3
                    ),
                    "drain_barrier_s": info.get("drain_barrier_s"),
                }
                for r, info in sorted(self._drained.items())
            },
            "rolling_restart": self.rolling_restart_status(),
            "actions": self.action_counts(),
            "recent_events": self.recorder.tail(16),
        }

    # -- run lifecycle ------------------------------------------------------

    def on_run_start(self) -> None:
        """Reset transient per-run state (runner.run calls this before
        workers start).  Action counters and the flight recorder are
        cumulative — operators read them across runs."""
        from pathway_tpu_torch.internals import device_pipeline

        with self._lock:
            self._drained.clear()
            self._pressure = False
            self._pressure_reason = None
            self._throttle_s = 0.0
            self._throttle_backoff.reset()
            self._next_pressure_check = 0.0
            if self._bp_scale < 1.0:
                self._bp_scale = device_pipeline.set_backpressure_scale(1.0)

    def on_run_end(self) -> None:
        """Release any held backpressure so one run's throttle never
        leaks into the next (runner.run's finally)."""
        from pathway_tpu_torch.internals import device_pipeline

        with self._lock:
            if self._bp_scale < 1.0:
                self._bp_scale = device_pipeline.set_backpressure_scale(1.0)
            self._throttle_s = 0.0
            self._pressure = False


# -- process singleton --------------------------------------------------------

_CONTROLLER: Optional[HealthController] = None
_singleton_lock = threading.Lock()


def controller() -> HealthController:
    global _CONTROLLER
    c = _CONTROLLER
    if c is None:
        with _singleton_lock:
            c = _CONTROLLER
            if c is None:
                c = _CONTROLLER = HealthController()
    return c


def reset_for_tests() -> HealthController:
    """Fresh controller (zero counters, empty state) — tests scope the
    action log to exactly one scenario."""
    global _CONTROLLER
    with _singleton_lock:
        _CONTROLLER = HealthController()
    return _CONTROLLER


def on_epoch(worker: int, epoch: int, engine: Any = None) -> None:
    """Hook-site sugar: the driver calls ``health.on_epoch(...)`` behind
    an ``if health.ENABLED`` guard (one attribute read when disabled)."""
    controller().on_epoch(worker, epoch, engine)


def health_metrics() -> Optional[MetricsRegistry]:
    """The action-counter registry for the monitoring server (None when
    the controller never instantiated or is disabled)."""
    if not ENABLED or _CONTROLLER is None:
        return None
    return _CONTROLLER.metrics


def health_status() -> Dict[str, Any]:
    """The `"health"` key for /status."""
    if not ENABLED:
        return {"enabled": False}
    return controller().status()
