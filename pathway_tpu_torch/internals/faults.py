"""Deterministic fault-injection harness.

Chaos testing needs faults that fire at exactly the same point of the
computation on every run, so the harness keys every directive on logical
coordinates (worker index, engine epoch, call counts) — never wall
clock.  Directives are armed from the ``PATHWAY_FAULTS`` environment
variable (parsed once per run by the streaming driver) or from the
``install()`` API (in-process tests), and fired from a small set of
fixed hook sites:

  - the streaming driver's per-epoch hook   (kill_worker, sever_peer)
  - the persistence backend's write path    (store_fail)
  - the device monitor's probe wrapper      (device_flap)

Every hook site guards on the module-global ``ACTIVE`` flag so the
disabled-by-default cost is one attribute read (enforced <5% by
tests/test_perf_smoke.py).

Spec grammar (';'-separated directives, ','-separated params)::

    PATHWAY_FAULTS="kill_worker@worker=1,epoch=8;store_fail@count=2"

Kinds:

  kill_worker@worker=W,epoch=E
      raise :class:`WorkerKilled` on worker W at the first engine epoch
      >= E (fires once).
  sever_peer@worker=W,peer=P,epoch=E
      on worker W at the first epoch >= E, hard-close the outgoing
      socket to peer P (TCP coordinator only; fires once).
  store_fail@count=N[,match=SUBSTR]
      the next N persistence-backend writes (optionally only keys
      containing SUBSTR) raise :class:`InjectedStoreFailure`.
  device_flap@probes=N
      the next N device-health probes report unhealthy.
  slow_replica@replica=R,factor=F[,count=N]
      the mesh backend's per-replica device-time accounting charges
      replica R F-times its real share — a deterministic straggler for
      the skew detector.  Persistent unless count=N bounds it to the
      next N dispatches.
  mem_pressure@bytes=B,epoch=E[,until=U]
      from the first engine epoch >= E (until epoch U, or forever when
      omitted) the memory forecaster sees B synthetic extra bytes in
      use — deterministic pressure for the health controller's
      backpressure loop without allocating anything.
  restart_worker@worker=W,epoch=E
      graceful injected restart: worker W raises WorkerRestart at the
      first epoch >= E (fires once).  The supervisor layer respawns it
      through the same failover path as kill_worker, but the restart is
      billed as a rolling restart (health action), not a crash.
"""

from __future__ import annotations

import os
import threading
import time as time_mod
from typing import Any, Dict, List, Optional, Tuple

# Cheap guard consulted by every hook site before taking _lock.
ACTIVE = False


class WorkerKilled(Exception):
    """Injected worker death (``kill_worker`` directive).

    Raised out of the worker's run loop; the supervisor layer treats it
    as a restartable crash (thread mode respawns the worker thread, TCP
    mode lets the process die for a ProcessSupervisor to respawn)."""


class WorkerRestart(WorkerKilled):
    """Injected graceful restart (``restart_worker`` directive, or the
    health controller's rolling restart).

    A WorkerKilled subclass so every absorb/respawn path built for
    injected kills handles it unchanged; supervisors that care (restart
    budgets, health accounting) can distinguish the two."""


class InjectedStoreFailure(IOError):
    """Injected persistence-backend write failure (``store_fail``)."""


class _Directive:
    __slots__ = ("kind", "params", "remaining", "fired")

    def __init__(self, kind: str, params: Dict[str, str]):
        self.kind = kind
        self.params = params
        try:
            self.remaining = int(
                params.get("count", params.get("probes", "1"))
            )
        except ValueError:
            self.remaining = 1
        self.fired = False

    def iparam(self, key: str, default: int = 0) -> int:
        try:
            return int(self.params.get(key, default))
        except ValueError:
            return default

    def __repr__(self) -> str:  # diagnostics only
        kv = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.kind}@{kv}"


_lock = threading.Lock()
_directives: List[_Directive] = []

# (kind, detail, monotonic_ts) — bench.py reads the kill timestamp to
# compute failover_recovery_s; tests assert on what actually fired.
events: List[Tuple[str, Dict[str, Any], float]] = []


def _record(kind: str, **detail: Any) -> None:
    events.append((kind, detail, time_mod.monotonic()))


def parse(spec: str) -> List[_Directive]:
    out: List[_Directive] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition("@")
        params: Dict[str, str] = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            params[k.strip()] = v.strip()
        out.append(_Directive(kind.strip(), params))
    return out


def install(spec: Optional[str]) -> None:
    """Arm the harness from a spec string (replaces prior directives).

    ``install(None)`` / ``install("")`` disarms it (same as clear())."""
    global ACTIVE, _mem_pressure_now, _generation
    with _lock:
        _directives.clear()
        events.clear()
        _mem_pressure_now = 0
        _generation += 1
        if spec:
            _directives.extend(parse(spec))
        ACTIVE = bool(_directives)


def install_from_env() -> None:
    """Arm from ``PATHWAY_FAULTS`` if it is set; otherwise leave any
    API-installed directives in place (the driver calls this once per
    run, and in-process tests install() before calling pw.run)."""
    spec = os.environ.get("PATHWAY_FAULTS")
    if spec is not None:
        install(spec)


def clear() -> None:
    install(None)


def on_epoch(worker: int, time: int, coord: Any = None) -> None:
    """Per-epoch hook, called by the streaming driver at the top of each
    flush with the engine's logical coordinates.  Raises WorkerKilled /
    WorkerRestart when a matching directive fires; performs peer
    severing and mem_pressure (de)activation in place."""
    global _mem_pressure_now
    with _lock:
        pressure = 0
        for d in _directives:
            if d.kind == "mem_pressure":
                # pure function of logical time, so every worker's view
                # agrees: active while epoch in [epoch, until)
                if time >= d.iparam("epoch") and (
                    "until" not in d.params or time < d.iparam("until")
                ):
                    pressure += d.iparam("bytes")
                    if not d.fired:
                        d.fired = True
                        _record(
                            "mem_pressure",
                            bytes=d.iparam("bytes"),
                            time=time,
                        )
                elif d.fired and d.remaining > 0 and "until" in d.params:
                    d.remaining = 0  # record the clear exactly once
                    _record("mem_pressure_clear", time=time)
                continue
            if d.fired:
                continue
            if d.kind == "kill_worker":
                if worker == d.iparam("worker") and time >= d.iparam("epoch"):
                    d.fired = True
                    _record("kill_worker", worker=worker, time=time)
                    raise WorkerKilled(
                        f"injected kill: worker {worker} at epoch {time} "
                        f"({d!r})"
                    )
            elif d.kind == "restart_worker":
                if worker == d.iparam("worker") and time >= d.iparam("epoch"):
                    d.fired = True
                    _record("restart_worker", worker=worker, time=time)
                    raise WorkerRestart(
                        f"injected rolling restart: worker {worker} at "
                        f"epoch {time} ({d!r})"
                    )
            elif d.kind == "sever_peer":
                if worker == d.iparam("worker") and time >= d.iparam("epoch"):
                    d.fired = True
                    peer = d.iparam("peer")
                    _record("sever_peer", worker=worker, peer=peer, time=time)
                    sever = getattr(coord, "sever_peer", None)
                    if sever is not None:
                        sever(peer)
        _mem_pressure_now = pressure


def store_put(key: str) -> None:
    """Persistence-backend write hook.  Raises InjectedStoreFailure while
    a matching store_fail directive has budget left."""
    with _lock:
        for d in _directives:
            if d.kind != "store_fail" or d.remaining <= 0:
                continue
            match = d.params.get("match")
            if match and match not in str(key):
                continue
            d.remaining -= 1
            _record("store_fail", key=str(key))
            raise InjectedStoreFailure(
                f"injected store failure on {key!r} ({d!r})"
            )


def replica_factor(replica: int) -> float:
    """Mesh per-replica device-time hook: the multiplier a slow_replica
    directive applies to `replica`'s charged device time (1.0 when none
    matches).  Directives without count= are persistent; with count=N
    the budget decrements once per dispatch."""
    with _lock:
        for d in _directives:
            if d.kind != "slow_replica":
                continue
            if d.iparam("replica", -1) != int(replica):
                continue
            if "count" in d.params:
                if d.remaining <= 0:
                    continue
                d.remaining -= 1
            try:
                factor = float(d.params.get("factor", "4"))
            except ValueError:
                factor = 4.0
            if not d.fired:
                d.fired = True
                _record("slow_replica", replica=int(replica), factor=factor)
            return factor
    return 1.0


# synthetic bytes-in-use injected by active mem_pressure directives;
# updated by on_epoch (logical time owns activation and clearing)
_mem_pressure_now = 0

# bumped by every install()/clear(): a directive set binds to runs that
# START while it is armed.  Drivers capture generation() at startup and
# skip the hook on mismatch — otherwise a long-lived run from before the
# arming (e.g. a never-terminating webserver pipeline on a daemon
# thread) keeps calling on_epoch with ITS frozen logical time,
# overwriting _mem_pressure_now and racing the armed run's directives.
_generation = 0


def generation() -> int:
    """Arming generation: incremented by install()/clear().  A streaming
    driver samples this once at startup; on_epoch ticks from runs with a
    stale generation must be skipped by the caller."""
    with _lock:
        return _generation


def mem_pressure_bytes() -> int:
    """Memory-forecaster hook: synthetic extra bytes-in-use injected by
    the mem_pressure directives active at the last observed epoch."""
    with _lock:
        return _mem_pressure_now


def replica_slowed(replica: int) -> bool:
    """Read-only probe: is a slow_replica directive still armed for
    `replica`?  Unlike :func:`replica_factor` this never consumes count
    budget — the health controller polls it when deciding whether a
    drained replica has recovered enough to re-admit."""
    with _lock:
        for d in _directives:
            if d.kind != "slow_replica":
                continue
            if d.iparam("replica", -1) != int(replica):
                continue
            if "count" in d.params and d.remaining <= 0:
                continue
            return True
    return False


def probe_flap() -> bool:
    """Device-probe hook: True while a device_flap directive has budget
    left (the monitor then reports the device unhealthy)."""
    with _lock:
        for d in _directives:
            if d.kind == "device_flap" and d.remaining > 0:
                d.remaining -= 1
                _record("device_flap", remaining=d.remaining)
                return True
    return False
