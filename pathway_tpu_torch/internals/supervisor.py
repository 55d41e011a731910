"""Worker supervision: keep the job alive when a single worker dies.

Two supervisors, one per execution mode:

- Thread mode (``PATHWAY_THREADS>1``): the respawn logic lives in
  ``runner._run_threaded`` because only the runner holds the worker
  closure; this module supplies the shared restart policy.

- TCP mode (``PATHWAY_PROCESSES>1``): :class:`ProcessSupervisor` wraps a
  worker subprocess, watches it, and respawns it on a restartable exit
  while the surviving processes hold the rejoin window open (see
  ``TcpCoordinator.failover_rendezvous``).  Chaos tests and operator
  wrappers both use it; production launchers (k8s restart policies) are
  equivalent and need nothing from here.

A worker that dies from an injected :class:`~.faults.WorkerKilled` (or
any crash, when ``PATHWAY_FAILOVER=1``) is restartable up to the budget;
a clean exit never is — the exchange layer agrees on termination
collectively before any worker exits, so a zero exit code means the job
is done everywhere.
"""

from __future__ import annotations

import os
import subprocess
import time as time_mod
from typing import Callable, List, Optional, Sequence

# Exit code a worker script uses to signal "killed by fault injection,
# please respawn me" (the chaos scripts catch WorkerKilled and exit with
# this; anything nonzero is restartable under PATHWAY_FAILOVER=1).
WORKER_KILLED_EXIT = 43

# Exit code for a GRACEFUL restart (faults.WorkerRestart — the health
# controller's rolling restart, or the restart_worker directive).  The
# chaos scripts catch WorkerRestart before WorkerKilled and exit with
# this; graceful restarts are always respawned and never consume the
# crash-restart budget — a planned roll must not eat the headroom kept
# for real failures.
WORKER_RESTART_EXIT = 44

DEFAULT_MAX_RESTARTS = 3


class RestartPolicy:
    """Shared restart-budget bookkeeping for both supervisor modes."""

    def __init__(self, max_restarts: int = DEFAULT_MAX_RESTARTS):
        self.max_restarts = max_restarts
        self.restarts = 0
        self.graceful_restarts = 0

    def may_restart(self, *, injected: bool, graceful: bool = False) -> bool:
        """Graceful (rolling) restarts always respawn and never consume
        the budget.  Injected kills are always failover-eligible;
        organic crashes only under PATHWAY_FAILOVER=1 — both consume
        the budget."""
        if graceful:
            return True
        if self.restarts >= self.max_restarts:
            return False
        if injected:
            return True
        return os.environ.get("PATHWAY_FAILOVER") == "1"

    def note_restart(self, *, graceful: bool = False) -> None:
        if graceful:
            self.graceful_restarts += 1
        else:
            self.restarts += 1


class ProcessSupervisor:
    """Spawn-and-respawn wrapper around one TCP-mode worker process.

    ``spawn`` is a zero-arg callable returning a started
    ``subprocess.Popen``; on a restartable exit the supervisor calls it
    again with ``PATHWAY_FAULTS`` scrubbed from the environment override
    (the replacement must not re-trigger the same injected kill).
    """

    def __init__(
        self,
        spawn: Callable[..., subprocess.Popen],
        *,
        max_restarts: int = DEFAULT_MAX_RESTARTS,
        restartable: Optional[Callable[[int], bool]] = None,
        poll_interval_s: float = 0.05,
    ):
        self._spawn = spawn
        self.policy = RestartPolicy(max_restarts)
        self._restartable = restartable or (lambda rc: rc != 0)
        self._poll_interval_s = poll_interval_s
        self.proc: Optional[subprocess.Popen] = None
        self.exit_codes: List[int] = []

    def start(self) -> subprocess.Popen:
        self.proc = self._spawn()
        return self.proc

    def watch(self, timeout_s: float = 120.0) -> int:
        """Run until the worker exits cleanly, the restart budget is
        exhausted, or the deadline passes.  Returns the final exit code
        (raises TimeoutError on deadline)."""
        deadline = time_mod.monotonic() + timeout_s
        if self.proc is None:
            self.start()
        while True:
            rc = self.proc.poll()
            if rc is None:
                if time_mod.monotonic() > deadline:
                    self.proc.kill()
                    raise TimeoutError("supervised worker ran past deadline")
                time_mod.sleep(self._poll_interval_s)
                continue
            self.exit_codes.append(rc)
            if rc == 0 or not self._restartable(rc):
                return rc
            graceful = rc == WORKER_RESTART_EXIT
            injected = graceful or rc == WORKER_KILLED_EXIT
            if not self.policy.may_restart(
                injected=injected, graceful=graceful
            ):
                return rc
            self.policy.note_restart(graceful=graceful)
            self.proc = self._spawn()


def scrubbed_env(env: Optional[dict] = None, keys: Sequence[str] = ("PATHWAY_FAULTS",)) -> dict:
    """A copy of ``env`` (default os.environ) with fault-injection
    variables removed — what a replacement worker should launch with."""
    out = dict(os.environ if env is None else env)
    for k in keys:
        out.pop(k, None)
    return out
