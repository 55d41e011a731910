"""Runtime dataflow invariant checking — ``PATHWAY_SANITIZE=1``.

The runtime twin of the PWT9xx purity pass (analysis/purity.py), in the
planned-vs-real discipline of PWT399/599/699: the static side proves
properties of user code, this module checks the engine's own consistency
invariants while the job runs, and the PWT999 parity gate ties the two
together (a callable certified deterministic must never trip the replay
hash).

Checks (cheap enough to keep armed in CI chaos runs):

  * ``multiset``     — per-key multiset non-negativity every time a
                       TableState applies a retraction batch
                       (engine/stream.py gates on ``sanitizer.ACTIVE``).
  * ``frontier``     — engine logical time is monotone at every tick
                       (engine/engine.py process_time) and per exchange
                       channel (engine/exchange.py); a failover rollback
                       legitimately rewinds it and announces itself via
                       ``on_rollback``.
  * ``routing``      — every key-routed delta received on an exchange
                       satisfies ``key.shard % worker_count == worker``
                       (the runtime twin of the PWT404 lint).
  * ``replay_hash``  — UDF outputs on snapshot-covered paths accumulate
                       into an order-independent hash that is written
                       into the operator-snapshot manifest; after a
                       failover rollback the replayed recomputation must
                       land on the exact pre-crash hash once the same
                       number of rows has passed — a divergence raises
                       ``SanitizerError`` naming the UDF.

Disabled (the default) every hook site is one module attribute read,
like faults/qtrace/costledger.  Arm with ``PATHWAY_SANITIZE=1`` (read
once per run by internals/runner.run) or ``sanitizer.install()`` in
tests.  Surfaces: the ``"sanitizer"`` /status key, the
``pathway_sanitizer_checks_total`` / ``pathway_sanitizer_violations_total``
metric families, and ``sanitizer`` flight-recorder events.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

ACTIVE = False
_TRACKER: Optional["SanitizerTracker"] = None

_MASK = (1 << 64) - 1
_MAX_VIOLATIONS = 64


class SanitizerError(RuntimeError):
    """A dataflow consistency invariant was violated at runtime."""


def install(enable: bool = True) -> None:
    """Arm (or disarm) the sanitizer for this process."""
    global ACTIVE, _TRACKER
    ACTIVE = bool(enable)
    if ACTIVE and _TRACKER is None:
        _TRACKER = SanitizerTracker()


def install_from_env() -> None:
    """Arm once per run from PATHWAY_SANITIZE (runner.run calls this
    next to faults.install_from_env — arming must precede node build so
    UDF programs compile with the hashing wrapper)."""
    if os.environ.get("PATHWAY_SANITIZE", "0") == "1":
        install(True)


def clear() -> None:
    """Disarm and drop all state (tests)."""
    global ACTIVE, _TRACKER
    ACTIVE = False
    _TRACKER = None


def tracker() -> "SanitizerTracker":
    global _TRACKER
    if _TRACKER is None:
        _TRACKER = SanitizerTracker()
    return _TRACKER


def _stable_hash(value: Any) -> int:
    """Best-effort per-row hash: builtin hash when hashable (comparisons
    only ever happen within one process, so per-process str salting is
    fine), ndarray bytes, repr as the last resort."""
    try:
        return hash(value) & _MASK
    except TypeError:
        pass
    tobytes = getattr(value, "tobytes", None)
    if tobytes is not None:
        try:
            return hash(tobytes()) & _MASK
        except Exception:  # noqa: BLE001
            pass
    return hash(repr(value)) & _MASK


class SanitizerTracker:
    """Process-wide check/violation ledger.

    Shared counters sit behind one lock (violations are rare, check
    counting is one locked int add per *batch*, not per row).  The UDF
    replay-hash accumulators are thread-local: each worker thread owns
    its engine, its snapshot manager and its UDF executions, so the
    accumulator that feeds a worker's manifest and the accumulator its
    replay is checked against are the same object without any locking.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.checks: Dict[str, int] = {}
        self.violation_counts: Dict[str, int] = {}
        self.violations: List[Dict[str, Any]] = []
        # replay hashing is armed only when operator snapshots are on
        # (no snapshot => nothing ever replays against the hash)
        self.hashing = False
        # names verify_purity certified deterministic (PWT999 contract)
        self._certified: frozenset = frozenset()
        self._tls = threading.local()
        self._metrics = None

    # -- shared bookkeeping ------------------------------------------------

    def note_check(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self.checks[kind] = self.checks.get(kind, 0) + n

    def violation(
        self,
        kind: str,
        message: str,
        *,
        engine: Any = None,
        **detail: Any,
    ) -> Dict[str, Any]:
        entry = {"kind": kind, "message": message}
        entry.update(detail)
        if engine is not None:
            entry.setdefault("worker", getattr(engine, "worker_id", None))
            entry.setdefault("time", getattr(engine, "current_time", None))
        with self._lock:
            self.violation_counts[kind] = (
                self.violation_counts.get(kind, 0) + 1
            )
            self.violations.append(entry)
            del self.violations[:-_MAX_VIOLATIONS]
        if engine is not None:
            m = getattr(engine, "metrics", None)
            if m is not None:
                m.recorder.record(
                    "sanitizer",
                    time=getattr(engine, "current_time", 0) or 0,
                    name=f"{kind}: {message[:140]}",
                    errors=1,
                )
        return entry

    def recent_violations(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self.violations]

    def certify(self, names) -> None:
        self._certified = frozenset(names)

    # -- frontier monotonicity --------------------------------------------

    # frontier state lives ON the engine (not a worker-id-keyed dict):
    # a failover spawns a replacement engine on the SAME worker id, and a
    # process runs many engines across tests/runs — per-engine attributes
    # can never read another engine's high-water mark as a rewind.

    def on_tick(self, engine: Any, time: int) -> None:
        self.note_check("frontier")
        last = getattr(engine, "_san_frontier", None)
        if last is not None and time < last:
            self.violation(
                "frontier",
                f"engine time rewound {last} -> {time} on worker "
                f"{engine.worker_id} without a rollback",
                engine=engine,
            )
        engine._san_frontier = time

    def on_rollback(self, engine: Any) -> None:
        """Failover rollback: the time rewind about to happen is
        legitimate, and the thread's pre-crash UDF accumulator becomes
        the replay target (see on_restore)."""
        engine._san_frontier = None
        engine._san_chan_frontier = {}

    # -- exchange routing invariant ---------------------------------------

    def on_exchange(
        self, node: Any, time: int, received: list
    ) -> None:
        engine = node.engine
        w = engine.worker_id
        chan = node.channel
        self.note_check("frontier")
        chans = getattr(engine, "_san_chan_frontier", None)
        if chans is None:
            chans = engine._san_chan_frontier = {}
        last = chans.get(chan)
        if last is not None and time < last:
            self.violation(
                "frontier",
                f"exchange channel {chan} time rewound {last} -> {time} "
                f"on worker {w}",
                engine=engine,
            )
        chans[chan] = time
        route = getattr(node, "route_fn", None)
        if route is None or getattr(route, "kind", None) != "key":
            return
        n = engine.worker_count
        if n <= 1 or not received:
            return
        self.note_check("routing", len(received))
        for k, _values, _diff in received:
            if k.shard % n != w:
                self.violation(
                    "routing",
                    f"exchange channel {chan} delivered key with shard "
                    f"{k.shard} to worker {w} of {n} "
                    f"(owner {k.shard % n})",
                    engine=engine,
                    channel=chan,
                )
                raise SanitizerError(
                    f"sanitizer: exchange routing invariant violated on "
                    f"channel {chan}: shard {k.shard} % {n} != worker {w}"
                )

    # -- multiset non-negativity ------------------------------------------

    def note_multiset(self, n: int = 1) -> None:
        self.note_check("multiset", n)

    def multiset_violation(self, source: str, key: Any) -> None:
        self.violation(
            "multiset",
            f"{source or 'table'}: retraction of absent key {key!r} "
            "(per-key multiplicity went negative)",
        )

    # -- replay-divergence hashing ----------------------------------------

    def enable_replay_hashing(self) -> None:
        self.hashing = True

    def _acc(self) -> Dict[str, list]:
        acc = getattr(self._tls, "udf", None)
        if acc is None:
            acc = self._tls.udf = {}
            self._tls.pending = {}
        return acc

    def note_udf_batch(self, name: str, keys: list, values: list) -> None:
        """Fold one UDF batch into this thread's accumulator; when a
        post-rollback replay target is pending for `name`, compare as
        soon as the row count lands on the pre-crash value."""
        acc = self._acc()
        entry = acc.get(name)
        if entry is None:
            entry = acc[name] = [0, 0]
        h = 0
        for k, v in zip(keys, values):
            h = (h + _stable_hash(k) * 3 + _stable_hash(v)) & _MASK
        entry[0] += len(keys)
        entry[1] = (entry[1] + h) & _MASK
        pending = self._tls.pending
        target = pending.get(name)
        if target is None:
            return
        t_rows, t_hash = target
        if entry[0] < t_rows:
            return
        del pending[name]
        self.note_check("replay_hash")
        if entry[0] > t_rows:
            # consolidation changed the replayed batch shape; the hash
            # cannot be aligned — count it, do not guess
            self.note_check("replay_hash_unaligned")
            return
        if entry[1] != t_hash:
            certified = name in self._certified
            msg = (
                f"replay of UDF {name!r} diverged from its pre-failover "
                f"outputs after {t_rows} row(s): the UDF is not "
                "deterministic, so snapshot+replay failover cannot "
                "reproduce its results"
            )
            if certified:
                msg += (
                    " — PWT999 parity violation: static purity analysis "
                    "certified this callable deterministic"
                )
            self.violation(
                "replay_hash", msg, udf=name, certified=certified,
                rows=t_rows,
            )
            raise SanitizerError("sanitizer: " + msg)

    def hashes_for_manifest(self) -> Dict[str, list]:
        """This thread's accumulator, for the operator-snapshot
        manifest (persistence/__init__.py save)."""
        return {k: list(v) for k, v in self._acc().items()}

    def on_restore(self, manifest: Optional[dict]) -> None:
        """Operator snapshot restored on this thread.  The accumulator
        rewinds to the manifest's values; whatever this thread had
        accumulated beyond them (the pre-crash tail that is about to be
        replayed) becomes the replay target per UDF."""
        if not self.hashing:
            return
        saved = (manifest or {}).get("udf_hashes") or {}
        acc = self._acc()
        pending = {}
        for name, entry in acc.items():
            base = saved.get(name) or [0, 0]
            if entry[0] > base[0]:
                pending[name] = (entry[0], entry[1])
        self._tls.udf = {
            name: list(v) for name, v in saved.items()
        }
        self._tls.pending = pending

    # -- surfaces ----------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "hashing": self.hashing,
                "checks": dict(sorted(self.checks.items())),
                "violations": dict(sorted(self.violation_counts.items())),
                "recent": [dict(v) for v in self.violations[-8:]],
                "certified_udfs": sorted(self._certified),
            }

    def metrics(self):
        if self._metrics is None:
            from pathway_tpu_torch.internals.metrics import MetricsRegistry

            reg = MetricsRegistry()
            reg.counter(
                "pathway_sanitizer_checks_total",
                help="dataflow invariant checks performed, by check",
                labels=("check",),
                callback=lambda: [
                    ((k,), v) for k, v in sorted(self.checks.items())
                ],
            )
            reg.counter(
                "pathway_sanitizer_violations_total",
                help="dataflow invariant violations detected, by check",
                labels=("check",),
                callback=lambda: [
                    ((k,), v)
                    for k, v in sorted(self.violation_counts.items())
                ],
            )
            self._metrics = reg
        return self._metrics


def sanitizer_status() -> Dict[str, Any]:
    """The ``"sanitizer"`` key for /status (one attribute read + a dict
    literal when disabled; never instantiates the tracker)."""
    if not ACTIVE or _TRACKER is None:
        return {"enabled": False}
    return _TRACKER.status()


def sanitizer_metrics():
    """The sanitizer registry for PrometheusServer._registries(); None
    when disabled (never instantiates the tracker)."""
    if not ACTIVE or _TRACKER is None:
        return None
    return _TRACKER.metrics()
