"""Mesh execution backend: the process-wide mesh that `pw.run(mesh=...)`
publishes, read by the health controller, the device pipeline, the cost
ledger and /status.

The port has no device mesh yet (ROADMAP: Queue 1, mesh, sharded and
ring paths): `pw.run(mesh=...)` raises before it would activate one, and
`activate()` raises, so `active_backend()` is always None and every
reader takes its single-device branch. The backend's bookkeeping
(straggler detection, replica drain and re-admit, dp routing,
`pack_batch_dp`) is kept as the JAX package has it, for the slice that
builds the mesh on `torch.distributed`.

Exchange <-> device alignment: documents are routed to dp shards by the
SAME `key.shard % dp` rule the columnar exchange uses for workers
(`Pointer.shard % worker_count`).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# Straggler detection knobs (documented in ARCHITECTURE.md "Device
# utilization"): a replica whose windowed device-seconds exceed the
# replica mean by SKEW_THRESHOLD for PATIENCE consecutive dispatches is
# flagged — flight-recorder event + warn-once log.
SKEW_THRESHOLD = _env_float("PATHWAY_MESH_SKEW_THRESHOLD", 1.5)
SKEW_PATIENCE = int(_env_float("PATHWAY_MESH_SKEW_PATIENCE", 3))
SKEW_WINDOW_S = _env_float("PATHWAY_MESH_SKEW_WINDOW_S", 30.0)


class MeshBackend:
    """An activated mesh: the spec, the built device mesh, and
    the dp routing/accounting the ingest path needs."""

    def __init__(self, spec, mesh):
        self.spec = spec
        self.mesh = mesh
        names = tuple(mesh.axis_names)
        self.dp_axis = "dp" if "dp" in names else names[0]
        self.tp_axis = "tp" if "tp" in names else None
        self.dp = int(mesh.shape[self.dp_axis])
        self.tp = int(mesh.shape[self.tp_axis]) if self.tp_axis else 1
        self._lock = threading.Lock()
        self._degraded_replicas: set[int] = set()
        # replicas drained by the health controller: they receive no NEW
        # ingest (dp_shard_of routes around them) but stay in the mesh —
        # their index shards remain searchable, so retrieval stays
        # ranking-exact through a drain/re-admit cycle
        self._drained: set[int] = set()
        # -- per-dp-replica device-time accounting (utilization PR) ----
        from pathway_tpu_torch.internals.metrics import (
            FlightRecorder,
            MetricsRegistry,
        )

        self.metrics = MetricsRegistry(worker="0")
        self._device_hist = self.metrics.histogram(
            "pathway_mesh_replica_device_seconds",
            help="Estimated per-dispatch device time attributed to each "
            "dp replica (work-share weighted; see utilization.py)",
            labels=("replica",),
        )
        self.metrics.gauge(
            "pathway_mesh_replica_skew_ratio",
            help="Max replica windowed device-seconds over the replica "
            "mean (1.0 = balanced; straggler flagged above "
            "PATHWAY_MESH_SKEW_THRESHOLD)",
            callback=self._skew_ratio_or_none,
        )
        self.recorder = FlightRecorder(capacity=128)
        # rolling (t, seconds) per replica for the skew window
        self._device_window: List[Deque[Tuple[float, float]]] = [
            collections.deque() for _ in range(self.dp)
        ]
        self._skew_streak = 0
        self._straggler: Optional[Dict[str, Any]] = None
        self._straggler_warned = False
        # serving-tier read fan-out accounting: a batched serve search is
        # one SPMD program touching every dp replica's index shard, so
        # each batch counts one read against every ACTIVE replica
        # (drained replicas stay searchable but take no serve credit —
        # the detour moves their ingest keys, search still merges all
        # shards, so results stay ranking-exact)
        self._serve_batches = 0
        self._serve_queries = 0
        self._serve_reads: List[int] = [0] * self.dp
        self.metrics.counter(
            "pathway_mesh_serve_reads_total",
            help="Serving search batches fanned out to each dp replica",
            labels=("replica",),
            callback=lambda: [
                ((str(r),), float(n))
                for r, n in enumerate(self._serve_reads)
            ],
        )

    # -- sharding contract -------------------------------------------------

    def can_shard_ingest(self) -> bool:
        """dp shards the bucketed batch/index axes only at power-of-two
        counts (`DeviceKnnIndex` capacities and `pack_batch_dp` row
        buckets are power-of-two/multiple-of-8); anything else keeps the
        single-device ingest path (PWT402 lints embedder graphs)."""
        return self.dp >= 1 and not (self.dp & (self.dp - 1))

    def batch_sharding(self):
        """The [B, L] token slabs' placement: rows over dp, replicated
        over tp. No device mesh in the port yet."""
        raise NotImplementedError(_NO_MESH)

    def dp_shard_of(self, key) -> int:
        """dp replica owning `key` — `key.shard % dp`, the engine
        exchange's own routing rule (Pointer.shard % worker_count), so
        engine sharding and device sharding agree when workers % dp == 0
        (PWT404)."""
        shard = getattr(key, "shard", None)
        if shard is None:
            try:
                shard = int(key)
            except (TypeError, ValueError):
                shard = hash(key)
        replica = int(shard) % self.dp
        drained = self._drained
        if drained and replica in drained:
            # deterministic detour around drained replicas: the same key
            # always lands on the same surviving replica, and search
            # merges every shard regardless, so results stay exact
            active = [r for r in range(self.dp) if r not in drained]
            if active:
                replica = active[int(shard) % len(active)]
        return replica

    # -- per-replica device time + straggler detection ---------------------

    def note_dispatch_device_time(
        self, device_s: float, replica_rows: Optional[Sequence[int]] = None
    ) -> None:
        """One pipelined dispatch completed after an estimated
        `device_s` of device time.  The dispatch is one SPMD program —
        wall time is shared — so each replica is charged its WORK share
        (rows_r * dp / total_rows): a replica persistently carrying more
        rows than its peers is the straggler that sets the slab height
        every other replica pads to.  The `slow_replica` fault directive
        (internals/faults.py) inflates a replica's charge for tests."""
        from pathway_tpu_torch.internals import faults

        dp = self.dp
        rows = list(replica_rows or [])
        total = float(sum(rows)) if rows else 0.0
        now = time.monotonic()
        shares = []
        for r in range(dp):
            share = device_s
            if total > 0 and r < len(rows):
                share = device_s * rows[r] * dp / total
            if faults.ACTIVE:
                share *= faults.replica_factor(r)
            shares.append(share)
        with self._lock:
            horizon = now - SKEW_WINDOW_S
            for r, share in enumerate(shares):
                self._device_hist.labels(str(r)).observe(share)
                dq = self._device_window[r]
                dq.append((now, share))
                while dq and dq[0][0] < horizon:
                    dq.popleft()
            self._check_straggler_locked()

    def _windowed_device_s_locked(self) -> List[float]:
        return [sum(s for _, s in dq) for dq in self._device_window]

    def _skew_ratio_or_none(self) -> Optional[float]:
        with self._lock:
            sums = self._windowed_device_s_locked()
            active = [r for r in range(self.dp) if r not in self._drained]
        total = sum(sums[r] for r in active)
        if not total or len(active) < 2:
            return None
        return max(sums[r] for r in active) / (total / len(active))

    def _check_straggler_locked(self) -> None:
        sums = self._windowed_device_s_locked()
        # drained replicas receive no new work; judging survivors against
        # their stale window would fabricate stragglers
        active = [r for r in range(self.dp) if r not in self._drained]
        total = sum(sums[r] for r in active)
        if not total or len(active) < 2:
            return
        mean = total / len(active)
        worst = max(active, key=lambda r: sums[r])
        ratio = sums[worst] / mean
        if ratio < SKEW_THRESHOLD:
            self._skew_streak = 0
            self._straggler = None
            return
        self._skew_streak += 1
        if self._skew_streak < SKEW_PATIENCE:
            return
        self._straggler = {
            "replica": worst,
            "skew_ratio": round(ratio, 3),
            "window_device_s": round(sums[worst], 6),
            "streak": self._skew_streak,
        }
        if self._skew_streak == SKEW_PATIENCE:
            self.recorder.record(
                "replica_straggler",
                name=f"replica {worst}",
                node=worst,
                duration_s=sums[worst],
            )
        if not self._straggler_warned:
            self._straggler_warned = True
            logger.warning(
                "dp replica %d is a persistent straggler: windowed "
                "device time %.3fs is %.2fx the replica mean over %d "
                "consecutive dispatches (threshold %.2fx) — rebalance "
                "ingest routing or check the chip",
                worst, sums[worst], ratio, self._skew_streak,
                SKEW_THRESHOLD,
            )

    def straggler(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._straggler) if self._straggler else None

    # -- replica drain / re-admit (health controller actuator) -------------

    def drain_replica(self, replica: int, reason: str = "") -> bool:
        """Route NEW ingest around `replica` (its existing index shard
        stays searchable — retrieval remains ranking-exact).  Returns
        False when the replica is already drained or draining it would
        leave no active replica."""
        replica = int(replica) % self.dp
        with self._lock:
            if replica in self._drained:
                return False
            if len(self._drained) + 1 >= self.dp:
                return False  # never drain the last replica
            # replace, don't mutate: dp_shard_of reads lock-free
            self._drained = self._drained | {replica}
            # the straggler's stale window must not re-flag it (or its
            # survivors) the moment it stops receiving work
            self._device_window[replica].clear()
            self._skew_streak = 0
            self._straggler = None
            self._straggler_warned = False
        self.recorder.record(
            "replica_drained", name=reason or f"replica {replica}",
            node=replica,
        )
        return True

    def readmit_replica(self, replica: int) -> bool:
        """Re-admit a drained replica to the ingest routing."""
        replica = int(replica) % self.dp
        with self._lock:
            if replica not in self._drained:
                return False
            self._drained = self._drained - {replica}
            for dq in self._device_window:
                dq.clear()  # restart skew detection from a clean window
            self._skew_streak = 0
            self._straggler = None
        self.recorder.record(
            "replica_readmitted", name=f"replica {replica}", node=replica
        )
        return True

    def drained_replicas(self) -> List[int]:
        return sorted(self._drained)

    # -- degradation bookkeeping -------------------------------------------

    def note_serve_batch(self, n_queries: int) -> None:
        """One batched serve search dispatched across the mesh: the
        fused program reads every active replica's shard in parallel and
        the host merges, so each active replica is charged one read."""
        with self._lock:
            self._serve_batches += 1
            self._serve_queries += int(n_queries)
            drained = self._drained
            for r in range(self.dp):
                if r not in drained:
                    self._serve_reads[r] += 1

    def note_replica_degraded(self, replica: int) -> None:
        with self._lock:
            self._degraded_replicas.add(int(replica) % self.dp)

    def note_replicas_healthy(self) -> None:
        with self._lock:
            self._degraded_replicas.clear()

    def degraded_replicas(self) -> List[int]:
        with self._lock:
            return sorted(self._degraded_replicas)

    # -- /status -----------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        from pathway_tpu_torch.internals.device_pipeline import replica_status

        dev0 = self.mesh.devices.flat[0]
        with self._lock:
            window = [round(s, 6) for s in self._windowed_device_s_locked()]
        return {
            "active": True,
            "axes": dict(self.spec.to_dict()),
            "dp_axis": self.dp_axis,
            "tp_axis": self.tp_axis,
            "device_count": int(self.mesh.devices.size),
            "platform": getattr(dev0, "platform", None),
            "sharded_ingest": self.can_shard_ingest(),
            "degraded_replicas": self.degraded_replicas(),
            "drained_replicas": self.drained_replicas(),
            "replicas": replica_status(self.dp),
            # per-replica windowed device time + straggler verdict
            "replica_device_s": window,
            "skew_ratio": self._skew_ratio_or_none(),
            "straggler": self.straggler(),
            "serve_batches": self._serve_batches,
            "serve_queries": self._serve_queries,
            "serve_reads": list(self._serve_reads),
            "events": self.recorder.tail(),
        }


# -- process-wide activation -------------------------------------------------

_BACKEND: Optional[MeshBackend] = None
_lock = threading.Lock()


_NO_MESH = (
    "pathway_tpu_torch has no device mesh yet (ROADMAP: Queue 1, mesh, "
    "sharded and ring paths)"
)


def activate(spec) -> Optional[MeshBackend]:
    """Build and publish the mesh for `spec` (a MeshSpec). The port has no
    device mesh yet, so this raises and no backend is ever published."""
    raise NotImplementedError(_NO_MESH)


def deactivate() -> None:
    global _BACKEND
    with _lock:
        _BACKEND = None
    from pathway_tpu_torch.internals import memtrack

    if memtrack.ENABLED:
        memtrack.tracker().set_topology(1, 1)


def active_backend() -> Optional[MeshBackend]:
    return _BACKEND


def device_count() -> int:
    """Devices the active mesh spans (dp x tp), or 1 without a mesh —
    the cost ledger multiplies attributed device-seconds by this to get
    chip-seconds of capacity (internals/costledger.py)."""
    backend = _BACKEND
    if backend is None:
        return 1
    return max(1, backend.dp * backend.tp)


def mesh_status(engine=None) -> Optional[Dict[str, Any]]:
    """The `"mesh"` key for /status: live backend status when active,
    the (lint-only) spec dict when the engine was built with one, else
    None."""
    backend = _BACKEND
    if backend is not None:
        return backend.status()
    spec = getattr(engine, "mesh", None) if engine is not None else None
    if spec is not None:
        return {"active": False, "axes": dict(spec)}
    return None


# -- dp-grouped slab packing -------------------------------------------------


def pack_batch_dp(
    tokenizer,
    keys: Sequence[Any],
    texts: Sequence[str],
    backend: MeshBackend,
    *,
    max_len: int = 512,
    token_budget: int = 256,
    max_segments: int = 32,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]], List[int]]:
    """`tokenizer.pack_batch`, but grouped by dp shard: documents are
    partitioned by `backend.dp_shard_of(key)`, each group packs its own
    token-budget slabs, and the groups pad to a common [R, L] block so
    the stacked [dp*R, L] batch lands each group's rows exactly on its
    replica under `backend.batch_sharding()` (row r belongs to replica
    r // R).

    Returns (ids [dp*R, L], seg [dp*R, L], slots, replica_rows) with
    slots[d] = (row, seg-1) exactly like pack_batch, and replica_rows
    the per-replica DOCUMENT counts for the pipeline's per-replica
    occupancy gauges."""
    from pathway_tpu_torch.models.tokenizer import (
        PAD_ID,
        pack_batch,
        seq_bucket_length,
    )

    dp = backend.dp
    groups: List[List[int]] = [[] for _ in range(dp)]
    for i, key in enumerate(keys):
        groups[backend.dp_shard_of(key)].append(i)
    packed = []
    for g in groups:
        if not g:
            packed.append((g, None, None, None))
            continue
        ids_g, seg_g, slots_g = pack_batch(
            tokenizer,
            [texts[i] for i in g],
            max_len=max_len,
            token_budget=token_budget,
            max_segments=max_segments,
            row_bucket=False,
        )
        packed.append((g, ids_g, seg_g, slots_g))
    live = [p for p in packed if p[1] is not None]
    slab = max(ids_g.shape[1] for _, ids_g, _, _ in live)
    rows = seq_bucket_length(
        max(ids_g.shape[0] for _, ids_g, _, _ in live),
        minimum=8,
        maximum=1 << 16,
    )
    dtype = live[0][1].dtype
    pad_id = getattr(tokenizer, "pad_id", PAD_ID)
    ids = np.full((dp * rows, slab), pad_id, dtype=dtype)
    seg = np.zeros((dp * rows, slab), dtype=dtype)
    slots: List[Optional[Tuple[int, int]]] = [None] * len(keys)
    replica_rows: List[int] = []
    for replica, (g, ids_g, seg_g, slots_g) in enumerate(packed):
        replica_rows.append(len(g))
        if ids_g is None:
            continue
        base = replica * rows
        ids[base : base + ids_g.shape[0], : ids_g.shape[1]] = ids_g
        seg[base : base + seg_g.shape[0], : seg_g.shape[1]] = seg_g
        for i, (row, s) in zip(g, slots_g):
            slots[i] = (base + row, s)
    return ids, seg, slots, replica_rows
