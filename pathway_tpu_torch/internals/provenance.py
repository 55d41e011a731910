"""Record-level provenance & lineage — ``PATHWAY_PROVENANCE=1``.

Every observability layer so far answers "how fast / how much" (metrics,
tracing, MFU, query SLOs, cost ledger) or "is it deterministic"
(sanitizer); this module answers **"why is this output row here, and
which inputs produced it?"**.  When armed, operators record one bounded
backward-lineage *edge* per emitted delta:

    output key -> (operator id, epoch, contributing input keys, ±1 diff)

hooked at the engine process() loop, joins / groupbys / flatten (classic
AND columnar twins), FusedChainNode (the planned chain records
endpoint-to-endpoint edges tagged with its chain id, so fusion never
loses lineage), the exchange layer (``MSG_LINEAGE`` frames, in the style
of MSG_QSPAN, gather remote edges on worker 0), and the KNN/serving path
(a served result row links back to its query key and the index rows that
scored it, including result-cache hits).

Key identity: ``Pointer.__repr__`` is truncated and origin-dependent, so
the store canonicalizes every key to the full 32-hex ``value`` —
identical on every worker because the wire ships the 128-bit value.

Key-preserving unary operators (select/filter chains, exchanges) record
NOTHING: their keys are unchanged end to end, so the backward BFS passes
straight through them.  That rule is what makes the ``explain`` tree of
a fused plan identical to the unfused one — a fused chain's tagged
identity edges are surfaced as annotations, never as tree levels.

On top of the store, ``engine.explain(key)`` / ``tracker().explain``
runs a backward BFS to source-connector offsets and returns a JSON
lineage tree with retraction history ("emitted at epoch 12, retracted at
19 by input offset 3").  Surfaces: the ``/explain?key=`` HTTP endpoint,
``pathway-tpu explain``, the ``"provenance"`` /status key, the
``pathway_provenance_*`` metric families, and qtrace slow-query
exemplars enriched with their result row's lineage.

The store registers its bytes with memtrack (component ``provenance``,
host tier) and evicts oldest-epoch edges when it exceeds
``PATHWAY_PROVENANCE_BUDGET_BYTES`` (default 64 MiB), recording a
``provenance_truncated`` flight event.  ``PATHWAY_PROVENANCE_SAMPLE=N``
records every Nth epoch only.

Disabled (the default) every hook site is one module attribute read
(``provenance.ACTIVE``) and this module never imports jax.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

ACTIVE = False
_TRACKER: Optional["ProvenanceTracker"] = None

# rough per-edge accounting: dict slot + list + tuple + small strings;
# inputs add one canonical key string (32 hex chars) each
_EDGE_BASE_BYTES = 160
_EDGE_INPUT_BYTES = 56
_REMOTE_CAP = 8192
_CACHE_HIT_CAP = 4096


def install(enable: bool = True) -> None:
    """Arm (or disarm) provenance recording for this process."""
    global ACTIVE, _TRACKER
    ACTIVE = bool(enable)
    if ACTIVE and _TRACKER is None:
        _TRACKER = ProvenanceTracker()


def install_from_env() -> None:
    """Arm once per run from PATHWAY_PROVENANCE (runner.run calls this
    next to sanitizer.install_from_env, before the graph builds)."""
    if os.environ.get("PATHWAY_PROVENANCE", "0") == "1":
        install(True)


def clear() -> None:
    """Disarm and drop all state (tests)."""
    global ACTIVE, _TRACKER
    ACTIVE = False
    _TRACKER = None


def tracker() -> "ProvenanceTracker":
    global _TRACKER
    if _TRACKER is None:
        _TRACKER = ProvenanceTracker()
    return _TRACKER


def key_str(key: Any) -> str:
    """Canonical cross-worker key identity: the full 32-hex 128-bit
    pointer value (``repr`` is truncated AND origin-dependent, so it is
    not stable across pickling or workers)."""
    v = getattr(key, "value", None)
    if v is not None:
        return format(v, "032x")
    return str(key)


def _op_of(node: Any) -> str:
    return f"{getattr(node, 'name', type(node).__name__)}#" \
           f"{getattr(node, '_idx', -1)}"


class ProvenanceTracker:
    """Process-wide bounded backward-lineage edge store.

    Edges live in ``_edges[out_keystr] -> [(op, epoch, inputs, diff,
    tag)]`` with a per-epoch key index for wholesale oldest-epoch
    eviction under the byte budget.  Same-process workers share this
    tracker (thread mode needs no transport); in multi-process runs
    non-zero workers buffer recorded edges and ship them to worker 0 as
    MSG_LINEAGE frames from the per-tick ``on_tick`` hook.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # out keystr -> [(op, epoch, inputs tuple(keystr), diff, tag)]
        self._edges: Dict[str, List[tuple]] = {}
        self._epoch_keys: Dict[int, List[str]] = {}
        self._epoch_bytes: Dict[int, int] = {}
        self.bytes = 0
        self.edges_stored = 0
        self.records_total = 0
        self.truncations = 0
        self.edges_evicted = 0
        self.epochs_seen = 0
        self.epochs_recorded = 0
        self._seen_epoch_set: set = set()
        try:
            self.sample_every = max(
                1, int(os.environ.get("PATHWAY_PROVENANCE_SAMPLE", "1"))
            )
        except ValueError:
            self.sample_every = 1
        try:
            self.budget_bytes = int(
                os.environ.get(
                    "PATHWAY_PROVENANCE_BUDGET_BYTES", str(64 * 1024 * 1024)
                )
            )
        except ValueError:
            self.budget_bytes = 64 * 1024 * 1024
        # source node op -> next row offset
        self._source_offsets: Dict[str, int] = {}
        # keystrs the serving result-cache answered without a dispatch;
        # consumed by the next record_knn for those query keys
        self._cache_hits: set = set()
        self._worker_id = 0
        self._remote_out: List[list] = []
        self._metrics = None
        self._recorder = None

    # -- recording ---------------------------------------------------------

    def sampled(self, epoch: int) -> bool:
        return (epoch % self.sample_every) == 0

    def _note_epoch(self, epoch: int) -> None:
        # approximate sampled-fraction accounting (distinct epochs)
        if epoch in self._seen_epoch_set:
            return
        self._seen_epoch_set.add(epoch)
        if len(self._seen_epoch_set) > 4096:
            self._seen_epoch_set.clear()
        self.epochs_seen += 1
        if self.sampled(epoch):
            self.epochs_recorded += 1

    def record_edges(
        self,
        op: str,
        epoch: int,
        items,
        *,
        tag: Optional[str] = None,
    ) -> None:
        """Record one edge per (out_key, inputs, diff) triple.  Keys may
        be Pointers or pre-canonicalized strings; None inputs (outer-join
        pads) are dropped."""
        if not self.sampled(epoch):
            return
        with self._lock:
            self._record_locked(
                op, epoch, ((k, ins, d, tag) for k, ins, d in items)
            )

    def _record_locked(self, op: str, epoch: int, items) -> None:
        ekeys = self._epoch_keys.setdefault(epoch, [])
        added = 0
        for out_key, inputs, diff, tag in items:
            ks = key_str(out_key)
            ins = tuple(
                key_str(i) for i in inputs if i is not None
            )
            edge = (op, epoch, ins, diff, tag)
            self._edges.setdefault(ks, []).append(edge)
            ekeys.append(ks)
            added += _EDGE_BASE_BYTES + _EDGE_INPUT_BYTES * len(ins)
            self.edges_stored += 1
            self.records_total += 1
            if self._worker_id and len(self._remote_out) < _REMOTE_CAP:
                self._remote_out.append(
                    [ks, op, epoch, list(ins), diff, tag]
                )
        self._epoch_bytes[epoch] = (
            self._epoch_bytes.get(epoch, 0) + added
        )
        self.bytes += added
        self._evict_locked()

    def _evict_locked(self) -> None:
        while self.bytes > self.budget_bytes and len(self._epoch_keys) > 1:
            oldest = min(self._epoch_keys)
            keys = self._epoch_keys.pop(oldest)
            dropped = 0
            for ks in keys:
                edges = self._edges.get(ks)
                if edges is None:
                    continue
                kept = [e for e in edges if e[1] != oldest]
                dropped += len(edges) - len(kept)
                if kept:
                    self._edges[ks] = kept
                else:
                    del self._edges[ks]
            self.bytes -= self._epoch_bytes.pop(oldest, 0)
            self.edges_stored -= dropped
            self.edges_evicted += dropped
            self.truncations += 1
            self.recorder.record(
                "provenance_truncated",
                time=oldest,
                name=f"evicted epoch {oldest}",
                rows=dropped,
            )

    # operator-shaped helpers (each called behind `if provenance.ACTIVE`)

    def record_join(self, node: Any, epoch: int, out: list) -> None:
        """Join output rows carry (left_key, right_key, ...) as their
        first two values on both the classic and delta paths."""
        self.record_edges(
            _op_of(node),
            epoch,
            ((k, (row[0], row[1]), d) for k, row, d in out),
        )

    def record_reduce(
        self, node: Any, epoch: int, out: list, contrib: Dict[Any, list]
    ) -> None:
        """`contrib` maps canonical group keystr -> the input delta keys
        that touched the group this epoch (the delta lineage of the
        re-emit)."""
        op = _op_of(node)
        self.record_edges(
            op,
            epoch,
            (
                (k, tuple(contrib.get(key_str(k), ())), d)
                for k, _row, d in out
            ),
        )

    def record_flatten(self, node: Any, epoch: int, pairs) -> None:
        """`pairs`: (element_key, parent_key, diff) triples."""
        self.record_edges(
            _op_of(node),
            epoch,
            ((nk, (pk,), d) for nk, pk, d in pairs),
        )

    def record_fused(self, node: Any, epoch: int, out: list) -> None:
        """Endpoint-to-endpoint identity edges tagged with the chain id
        — annotations the explain tree folds, never traverses (keys are
        unchanged through a fused select/filter chain)."""
        ops = getattr(node, "op_ids", ()) or (getattr(node, "_idx", -1),)
        tag = "chain:" + "-".join(str(i) for i in ops)
        self.record_edges(
            _op_of(node),
            epoch,
            ((k, (k,), d) for k, _row, d in out),
            tag=tag,
        )

    def record_source(self, node: Any, epoch: int, deltas: list) -> None:
        """Source-connector leaves: inputs are empty, the tag carries the
        per-source running row offset the backward BFS bottoms out on."""
        if not self.sampled(epoch):
            return
        op = _op_of(node)
        with self._lock:
            off = self._source_offsets.get(op, 0)
            items = []
            for k, _row, d in deltas:
                items.append((k, (), d, f"offset:{off}"))
                off += 1
            self._source_offsets[op] = off
            self._record_locked(op, epoch, items)

    def record_knn(self, node: Any, epoch: int, out: list) -> None:
        """A served result row links back to its query key (the qid
        qtrace stamps) and the index rows that scored it; rows answered
        by the serving result cache are tagged ``knn:cache_hit``."""
        op = _op_of(node)
        plain: List[tuple] = []
        cached: List[tuple] = []
        with self._lock:
            hits = self._cache_hits
            for qk, row, d in out:
                ids = row[0] if row and isinstance(row[0], (tuple, list)) \
                    else ()
                inputs = (qk, *ids)
                ks = key_str(qk)
                if ks in hits:
                    hits.discard(ks)
                    cached.append((qk, inputs, d))
                else:
                    plain.append((qk, inputs, d))
        if plain:
            self.record_edges(op, epoch, plain, tag="knn")
        if cached:
            self.record_edges(op, epoch, cached, tag="knn:cache_hit")

    def note_cache_hits(self, keys) -> None:
        """Serving result-cache hits (internals/serving.py): remember the
        query keys so the next recorded KNN edge for them is tagged as
        cache-served.  Bounded — an unconsumed set never grows past the
        cap."""
        with self._lock:
            if len(self._cache_hits) >= _CACHE_HIT_CAP:
                self._cache_hits.clear()
            for k in keys:
                self._cache_hits.add(key_str(k))

    # -- cross-worker merge ------------------------------------------------

    def attach_worker(self, worker_id: int) -> None:
        """Declare which global worker this process leads; non-zero
        workers queue recorded edges for shipment to worker 0."""
        self._worker_id = worker_id

    def on_tick(self, engine: Any) -> None:
        """Per-tick hook (engine.process_time tail): count the epoch for
        the sampled-fraction gauge, refresh the memtrack registration,
        and move edges across the process mesh (MSG_LINEAGE)."""
        self._note_epoch(engine.current_time)
        from pathway_tpu_torch.internals import memtrack as _memtrack

        if _memtrack.ENABLED:
            _memtrack.tracker().register(
                "provenance", self, float(self.bytes), tier="host",
                edges=self.edges_stored,
            )
        coord = getattr(engine, "coord", None)
        if coord is None:
            return
        if self._worker_id != 0:
            if self._remote_out:
                with self._lock:
                    out, self._remote_out = self._remote_out, []
                try:
                    coord.send_lineage(
                        0, self._worker_id, {"edges": out}
                    )
                except Exception:  # noqa: BLE001 — diagnostics never fail a run
                    pass
        else:
            self.absorb(coord)

    def absorb(self, coord: Any) -> None:
        """Merge lineage payloads shipped from other processes into the
        local store (worker 0 gather)."""
        try:
            payloads = coord.take_lineage()
        except Exception:  # noqa: BLE001
            return
        for _origin, payload in payloads:
            edges = payload.get("edges") or ()
            with self._lock:
                for ks, op, epoch, ins, diff, tag in edges:
                    edge = (op, int(epoch), tuple(ins), int(diff), tag)
                    self._edges.setdefault(ks, []).append(edge)
                    self._epoch_keys.setdefault(int(epoch), []).append(ks)
                    nb = _EDGE_BASE_BYTES + _EDGE_INPUT_BYTES * len(ins)
                    self._epoch_bytes[int(epoch)] = (
                        self._epoch_bytes.get(int(epoch), 0) + nb
                    )
                    self.bytes += nb
                    self.edges_stored += 1
                    self.records_total += 1
                self._evict_locked()

    # -- explain -----------------------------------------------------------

    @staticmethod
    def _canon(key: Any) -> str:
        if isinstance(key, str):
            s = key.lstrip("^").strip()
            try:
                return format(int(s, 16), "032x")
            except ValueError:
                return s
        if isinstance(key, int):
            return format(key, "032x")
        return key_str(key)

    def _offsets_for(self, ks: str, seen: set, budget: int = 256) -> List[int]:
        """Backward BFS from `ks` to every reachable source offset."""
        out: List[int] = []
        frontier = [ks]
        while frontier and budget > 0:
            nxt: List[str] = []
            for k in frontier:
                if k in seen:
                    continue
                seen.add(k)
                budget -= 1
                for op, _e, ins, _d, tag in self._edges.get(k, ()):
                    if tag and tag.startswith("offset:"):
                        out.append(int(tag.split(":", 1)[1]))
                    elif not (tag and tag.startswith("chain:")):
                        nxt.extend(ins)
            frontier = nxt
        return sorted(set(out))

    def explain(
        self,
        key: Any,
        *,
        max_depth: int = 12,
        max_nodes: int = 256,
        include_chains: bool = False,
    ) -> Dict[str, Any]:
        """Backward BFS from `key` to source-connector offsets: a JSON
        lineage tree plus the key's retraction history.  Fused-chain
        identity edges annotate (``include_chains``) but never add tree
        levels, so fusion on/off yields the identical tree."""
        root = self._canon(key)
        with self._lock:
            budget = [max_nodes]

            def build(ks: str, depth: int, path: frozenset) -> Dict[str, Any]:
                budget[0] -= 1
                edges = sorted(
                    self._edges.get(ks, ()), key=lambda e: (e[1], e[0])
                )
                node: Dict[str, Any] = {"key": ks}
                history: List[Dict[str, Any]] = []
                chains: List[str] = []
                child_keys: List[str] = []
                offsets: List[int] = []
                ops: List[str] = []
                for op, epoch, ins, diff, tag in edges:
                    if tag and tag.startswith("chain:"):
                        if tag not in chains:
                            chains.append(tag)
                        continue
                    entry: Dict[str, Any] = {
                        "epoch": epoch, "diff": diff, "op": op,
                    }
                    if tag and tag.startswith("offset:"):
                        off = int(tag.split(":", 1)[1])
                        entry["offset"] = off
                        offsets.append(off)
                    elif tag:
                        entry["tag"] = tag
                    if ins:
                        entry["inputs"] = list(ins)
                    history.append(entry)
                    if op not in ops:
                        ops.append(op)
                    for i in ins:
                        if i != ks and i not in child_keys:
                            child_keys.append(i)
                node["found"] = bool(history) or bool(chains)
                if ops:
                    node["ops"] = ops
                if history:
                    node["history"] = history
                if offsets:
                    node["source_offsets"] = sorted(set(offsets))
                if include_chains and chains:
                    node["chains"] = chains
                if depth >= max_depth or budget[0] <= 0:
                    if child_keys:
                        node["truncated"] = True
                    return node
                children = []
                for ck in child_keys:
                    if ck in path:
                        continue  # defensive: lineage cycles cannot recurse
                    if budget[0] <= 0:
                        node["truncated"] = True
                        break
                    children.append(
                        build(ck, depth + 1, path | {ks})
                    )
                if children:
                    node["inputs"] = children
                return node

            tree = build(root, 0, frozenset())
            story: List[str] = []
            for entry in tree.get("history", ()):
                verb = "emitted" if entry["diff"] > 0 else "retracted"
                line = f"{verb} at epoch {entry['epoch']} by {entry['op']}"
                if "offset" in entry:
                    line += f" (input offset {entry['offset']})"
                elif entry.get("inputs"):
                    offs: List[int] = []
                    for i in entry["inputs"]:
                        offs.extend(self._offsets_for(i, set()))
                    offs = sorted(set(offs))
                    if offs:
                        line += (
                            " via input offset"
                            f"{'s' if len(offs) > 1 else ''} "
                            + ", ".join(str(o) for o in offs[:8])
                        )
                story.append(line)
        return {
            "key": root,
            "found": tree.get("found", False),
            "retractions": story,
            "tree": tree,
        }

    def explain_brief(self, key: Any) -> Optional[Dict[str, Any]]:
        """Compact lineage summary for qtrace slow-query exemplars."""
        if key is None:
            return None
        ks = self._canon(key)
        with self._lock:
            edges = self._edges.get(ks)
            if not edges:
                return None
            ops: List[str] = []
            tags: List[str] = []
            for op, _e, _ins, _d, tag in edges:
                if op not in ops:
                    ops.append(op)
                if tag and tag not in tags:
                    tags.append(tag)
            offsets = self._offsets_for(ks, set(), budget=64)
        out: Dict[str, Any] = {"key": ks, "edges": len(edges), "ops": ops}
        if tags:
            out["tags"] = tags
        if offsets:
            out["source_offsets"] = offsets[:16]
        return out

    # -- surfaces ----------------------------------------------------------

    @property
    def recorder(self):
        if self._recorder is None:
            from pathway_tpu_torch.internals.metrics import FlightRecorder

            self._recorder = FlightRecorder(capacity=64)
        return self._recorder

    def status(self) -> Dict[str, Any]:
        with self._lock:
            seen = max(1, self.epochs_seen)
            return {
                "enabled": True,
                "edges": self.edges_stored,
                "keys": len(self._edges),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "truncations": self.truncations,
                "edges_evicted": self.edges_evicted,
                "records": self.records_total,
                "sample_every": self.sample_every,
                "sampled_fraction": round(
                    self.epochs_recorded / seen, 4
                ),
                "sources": dict(sorted(self._source_offsets.items())),
                "flight_recorder": self.recorder.tail(8),
            }

    def metrics(self):
        if self._metrics is None:
            from pathway_tpu_torch.internals.metrics import MetricsRegistry

            reg = MetricsRegistry()
            reg.gauge(
                "pathway_provenance_edges",
                help="lineage edges currently stored",
                callback=lambda: self.edges_stored,
            )
            reg.gauge(
                "pathway_provenance_bytes",
                help="estimated bytes held by the lineage edge store",
                callback=lambda: self.bytes,
            )
            reg.counter(
                "pathway_provenance_records_total",
                help="lineage edges recorded since arm (incl. evicted)",
                callback=lambda: self.records_total,
            )
            reg.counter(
                "pathway_provenance_truncations_total",
                help="oldest-epoch evictions under the byte budget",
                callback=lambda: self.truncations,
            )
            reg.gauge(
                "pathway_provenance_sampled_fraction",
                help="fraction of epochs recorded (PATHWAY_PROVENANCE_SAMPLE)",
                callback=lambda: (
                    self.epochs_recorded / max(1, self.epochs_seen)
                ),
            )
            self._metrics = reg
        return self._metrics


def provenance_status() -> Dict[str, Any]:
    """The ``"provenance"`` key for /status (one attribute read + a dict
    literal when disabled; never instantiates the tracker)."""
    if not ACTIVE or _TRACKER is None:
        return {"enabled": False}
    return _TRACKER.status()


def provenance_metrics():
    """The provenance registry for PrometheusServer._registries(); None
    when disabled (never instantiates the tracker)."""
    if not ACTIVE or _TRACKER is None:
        return None
    return _TRACKER.metrics()
