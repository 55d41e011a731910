"""External-index operator: incremental index maintenance + as-of-now queries.

Rebuild of the reference external-index machinery (reference:
src/engine/dataflow/operators/external_index.rs use_external_index_as_of_now
_core:76 — index stream broadcast to every worker, batched by time;
src/external_integration/mod.rs IndexDerivedImpl:50). The KNN buffer is a
device tensor (ops/knn.py); a time's queries go to the index as one batch.
Copied from pathway_tpu/engine/index_node.py.

Within one engine time, index updates apply before queries — the same
timestamp-synchronized contract as the reference's batch_by_time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import _DiffCache
from pathway_tpu_torch.engine.value import ERROR, Error, Pointer
from pathway_tpu_torch.internals import costledger as _costledger
from pathway_tpu_torch.internals import provenance as _provenance
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import serving as _serving


class IndexImpl:
    """Interface every index backend implements (reference:
    trait ExternalIndex, external_integration/mod.rs:40-48)."""

    def add(self, key: Pointer, value: Any, metadata: Any) -> None:
        raise NotImplementedError

    def remove(self, key: Pointer) -> None:
        raise NotImplementedError

    def search(
        self, value: Any, k: int, metadata_filter: str | None
    ) -> List[tuple]:
        """Return [(key, score)] ranked best-first."""
        raise NotImplementedError

    def search_many(
        self, values: List[Any], ks: List[int], filters: List[str | None]
    ) -> List[List[tuple]]:
        """Batched search — backends override to hit the device once per batch."""
        return [
            self.search(v, k, f) for v, k, f in zip(values, ks, filters)
        ]

    def add_many(
        self, keys: List[Pointer], values: List[Any], metas: List[Any]
    ) -> None:
        """Batched insert — backends override to embed/scatter a whole
        engine batch in one device dispatch."""
        for key, value, meta in zip(keys, values, metas):
            self.add(key, value, meta)


class ExternalIndexNode(Node):
    """inputs: [data, queries]. Output universe = query keys; columns =
    (match_ids, match_scores, *per-data-column tuples) — repacking fused into
    the operator (reference splits this into index op + asof-now join,
    data_index.py:294)."""

    name = "external_index"

    def __init__(
        self,
        engine: Engine,
        data_node: Node,
        query_node: Node,
        index_impl: IndexImpl,
        data_value_prog,
        data_filter_prog,  # may be None
        query_value_prog,
        query_k_prog,
        query_filter_prog,  # may be None
        *,
        data_width: int,
        as_of_now: bool = True,
    ):
        # multi-worker: index updates BROADCAST so every worker maintains
        # the full index and serves its own key-shard of the query stream
        # locally — query throughput scales with workers instead of
        # funneling through worker 0 (reference:
        # src/engine/dataflow/operators/external_index.rs:13,70 broadcasts
        # the index stream the same way).
        from pathway_tpu_torch.engine.exchange import exchange_broadcast

        data_node = exchange_broadcast(engine, data_node)
        super().__init__(engine, [data_node, query_node])
        self.index = index_impl
        self.data_value_prog = data_value_prog
        self.data_filter_prog = data_filter_prog
        self.query_value_prog = query_value_prog
        self.query_k_prog = query_k_prog
        self.query_filter_prog = query_filter_prog
        self.data_width = data_width
        self.as_of_now = as_of_now
        self.data_rows: Dict[Pointer, tuple] = {}
        # retained only when not as_of_now (query results track index changes)
        self.query_rows: Dict[Pointer, tuple] = {}  # key -> (value, k, filter)
        self.cache = _DiffCache()
        self._emitted_asof: Dict[Pointer, tuple] = {}

    # device buffers are not pickled; the host-side row copies are the
    # operator snapshot, and _after_restore re-embeds/scatters them in one
    # batched dispatch per restart
    snapshot_attrs = ("data_rows", "query_rows", "cache", "_emitted_asof")

    # -- async device pipeline integration --------------------------------

    def _drain_index(self) -> None:
        drain = getattr(self.index, "drain", None)
        if drain is not None:
            drain()

    def on_rollback(self) -> None:
        # failover rollback (the pipeline contract): in-flight pipelined embed
        # batches must finish before the snapshot re-restore replays rows
        # — an async scatter landing after reset would double-count
        self._drain_index()

    def on_flush(self) -> None:
        # end-of-stream: quiesce the pipeline so finish() observes every
        # document before sink completion callbacks fire
        self._drain_index()

    def on_end(self) -> None:
        # the run is over: a backend with threads of its own (the fused
        # index's device pipeline) stops them, so that they do not hold
        # the index past its run
        close = getattr(self.index, "close", None)
        if close is not None:
            close()

    def snapshot_state(self) -> dict | None:
        # snapshots capture host-side rows only, but the commit point
        # must not advance past device work still in flight
        self._drain_index()
        return super().snapshot_state()

    def _after_restore(self) -> None:
        if not self.data_rows:
            return
        keys = list(self.data_rows.keys())
        rows = ([self.data_rows[k] for k in keys],)
        values = self.data_value_prog(keys, rows)
        metas = (
            self.data_filter_prog(keys, rows)
            if self.data_filter_prog is not None
            else [None] * len(keys)
        )
        self.index.add_many(keys, values, metas)

    def process(self, time: int) -> None:
        data_deltas = self.take(0)
        query_deltas = self.take(1)
        if not data_deltas and not query_deltas:
            return
        index_changed = False
        if data_deltas:
            keys = [d[0] for d in data_deltas]
            rows = ([d[1] for d in data_deltas],)
            values = self.data_value_prog(keys, rows)
            metas = (
                self.data_filter_prog(keys, rows)
                if self.data_filter_prog is not None
                else [None] * len(keys)
            )
            # buffer consecutive inserts so backends get one batched
            # add_many (one embed+scatter dispatch) per engine batch; a
            # remove for a buffered key flushes first to keep delta order
            pend_keys: list = []
            pend_values: list = []
            pend_metas: list = []

            def _flush_adds():
                if pend_keys:
                    self.index.add_many(
                        list(pend_keys), list(pend_values), list(pend_metas)
                    )
                    pend_keys.clear()
                    pend_values.clear()
                    pend_metas.clear()

            pending_set: Set[Pointer] = set()
            for (key, row, diff), value, meta in zip(data_deltas, values, metas):
                if diff > 0:
                    if isinstance(value, Error) or value is None:
                        self.log_error("index: invalid data value")
                        continue
                    pend_keys.append(key)
                    pend_values.append(value)
                    pend_metas.append(meta)
                    pending_set.add(key)
                    self.data_rows[key] = row
                    index_changed = True
                else:
                    if key in pending_set:
                        _flush_adds()
                        pending_set.clear()
                    self.index.remove(key)
                    self.data_rows.pop(key, None)
                    index_changed = True
            _flush_adds()

        out = []
        if query_deltas:
            q_keys = [d[0] for d in query_deltas]
            q_rows = ([d[1] for d in query_deltas],)
            q_values = self.query_value_prog(q_keys, q_rows)
            q_ks = self.query_k_prog(q_keys, q_rows)
            q_filters = (
                self.query_filter_prog(q_keys, q_rows)
                if self.query_filter_prog is not None
                else [None] * len(q_keys)
            )
            if self.as_of_now:
                live = []
                for (qk, _qrow, diff), value, k, filt in zip(
                    query_deltas, q_values, q_ks, q_filters
                ):
                    if diff > 0:
                        live.append((qk, value, k, filt, diff))
                    else:
                        prev = self._emitted_asof.pop(qk, None)
                        if prev is not None:
                            out.append((qk, prev, -1))
                results = self._timed_search(
                    [qk for qk, _, _, _, _ in live],
                    [v for _, v, _, _, _ in live],
                    [int(k) if k is not None else 3 for _, _, k, _, _ in live],
                    [f for _, _, _, f, _ in live],
                )
                for (qk, _v, _k, _f, diff), matches in zip(live, results):
                    row = self._result_row(matches)
                    self._emitted_asof[qk] = row
                    out.append((qk, row, diff))
            else:
                for (qk, _qrow, diff), value, k, filt in zip(
                    query_deltas, q_values, q_ks, q_filters
                ):
                    if diff > 0:
                        self.query_rows[qk] = (value, k, filt)
                    else:
                        self.query_rows.pop(qk, None)

        if not self.as_of_now and (index_changed or query_deltas):
            items = list(self.query_rows.items())
            results = self._timed_search(
                [qk for qk, _ in items],
                [v for _, (v, _, _) in items],
                [int(k) if k is not None else 3 for _, (_, k, _) in items],
                [f for _, (_, _, f) in items],
            )
            current = {
                qk: self._result_row(matches)
                for (qk, _), matches in zip(items, results)
            }
            for qk, row in current.items():
                self.cache.diff(qk, {qk: row}, out)
            gone = set(self.cache.emitted.keys()) - set(current.keys())
            for qk in gone:
                self.cache.diff(qk, {}, out)
        if _provenance.ACTIVE and out:
            # served result row links back to its query key AND the index
            # rows that scored it (row[0] = ranked match ids)
            _provenance.tracker().record_knn(self, time, out)
        self.emit(time, out)

    def _timed_search(self, q_keys, values, ks, filters) -> List[List[tuple]]:
        """search_many wrapped with query-span marks and cost
        attribution: stamp search_start for every traced query in the
        batch, then charge the batch's device wall time back — qtrace
        charges every traced query the FULL batch time (latency), the
        cost ledger splits it evenly across the batch's queries by
        (route, tenant) so cells sum to real device time.  Two attribute
        reads + one dict truthiness check when both layers are off."""
        traced = _qtrace.ENABLED and bool(_qtrace.tracker()._pending_keys)
        if not traced and not _costledger.ENABLED:
            return self._search_many(values, ks, filters, q_keys=q_keys)
        import time as time_mod

        tq = _qtrace.tracker() if traced else None
        if tq is not None:
            tq.mark_keys(q_keys, "search_start")
        t0 = time_mod.perf_counter()
        # search results materialize as host lists, so this wall time
        # includes the device round trip (async *ingest* pipelines only
        # defer add_many, never search)
        results = self._search_many(values, ks, filters, q_keys=q_keys)
        elapsed = time_mod.perf_counter() - t0
        if tq is not None:
            tq.note_device_keys(q_keys, elapsed)
        if _costledger.ENABLED:
            _costledger.charge_search(q_keys, elapsed, tracer=tq)
        return results

    def _search_many(self, values, ks, filters, q_keys=None) -> List[List[tuple]]:
        """search_many behind the serving result cache when a serving
        tier is live and the backend opts in (`supports_result_cache` —
        set only by impls whose EVERY mutation flows through the
        DeviceKnnIndex generation hooks, so cached reads can never be
        stale).  One attribute read + one None check otherwise."""
        if (
            _serving.ENABLED
            and _serving._TIER is not None
            and getattr(self.index, "supports_result_cache", False)
        ):
            return _serving._TIER.cached_search(
                values,
                ks,
                filters,
                self.index.search_many,
                index_id=id(self.index),
                q_keys=q_keys,
            )
        return self.index.search_many(values, ks, filters)

    def _result_row(self, matches: List[tuple]) -> tuple:
        ids = tuple(k for k, _s in matches)
        scores = tuple(float(s) for _k, s in matches)
        col_tuples = []
        for ci in range(self.data_width):
            col_tuples.append(
                tuple(
                    self.data_rows[k][ci] if k in self.data_rows else None
                    for k, _s in matches
                )
            )
        return (ids, scores, *col_tuples)
