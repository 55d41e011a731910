"""Connector runtime: reader threads, commit ticks, the streaming driver.

TPU-native rebuild of the reference connector machinery (reference:
src/connectors/mod.rs Connector::run:523 — reader thread per source, commit
ticks advancing engine time; even timestamps mark batch boundaries,
src/engine/timestamp.rs). Here each live source runs a python thread pushing
events into the driver's queue; the driver groups them into engine times and
steps the dataflow.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time as time_mod
from typing import Any, Callable, Dict, List, Optional, Tuple

from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import sanitizer as _sanitizer
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

_source_ids = itertools.count()


def _hashable(values: tuple) -> tuple:
    """Values tuple -> dict key (Json and arrays are unhashable)."""
    out = []
    for v in values:
        try:
            hash(v)
            out.append(v)
        except TypeError:
            out.append(repr(v))
    return tuple(out)


def _values_tuples(rows: List[dict], names: List[str]) -> List[tuple]:
    """Row dicts -> values tuples; specialized for narrow schemas (the
    per-row genexpr inside tuple() dominates otherwise)."""
    if len(names) == 1:
        n0 = names[0]
        return [(r.get(n0),) for r in rows]
    if len(names) == 2:
        n0, n1 = names
        return [(r.get(n0), r.get(n1)) for r in rows]
    if len(names) == 3:
        n0, n1, n2 = names
        return [(r.get(n0), r.get(n1), r.get(n2)) for r in rows]
    return [tuple(r.get(c) for c in names) for r in rows]


class LiveSource:
    """One streaming input: a subject factory + the engine node it feeds.

    `exclusive` sources (REST ingress, stateful custom subjects) run their
    reader on exactly one worker; a scatter exchange after the source node
    routes rows to shard owners (reference: non-partitioned sources are read
    by one worker and forwarded, worker-architecture doc :41-42)."""

    def __init__(
        self,
        subject_factory,
        schema,
        name: str,
        *,
        exclusive: bool = False,
        exclusive_worker: int = 0,
        partitioned: bool = False,
    ):
        self.subject_factory = subject_factory
        self.schema = schema
        self.name = name
        self.partitioned = partitioned
        self.node = None  # set at build time
        self.sync_group = None  # set by register_input_synchronization_group
        self.sync_column = None
        self.exclusive = exclusive
        self.exclusive_worker = exclusive_worker
        # barrier-commit sources: rows flush only up to the last commit, so
        # batch shapes are exactly the subject's commit units regardless of
        # timer alignment or reader/engine relative speed
        self.gated_commits = False


def connector_table(
    schema,
    subject_factory: Callable[[], "ConnectorSubjectBase"],
    *,
    mode: str = "streaming",
    name: str | None = None,
    exclusive: bool = False,
    exclusive_worker: int = 0,
    partitioned: bool = False,
    gated_commits: bool = False,
) -> Table:
    """Create a table fed by a connector subject (reference:
    Graph::connector_table, dataflow.rs:3880).

    Multi-worker source modes:
    - default (replicated): every worker runs the reader over the full
      input and keeps only its key shard — right for local files, demo
      streams, anything cheap and deterministic to re-read.
    - ``exclusive``: one worker reads (REST ingress binding a port,
      stateful custom subjects); rows are scatter-exchanged to owners.
    - ``partitioned``: every worker reads a disjoint partition subset
      (kafka consumer groups); rows are scatter-exchanged, nothing is
      filtered."""
    name = name or f"source_{next(_source_ids)}"
    live = LiveSource(
        subject_factory,
        schema,
        name,
        exclusive=exclusive,
        exclusive_worker=exclusive_worker,
        partitioned=partitioned,
    )
    live.gated_commits = gated_commits

    if mode == "static":

        def build_static(ctx):
            from pathway_tpu_torch.engine.engine import StaticSource

            subject = subject_factory()
            collector = _StaticCollector(schema)
            subject._bind(collector)
            pcfg = getattr(ctx.engine, "_persistence_config", None)
            if pcfg is not None:
                from pathway_tpu_torch.persistence import CachedObjectStorage

                subject._bind_object_cache(
                    CachedObjectStorage(pcfg.backend._backend, name)
                )
            subject.run()
            subject.on_stop()
            deltas = collector.all_deltas()
            if deltas is not None:
                return StaticSource(ctx.engine, {}, deltas=deltas)
            return StaticSource(ctx.engine, collector.all_rows())

        return Table(schema=schema, universe=Universe(), build=build_static)

    def build_streaming(ctx):
        from pathway_tpu_torch.engine.engine import InputQueueSource

        node = InputQueueSource(
            ctx.engine, shard_filter=not (exclusive or partitioned)
        )
        live.node = node
        # thread workers build one engine per thread from the same parse
        # graph: the driver must resolve the node for ITS engine, not the
        # last-built one
        nodes = getattr(ctx.engine, "_live_nodes", None)
        if nodes is None:
            nodes = ctx.engine._live_nodes = {}
        nodes[live] = node
        if live not in G.sources:
            G.add_source(live)
        if (exclusive or partitioned) and ctx.engine.worker_count > 1:
            from pathway_tpu_torch.engine.exchange import exchange_by_key

            return exchange_by_key(ctx.engine, node)
        return node

    table = Table(schema=schema, universe=Universe(), build=build_streaming)
    table._live_source = live  # for input synchronization groups
    return table


class _StaticCollector:
    """Synchronously drains a subject in static mode."""

    def __init__(self, schema):
        from pathway_tpu_torch.engine.value import seq_key_seed

        self.schema = schema
        self.names = list(schema.keys())
        self.pk = schema.primary_key_columns()
        self.rows: Dict[Pointer, tuple] = {}
        self._counter = 0
        self._seed = seq_key_seed("static", schema.__name__)
        # keyless retraction bookkeeping is lazy: bulk loads log batches
        # and the values->keys dict materializes on the first retraction
        self._keys_by_values: Dict[tuple, List] = {}
        self._kv_log: List[tuple] = []  # (values_list, keys_list)

    def _materialize_kv(self) -> Dict[tuple, List]:
        kv = self._keys_by_values
        if self._kv_log:
            rows = self.rows
            for values_list, keys_list in self._kv_log:
                rows.update(zip(keys_list, values_list))
                for v, k in zip(values_list, keys_list):
                    kv.setdefault(_hashable(v), []).append(k)
            self._kv_log.clear()
        return kv

    def push_row(self, row: dict, diff: int = 1) -> None:
        from pathway_tpu_torch.engine.value import seq_key

        values = tuple(row.get(c) for c in self.names)
        if self.pk:
            key = ref_scalar(*(row.get(c) for c in self.pk))
        elif diff > 0:
            self._counter += 1
            key = seq_key(self._seed, self._counter)
            if self._kv_log:
                self._materialize_kv()
            self._keys_by_values.setdefault(_hashable(values), []).append(key)
        else:
            # retraction without a primary key: cancel the key assigned to
            # an earlier insert of the same values
            stack = self._materialize_kv().get(_hashable(values))
            if not stack:
                return
            key = stack.pop()
        if diff > 0:
            self.rows[key] = values
        else:
            self.rows.pop(key, None)

    def push_rows(self, rows: List[dict]) -> None:
        """Bulk insert: one pass over the batch instead of per-row calls.
        Keyless batches skip the dict entirely (seq keys cannot collide);
        `all_rows()` folds the logged batches back in."""
        self.push_tuples(_values_tuples(rows, self.names))

    def push_tuples(self, values_list: List[tuple]) -> None:
        """Bulk insert of pre-ordered values tuples — the readers' fastest
        path: no row dicts anywhere between the parser and the engine."""
        from pathway_tpu_torch.engine.value import seq_keys_batch

        if self.pk:
            idxs = [self.names.index(c) for c in self.pk]
            keys = [
                ref_scalar(*(v[i] for i in idxs)) for v in values_list
            ]
            self.rows.update(zip(keys, values_list))
        else:
            keys = seq_keys_batch(
                self._seed, self._counter, len(values_list)
            )
            self._counter += len(values_list)
            self._kv_log.append((values_list, keys))

    def all_rows(self) -> Dict[Pointer, tuple]:
        """Final key -> values map (push_row inserts + logged batches)."""
        if self._kv_log:
            rows = self.rows
            for values_list, keys_list in self._kv_log:
                rows.update(zip(keys_list, values_list))
            self._kv_log.clear()
        return self.rows

    def all_deltas(self):
        """Prebuilt consolidated delta list for the pure bulk-ingest shape
        (only logged batches, seq keys, no per-row inserts/retractions) —
        C-speed zip, no dict materialization. None when the per-row path
        was used (all_rows() handles the general case)."""
        if self.rows or not self._kv_log:
            return None
        from itertools import repeat

        out: List = []
        for values_list, keys_list in self._kv_log:
            out.extend(zip(keys_list, values_list, repeat(1)))
        return out

    def commit(self) -> None:
        pass

    def close(self) -> None:
        pass


class ConnectorSubjectBase:
    """Base for python connector subjects (reference:
    io/python/__init__.py:47 ConnectorSubject): background thread calling
    next()/commit()/close()."""

    _worker_id = 0
    _worker_count = 1
    # class-level defaults so report_retry works even when a subclass
    # forgets to call super().__init__()
    _retries = 0
    _backoff_s = 0.0

    def __init__(self):
        self._sink = None
        self._closed = False
        self._retries = 0
        self._backoff_s = 0.0
        self._object_cache = None  # CachedObjectStorage under persistence

    def _bind(self, sink) -> None:
        self._sink = sink

    def _bind_object_cache(self, cache) -> None:
        """Persistence-backed source-object cache (reference:
        cached_object_storage.rs): downloading connectors consult it to
        skip re-fetching unchanged objects after a restart."""
        self._object_cache = cache

    # -- API used by subclasses ------------------------------------------
    def next(self, **kwargs) -> None:
        self._sink.push_row(kwargs)

    def next_batch(self, rows: List[dict]) -> None:
        """Bulk insert of row dicts — one sink call for the whole chunk
        (the readers' bulk-ingest fast path)."""
        push_rows = getattr(self._sink, "push_rows", None)
        if push_rows is not None:
            push_rows(rows)
        else:
            for r in rows:
                self._sink.push_row(r)

    def next_batch_tuples(self, values_list: List[tuple], names: List[str]) -> None:
        """Bulk insert of schema-ordered values tuples — skips row dicts
        entirely when the sink supports it."""
        push_tuples = getattr(self._sink, "push_tuples", None)
        if push_tuples is not None:
            push_tuples(values_list)
        else:
            self.next_batch([dict(zip(names, v)) for v in values_list])

    def _wait_for_run_end(self, seconds: float) -> bool:
        """Sleep `seconds` between a streaming reader's polls; True, at
        once, when the run it feeds has ended, so that the reader returns
        rather than poll on for a run that reads no more."""
        ended = getattr(self._sink, "ended", None)
        if ended is None:
            time_mod.sleep(seconds)
            return False
        return ended.wait(seconds)

    def report_retry(self, delay: float = 0.0) -> None:
        """Count a transient read failure that the subject retried
        (network hiccup, rate limit) and the backoff it cost.  Retry
        sites compute ``delay`` with internals/backoff.Backoff (capped
        exponential + jitter) and pass it here so every connector
        surfaces uniform ``retries`` / ``backoff_s`` stats
        (``pathway_connector_retries`` / ``_backoff_seconds``)."""
        self._retries += 1
        self._backoff_s += delay

    def next_json(self, message: dict) -> None:
        self.next(**message)

    def next_bytes(self, payload: bytes) -> None:
        self.next(data=payload)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def _remove(self, row: dict) -> None:
        self._sink.push_row(row, diff=-1)

    def commit(self, barrier: bool = False) -> None:
        """Mark a consistent point in the stream. With persistence, a
        commit seals the batch + cursor that recovery replays. Without
        persistence it is a flush hint only: under load the driver may
        coalesce rows from after a commit into the same engine minibatch
        (server-side micro-batching). ``barrier=True`` additionally makes
        the commit a batch BOUNDARY (single-worker): rows after it never
        coalesce into the same engine tick — deterministic batch shapes
        that pipeline host parsing of batch N+1 against the device work of
        batch N (bulk-ingest host/device overlap)."""
        # capability probe once per sink: catching TypeError around the
        # live call would retry (double-commit) and mask real errors
        accepts = getattr(self._sink, "_commit_accepts_barrier", None)
        if accepts is None:
            import inspect

            try:
                params = inspect.signature(self._sink.commit).parameters
                accepts = "barrier" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()
                )
            except (TypeError, ValueError):
                accepts = False
            try:
                self._sink._commit_accepts_barrier = accepts
            except AttributeError:
                pass
        if accepts:
            self._sink.commit(barrier=barrier)
        else:
            self._sink.commit()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._sink.close()

    # -- persistence hooks (reference: ConnectorSubject seek/snapshot,
    # io/python/__init__.py:47) -------------------------------------------
    def _persisted_state(self):
        """Cursor state saved at each commit; restored on resume."""
        return None

    def _restore_persisted_state(self, state) -> None:
        pass

    # -- to override ------------------------------------------------------
    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    @property
    def _deletions_enabled(self) -> bool:
        return True


class _QueueSink:
    """Routes a live subject's rows into the driver queue."""

    def __init__(self, driver_queue, live: LiveSource):
        from pathway_tpu_torch.engine.value import seq_key_seed

        self.queue = driver_queue
        self.live = live
        self.names = list(live.schema.keys())
        self.pk = live.schema.primary_key_columns()
        self._counter = 0
        self._seed = seq_key_seed("live", live.name)
        self._keys_by_values: Dict[tuple, List] = {}
        self.subject = None  # bound by the driver
        self.ended = threading.Event()  # set when the driver's run ends

    persistence_enabled = False

    def detach(self) -> None:
        """The run is over: let go of it (its queue, and through the
        source its engine), so that a reader still polling holds nothing
        of the run, and wake readers waiting for its end.  Rows and
        commits after this go nowhere, as they did into the unread
        queue."""
        self.queue = None
        self.live = None
        self.subject = None
        self.ended.set()

    def push_row(self, row: dict, diff: int = 1) -> None:
        from pathway_tpu_torch.engine.value import seq_key

        queue, live = self.queue, self.live
        if queue is None:
            return
        if live.sync_group is not None and diff > 0:
            # throttle until the group's other sources catch up (reference:
            # src/connectors/synchronization.rs)
            live.sync_group.wait_for(live, row.get(live.sync_column))
        values = tuple(row.get(c) for c in self.names)
        if "_pw_key" in row:
            key = row["_pw_key"]
        elif self.pk:
            key = ref_scalar(*(row.get(c) for c in self.pk))
        elif diff > 0:
            self._counter += 1
            key = seq_key(self._seed, self._counter)
            self._keys_by_values.setdefault(_hashable(values), []).append(key)
        else:
            # retraction on a keyless schema must reuse the insert's key,
            # or it never cancels anything (negative multiplicity)
            stack = self._keys_by_values.get(_hashable(values))
            if not stack:
                return
            key = stack.pop()
        # the counter rides every data message so autocommit-flushed
        # batches persist a correct resume point even without commit()
        queue.put(("data", live, (key, values, diff), self._counter))

    def push_rows(self, rows: List[dict]) -> None:
        """Bulk inserts: one queue message for the whole batch.  Falls
        back to push_row when per-row handling is needed (sync groups,
        explicit keys).  Contract: batches are homogeneous w.r.t.
        `_pw_key` — either every row carries one or none does (the
        readers guarantee this; schema-filtered rows never carry it)."""
        from pathway_tpu_torch.engine.value import seq_keys_batch

        live = self.live
        if live is None:
            return
        if live.sync_group is not None or (
            rows and "_pw_key" in rows[0]
        ):
            for r in rows:
                self.push_row(r)
            return
        self.push_tuples(_values_tuples(rows, self.names))

    def push_tuples(self, values_list: List[tuple]) -> None:
        """Bulk insert of pre-ordered values tuples (no row dicts)."""
        from pathway_tpu_torch.engine.value import seq_keys_batch

        queue, live = self.queue, self.live
        if queue is None:
            return
        if live.sync_group is not None:
            for v in values_list:
                self.push_row(dict(zip(self.names, v)))
            return
        if self.pk:
            idxs = [self.names.index(c) for c in self.pk]
            keys = [
                ref_scalar(*(v[i] for i in idxs)) for v in values_list
            ]
        else:
            keys = seq_keys_batch(
                self._seed, self._counter, len(values_list)
            )
            self._counter += len(values_list)
            kv = self._keys_by_values
            for v, k in zip(values_list, keys):
                kv.setdefault(_hashable(v), []).append(k)
        deltas = [(k, v, 1) for k, v in zip(keys, values_list)]
        queue.put(("data_batch", live, deltas, self._counter))

    def commit(self, barrier: bool = False) -> None:
        queue, live, subject = self.queue, self.live, self.subject
        if queue is None:
            return
        state = None
        if self.persistence_enabled and subject is not None:
            state = {"subject": subject._persisted_state()}
        kind = "commit_b" if barrier else "commit"
        queue.put((kind, live, state, self._counter))

    def close(self) -> None:
        queue, live = self.queue, self.live
        if queue is None:
            return
        if live.sync_group is not None:
            live.sync_group.source_closed(live)
        queue.put(("close", live, None, self._counter))


class StreamingDriver:
    """Main streaming loop: collects source events, advances engine time
    (reference: worker main loop, dataflow.rs:6552-6620)."""

    def __init__(
        self,
        engine,
        ctx,
        *,
        autocommit_ms: float = 100.0,
        persistence_config=None,
    ):
        self.engine = engine
        self.ctx = ctx
        self.autocommit_s = autocommit_ms / 1000.0
        self.queue: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self.persistence_config = persistence_config
        self._writers: Dict[LiveSource, Any] = {}

    def _snapshot_writer(self, live: LiveSource):
        if self.persistence_config is None:
            return None
        from pathway_tpu_torch.persistence import InputSnapshotWriter

        writer = self._writers.get(live)
        if writer is None:
            writer = InputSnapshotWriter(
                self.persistence_config.backend._backend,
                live.name,
                self.engine.worker_id,
            )
            self._writers[live] = writer
        return writer

    def run(self, sources: List[LiveSource]) -> None:
        self._sinks: Dict[LiveSource, _QueueSink] = {}
        try:
            self._run(sources)
        finally:
            # finish() unfreezes on the success path; this also covers
            # exceptions mid-stream (engine._gc_pulse freezes the gc)
            self.engine._gc_unfreeze()
            # the run is over: its readers let go of it and the polling
            # ones return, or a reader asleep in its refresh interval
            # would hold the engine, its index and its model for good
            for sink in self._sinks.values():
                sink.detach()

    def _run(self, sources: List[LiveSource]) -> None:
        import os

        from pathway_tpu_torch.engine.engine import EngineError, FailoverRequired
        from pathway_tpu_torch.internals import faults, health
        from pathway_tpu_torch.internals import qtrace as _qtrace

        threads = []
        active = 0
        replayed: Dict[LiveSource, List] = {}
        my_worker = self.engine.worker_id
        sinks = self._sinks
        last_event: Dict[LiveSource, float] = {}

        # operator snapshots (reference: dataflow/persist.rs): restore node
        # state at the persisted frontier, then replay only the log tail
        # appended after the last compaction
        op_mgr = None
        snap_interval = 0.0
        manifest = None
        snap_ms = (
            getattr(self.persistence_config, "snapshot_interval_ms", 0)
            if self.persistence_config is not None
            else 0
        )
        # operator snapshots are opt-in via snapshot_interval_ms > 0
        # (reference: PersistenceMode / operator persisting); the default
        # input-snapshot mode replays the full event log instead
        if self.persistence_config is not None and snap_ms > 0:
            from pathway_tpu_torch.persistence import OperatorSnapshotManager

            op_mgr = OperatorSnapshotManager(
                self.persistence_config.backend._backend,
                self.engine.worker_id,
            )
            snap_interval = snap_ms / 1000.0
            if _sanitizer.ACTIVE:
                # replay-divergence hashing only means something when
                # operator snapshots exist to replay against
                _sanitizer.tracker().enable_replay_hashing()

        def restore_states():
            """Load + apply the newest commonly-restorable operator
            snapshot; returns the restored frontier or None.  Runs once at
            startup and again after each failover rollback."""
            nonlocal manifest
            if op_mgr is None:
                return None
            manifest = op_mgr.load_manifest()
            # phase 1 loads blobs without mutating; phase 2 applies only if
            # EVERY worker can restore the same frontier — a one-sided
            # restore would desync the lockstep clock, and a partial apply
            # would double-count replayed events
            states = (
                op_mgr.load_states(self.engine, manifest)
                if manifest is not None
                else None
            )
            local_time = manifest["time"] if states is not None else -1
            if self.engine.worker_count > 1:
                votes = self.engine.coord.agree(local_time)
                agreed = (
                    votes[0]
                    if all(v == votes[0] for v in votes) and votes[0] >= 0
                    else -1
                )
            else:
                agreed = local_time
            if agreed >= 0:
                op_mgr.apply_states(self.engine, states)
                if _sanitizer.ACTIVE:
                    # rewind this thread's UDF hash accumulators to the
                    # manifest baseline; whatever was accumulated beyond
                    # it (the pre-crash tail) becomes the replay target
                    _sanitizer.tracker().on_restore(manifest)
                return agreed
            return None

        restored_time = restore_states()
        # exactly-once sinks: truncate/roll back anything staged past the
        # restored frontier (post-restore epochs renumber and would
        # collide) and idempotently re-run any commit the previous run's
        # crash interrupted
        for w in self.engine._txn_sinks:
            w.recover(restored_time if restored_time is not None else -1)

        engine_nodes = getattr(self.engine, "_live_nodes", {})

        def node_of(live):
            return engine_nodes.get(live, live.node)

        def compute_replay() -> Dict[LiveSource, List]:
            """(Re-)read the event-log tail each source must replay on top
            of the restored state.  Called at startup and again after a
            failover rollback — the log is written BEFORE batches are
            pushed into the engine (see flush), so it is complete for any
            frontier the group rolls back to."""
            out: Dict[LiveSource, List] = {}
            for live in sinks:
                writer = self._snapshot_writer(live)
                if writer is None:
                    continue
                if restored_time is not None:
                    # operator state restored: replay only the segments
                    # appended after the manifest's folded frontier
                    folded = (manifest or {}).get("folded_through", {})
                    events = writer.read_events(
                        after_segment=folded.get(live.name, -1)
                    )
                elif op_mgr is not None:
                    # restore refused (fresh run, graph change, diverged
                    # workers): consolidated base + every later segment is
                    # the complete history
                    base, base_seg = op_mgr.read_base(live.name)
                    events = base + writer.read_events(
                        after_segment=base_seg
                    )
                else:
                    events = writer.read_events()
                if events:
                    out[live] = events
            return out

        for live in sources:
            if node_of(live) is None:
                continue  # source never built (tree-shaken)
            if live.exclusive and my_worker != live.exclusive_worker:
                # exclusive sources (REST ingress, stateful custom subjects)
                # read on one worker only; a scatter ExchangeNode after the
                # source routes rows to their shard owners
                continue
            subject = live.subject_factory()
            # partitioned subjects divide the input among workers by
            # these coordinates (fs partitioned file ownership, kafka
            # consumer-group analogue)
            subject._worker_id = my_worker
            subject._worker_count = self.engine.worker_count
            sink = _QueueSink(self.queue, live)
            if live.partitioned and self.engine.worker_count > 1:
                # each worker reads DIFFERENT rows, so generated sequence
                # keys must be globally unique — salt the seed per worker
                # (replicated sources need the OPPOSITE: identical seeds,
                # because every worker re-reads the same rows)
                from pathway_tpu_torch.engine.value import seq_key_seed

                sink._seed = seq_key_seed(
                    "live", f"{live.name}@w{my_worker}"
                )
            sink.subject = subject
            sinks[live] = sink
            sink.persistence_enabled = self.persistence_config is not None
            subject._bind(sink)
            if self.persistence_config is not None:
                from pathway_tpu_torch.persistence import CachedObjectStorage

                subject._bind_object_cache(
                    CachedObjectStorage(
                        self.persistence_config.backend._backend, live.name
                    )
                )
            writer = self._snapshot_writer(live)
            if writer is not None:
                state = writer.read_state()
                if state is not None:
                    sink._counter = state.get("counter", 0)
                    subject._restore_persisted_state(state.get("subject"))

            def runner(subject=subject):
                try:
                    subject.run()
                finally:
                    subject.on_stop()
                    subject.close()

            t = threading.Thread(target=runner, daemon=True, name=live.name)
            threads.append(t)
            active += 1
        replayed = compute_replay()
        time = 2  # set per attempt in the run loop below
        started = False
        # chaos directives bind to runs STARTED while they are armed: a
        # driver from before the arming (e.g. a never-terminating
        # webserver pipeline left on a daemon thread) must not tick the
        # harness with its own frozen logical time — it would overwrite
        # the mem-pressure gauge and could even consume one-shot
        # directives meant for the armed run
        chaos_gen = faults.generation()

        pending: Dict[LiveSource, List] = {}
        states: Dict[LiveSource, Any] = {}
        counters: Dict[LiveSource, int] = {}
        last_flush = time_mod.monotonic()
        last_snapshot = time_mod.monotonic()
        # sink freshness: when the oldest event of the batch being
        # accumulated entered the process (None = nothing buffered yet)
        batch_arrival: Optional[float] = None
        dirty_since_snapshot = False
        snapshot_writers = {
            live.name: self._snapshot_writer(live)
            for live in sources
            if node_of(live) is not None and self._snapshot_writer(live) is not None
        }
        multiworker = self.engine.worker_count > 1
        done = False
        # per-live commit bookkeeping: how much of `pending` the subject
        # has committed (flushable), and whether it ever commits at all.
        # The committed-prefix gating matters when a persisted cursor must
        # stay consistent with the logged batch, and for barrier-commit
        # sources whose batch shapes must equal their commit units.
        gate_commits = self.persistence_config is not None
        committed_upto: Dict[LiveSource, int] = {}
        ever_committed: set = set()

        def gated(live) -> bool:
            return gate_commits or live.gated_commits

        def flush():
            """One coordinated flush tick. Multi-worker: every worker makes
            the identical sequence of coordination calls per tick (one
            agree + the shared-scheduled-time loop), so agreement rounds
            align across workers; agree() itself blocks until the slowest
            worker reaches the same tick — that is the frontier protocol."""
            nonlocal time, last_flush, last_snapshot, done
            nonlocal dirty_since_snapshot, batch_arrival
            gen_ok = not faults.ACTIVE or faults.generation() == chaos_gen
            if faults.ACTIVE and gen_ok:
                # deterministic chaos: may raise WorkerKilled (this worker
                # dies at its scheduled epoch, BEFORE voting — peers see a
                # dead peer mid-agree, exactly like a real crash) or sever
                # a peer socket
                faults.on_epoch(my_worker, time, self.engine.coord)
            if health.ENABLED and gen_ok:
                # the closed-loop controller's tick: may drain/re-admit a
                # replica, adjust backpressure, or raise WorkerRestart
                # (rolling restart) — which the failover path absorbs
                # exactly like an injected kill.  Stale-generation runs
                # skip this too while a harness is armed, so an armed
                # chaos run's health actions stay a pure function of its
                # own directive schedule.
                health.on_epoch(my_worker, time, self.engine)
            self.engine.flush_ticks = getattr(self.engine, "flush_ticks", 0) + 1
            has_data = any(
                (committed_upto.get(live, 0) > 0 or not gated(live)
                 or live not in ever_committed)
                and bool(d)
                for live, d in pending.items()
            )
            local_done = active <= 0 and not has_data
            term = self.engine.terminate_flag.is_set()
            snap_due = op_mgr is not None and (
                time_mod.monotonic() - last_snapshot
            ) >= snap_interval
            if multiworker:
                # ONE agreement round per tick: termination, snapshot
                # cadence AND the earliest scheduled temporal time all ride
                # the same vote (a unilateral break would strand peers in
                # agree(); a unilateral snapshot would diverge manifests;
                # a separate global_next_time round would double the
                # coordination cost of every idle tick)
                votes = self.engine.coord.agree(
                    (
                        has_data,
                        local_done,
                        term,
                        snap_due,
                        self.engine.next_scheduled_time(),
                    )
                )
                any_data = any(v[0] for v in votes)
                done = all(v[1] for v in votes) or any(v[2] for v in votes)
                snap_due = any(v[3] for v in votes)
                nxt_votes = [v[4] for v in votes if v[4] is not None]
                agreed_next = min(nxt_votes) if nxt_votes else None
            else:
                any_data = has_data
                done = local_done or term
                agreed_next = None  # single-worker re-samples post-batch
            processed_batch = None
            if any_data:
                flush_started = time_mod.monotonic()
                for live in list(pending.keys()):
                    deltas = pending[live]
                    if not deltas:
                        continue
                    # exactly-once under persistence: only the prefix up to
                    # the subject's last commit flushes with the committed
                    # cursor state; the uncommitted tail waits for its own
                    # commit. Sources that never commit (autocommit-only)
                    # flush everything with the counter cursor, as before.
                    # Without persistence there is no cursor to keep
                    # consistent, so nothing is ever withheld.
                    if gated(live) and live in ever_committed:
                        cut = committed_upto.get(live, 0)
                        batch, tail = deltas[:cut], deltas[cut:]
                        pending[live] = tail
                        committed_upto[live] = 0
                    else:
                        batch, tail = deltas, []
                        pending[live] = []
                    if not batch:
                        continue
                    writer = self._snapshot_writer(live)
                    if writer is not None:
                        state = states.pop(live, None) or {}
                        state["counter"] = counters.get(live, 0)
                        writer.write_batch(batch, state)
                    node_of(live).push(time, batch)
                    if _qtrace.ENABLED:
                        # stamp queries leaving the connector buffer for the
                        # engine tick (no-op unless a query is in flight)
                        _qtrace.tracker().mark_batch(batch, "picked")
                # sink freshness: stamp when this epoch's data entered the
                # process (oldest buffered event, or now for commit-only
                # flushes) — SubscribeNode sinks close the interval at
                # on_time_end inside this process_time call
                m = self.engine.metrics
                if m is not None:
                    m.note_ingest(
                        time,
                        batch_arrival
                        if batch_arrival is not None
                        else flush_started,
                    )
                batch_arrival = None
                self.engine.process_time(time)
                # observability: batch latency + per-source read counters
                # (reference: src/connectors/monitoring.rs surfaces the
                # same per-connector numbers)
                self.engine.last_batch_latency_ms = (
                    time_mod.monotonic() - flush_started
                ) * 1000.0
                stats = getattr(self.engine, "connector_stats", None)
                if stats is None:
                    stats = self.engine.connector_stats = {}
                now_ = time_mod.monotonic()
                for live_, cnt in counters.items():
                    subj = getattr(sinks.get(live_), "subject", None)
                    stats[live_.name] = {
                        "rows_read": cnt,
                        "pending": len(pending.get(live_, ())),
                        "read_lag_s": now_ - last_event.get(live_, now_),
                        "retries": getattr(subj, "_retries", 0),
                        "backoff_s": round(
                            getattr(subj, "_backoff_s", 0.0), 6
                        ),
                    }
                dirty_since_snapshot = True
                processed_batch = time
                time += 2
            if snap_due and op_mgr is not None and dirty_since_snapshot:
                # quiescent frontier: the last time is fully processed and
                # queues are drained — checkpoint operator state + compact
                # logs (multi-worker: snap_due was agreed, and any_data is
                # agreed, so every worker saves the same frontier).
                # Exactly-once sinks ride the same commit point: staged
                # BEFORE the manifest, finalized only after the manifest
                # landed — a crash anywhere in between either replays the
                # epoch (pre-manifest) or idempotently re-finalizes
                # (post-manifest), never both.
                frontier = time - 2
                txn = self.engine._txn_sinks
                saved = False
                try:
                    for w in txn:
                        w.prepare(frontier)
                    saved = op_mgr.save(
                        self.engine, frontier, snapshot_writers
                    )
                    if saved:
                        for w in txn:
                            w.commit(frontier)
                        if txn:
                            self.engine.sink_txn_commits += 1
                except Exception as exc:  # noqa: BLE001 — store failure
                    # a failed stage/finalize never kills the job: staged
                    # blobs stay provisional, and the next successful
                    # snapshot (or recover on restart) finalizes or rolls
                    # them back idempotently
                    self.engine.warn_once(
                        f"sink-txn-{type(exc).__name__}",
                        "snapshot sink transaction at frontier %s failed "
                        "(%s: %s) — continuing, the next snapshot retries",
                        frontier,
                        type(exc).__name__,
                        exc,
                    )
                if saved:
                    dirty_since_snapshot = False
                # failed save: staged sink blobs stay; the next successful
                # commit (or recover on restart) finalizes them
                last_snapshot = time_mod.monotonic()
            # run scheduled times that are due.  Multi-worker: the first
            # due time came from the tick vote (no extra round) — times
            # scheduled DURING this tick surface on the next vote, one
            # autocommit later, which keeps the agreement sequence
            # identical on every worker.  Single-worker re-samples locally
            # (free), so cascades still flush immediately.
            nxt = (
                agreed_next
                if multiworker
                else self.engine.next_scheduled_time()
            )
            first = True
            while nxt is not None and nxt <= time:
                # the voted time was sampled pre-batch: on the FIRST
                # iteration it may equal the batch time just processed —
                # skip that one (processed_batch and the vote are agreed,
                # so every worker skips together).  Later iterations come
                # from global_next_time over genuinely scheduled times
                # (including cascades) and always process.
                if not (first and nxt == processed_batch):
                    self.engine.process_time(nxt)
                first = False
                nxt = self.engine.global_next_time()
            last_flush = time_mod.monotonic()

        # live failover: with snapshots on and a failover-capable
        # coordinator, a peer death surfaces as FailoverRequired out of a
        # coordination wait instead of a fatal error; survivors roll back
        # to the last persisted frontier and a replacement worker rejoins
        # the SAME run — the job never restarts.
        coord = self.engine.coord
        if (
            op_mgr is not None
            and self.engine.worker_count > 1
            and hasattr(coord, "enable_failover")
        ):
            coord.enable_failover()
        max_failovers = int(os.environ.get("PATHWAY_MAX_FAILOVERS", "3"))
        failovers = 0
        failover_started = 0.0
        while True:
            try:
                if failovers:
                    # roll back: drop in-flight engine state, re-restore the
                    # snapshot every worker (incl. the replacement) agrees
                    # on, re-read the event-log tail past that frontier.
                    # The driver's own pending/queues survive — they hold
                    # data never yet pushed into the engine.
                    self.engine.reset_for_rollback()
                    restored_time = restore_states()
                    if restored_time is None:
                        raise EngineError(
                            "failover rollback failed: no commonly "
                            "restorable operator snapshot"
                        )
                    for w in self.engine._txn_sinks:
                        w.recover(restored_time)
                    replayed = compute_replay()
                    done = False
                    dirty_since_snapshot = False
                    last_snapshot = time_mod.monotonic()
                # initial time 0 processes static parts of the graph (a
                # restored run re-runs it harmlessly: restored source state
                # marks static rows as already emitted)
                self.engine.process_time(0)
                # replay persisted input snapshots as the first batch
                # (reference: rewind_from_disk_snapshot,
                # connectors/mod.rs:256). After an operator-snapshot restore
                # the log holds only the tail appended since the last
                # compaction; it replays on top of restored state.
                # Multi-worker: the replay step happens on every worker if
                # it happens anywhere so the lockstep time sequence stays
                # identical.
                time = 2 if restored_time is None else restored_time + 2
                if self.engine.global_any(bool(replayed)):
                    for live, events in replayed.items():
                        node_of(live).push(time, events)
                    self.engine.process_time(time)
                    time += 2
                if failovers:
                    self.engine.failover_count = failovers
                    self.engine.last_failover_recovery_s = (
                        time_mod.monotonic() - failover_started
                    )
                if not started:
                    start_t = time_mod.monotonic()
                    for live in sinks:
                        last_event[live] = start_t
                    for t in threads:
                        t.start()
                    started = True
                while not done:
                    throttled = 0.0
                    if health.ENABLED:
                        # adaptive backpressure: while the controller
                        # holds pressure, pace ingest with its
                        # Backoff-derived delay (0.0 otherwise)
                        throttle = health.controller().throttle_delay()
                        if throttle > 0.0:
                            time_mod.sleep(throttle)
                            throttled = throttle
                    # the pacing sleep does not count toward the autocommit
                    # deadline: a delay as long as the autocommit interval
                    # would otherwise flush every tick before reading and
                    # never read the queue again
                    timeout = max(
                        0.0,
                        self.autocommit_s
                        - (time_mod.monotonic() - last_flush - throttled),
                    )
                    if timeout == 0.0:
                        # autocommit deadline passed — flush even if the
                        # queue never drains (a hot source must not starve
                        # the global barrier that idle peers are blocked on)
                        flush()
                        continue
                    try:
                        events = [self.queue.get(timeout=timeout)]
                    except queue_mod.Empty:
                        flush()
                        continue
                    # drain whatever already queued up: events that arrived
                    # while the engine was busy coalesce into ONE batch —
                    # server-side micro-batching that amortizes the
                    # per-dispatch device round trip across concurrent
                    # requests (reference: commit ticks group per-duration;
                    # here load itself sets the batch size).  Bounded so a
                    # hot source cannot starve the autocommit deadline /
                    # multi-worker barrier.
                    drain_budget = 4096
                    if health.ENABLED:
                        # backpressure shrinks the micro-batch coalescing
                        # bound too: smaller engine batches while memory
                        # or the host is the bottleneck
                        drain_budget = health.controller().ingest_budget(4096)
                    while len(events) < drain_budget:
                        try:
                            ev = self.queue.get_nowait()
                        except queue_mod.Empty:
                            break
                        events.append(ev)
                        if ev[0] == "commit_b" and not multiworker:
                            # barrier commit: later rows must not coalesce
                            # into this tick — deterministic batch
                            # boundaries for the bulk-ingest pipeline
                            # (multi-worker keeps timer ticks so the
                            # agreement cadence stays identical everywhere)
                            break
                    needs_flush = False
                    now_ev = time_mod.monotonic()
                    for kind, live, payload, counter in events:
                        counters[live] = max(counters.get(live, 0), counter)
                        last_event[live] = now_ev
                        if kind == "data":
                            pending.setdefault(live, []).append(payload)
                            if batch_arrival is None:
                                batch_arrival = now_ev
                        elif kind == "data_batch":
                            pending.setdefault(live, []).extend(payload)
                            if batch_arrival is None:
                                batch_arrival = now_ev
                        elif kind in ("commit", "commit_b"):
                            if payload is not None:
                                states[live] = payload
                            committed_upto[live] = len(
                                pending.get(live, [])
                            )
                            ever_committed.add(live)
                            # multi-worker: commits buffer until the timer
                            # tick so every worker performs the same number
                            # of coordination rounds
                            needs_flush = True
                        elif kind == "close":
                            active -= 1
                            # close is an implicit final commit: the source
                            # is gone, its uncommitted tail is final data
                            committed_upto[live] = len(
                                pending.get(live, [])
                            )
                            needs_flush = True
                    if needs_flush and not multiworker:
                        flush()
                    if not multiworker and self.engine.terminate_flag.is_set():
                        break
                break
            except FailoverRequired as exc:
                failovers += 1
                if (
                    op_mgr is None
                    or failovers > max_failovers
                    or not hasattr(coord, "failover_rendezvous")
                ):
                    raise
                self.engine.warn_once(
                    f"failover{failovers}",
                    "worker failover %s/%s (%s) — rolling back to the "
                    "last snapshot and waiting for the replacement",
                    failovers,
                    max_failovers,
                    exc,
                )
                failover_started = time_mod.monotonic()
                coord.failover_rendezvous()
        self.engine.finish()
