"""pw.persistence — input snapshots + resume (reference:
python/pathway/persistence/__init__.py Backend:27-99, Config:116; engine side
src/persistence/input_snapshot.rs:286, backends/mod.rs:76).

Model: each named connector's parsed events append to a chunked log at every
commit, together with the subject's own cursor state (file mtimes, offsets).
On restart the log replays into the engine as the first batch and the
subject resumes from its cursor — the reference's input-snapshot mode.
Operator snapshots (differential arrangement state) are subsumed here by
deterministic replay of the compact input log.
"""

from __future__ import annotations

import os
import pickle
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import faults, memtrack
from pathway_tpu_torch.internals import sanitizer as _sanitizer


def _store_fault(key: str) -> None:
    """Fault-injection hook on every backend write (store_fail directive);
    one boolean read when the harness is disarmed."""
    if faults.ACTIVE:
        faults.store_put(key)


# Bump whenever the meaning of persisted state changes — key derivation
# schemes, delta encodings, snapshot layouts.  Restores from a different
# version fall back to full replay instead of silently mixing old keys
# with new derivation (v2: FlattenNode key finalizer changed).
SNAPSHOT_FORMAT_VERSION = 2


def graph_fingerprint(engine) -> List[Tuple[int, str, str, int]]:
    """Stable per-node identity: (position, class name, operator name,
    input arity) for every engine node.  Restoring pickled operator state
    by index is only safe when the whole sequence matches — a changed
    filter predicate or two reordered operators keep the node COUNT equal
    while shifting what each index means."""
    return [
        (idx, type(node).__name__, getattr(node, "name", ""), len(node.inputs))
        for idx, node in enumerate(engine.nodes)
    ]


def _unpicklable_path(obj: Any, prefix: str = "state", depth: int = 4) -> Optional[str]:
    """Best-effort dotted path to the first unpicklable leaf inside a
    node's snapshot state, so the skip diagnostics say WHICH attribute
    disabled the snapshot (`state['accum'].lock`), not just which node.
    Returns None when `obj` pickles fine."""
    try:
        pickle.dumps(obj)
        return None
    except Exception:  # noqa: BLE001 — any pickle failure counts
        pass
    if depth > 0:
        if isinstance(obj, dict):
            items = [(f"{prefix}[{k!r}]", v) for k, v in obj.items()]
        elif isinstance(obj, (list, tuple)):
            items = [(f"{prefix}[{i}]", v) for i, v in enumerate(obj)]
        else:
            d = getattr(obj, "__dict__", None)
            items = (
                [(f"{prefix}.{k}", v) for k, v in d.items()] if d else []
            )
        for path, v in items:
            found = _unpicklable_path(v, path, depth - 1)
            if found is not None:
                return found
    return prefix


class PersistenceBackend:
    """K/V store interface (reference: persistence/backends/mod.rs:76)."""

    def put_value(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get_value(self, key: str) -> bytes | None:
        raise NotImplementedError

    def append(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def read_appended(self, key: str) -> List[bytes]:
        raise NotImplementedError

    def list_keys(self) -> List[str]:
        raise NotImplementedError

    def truncate(self, key: str) -> None:
        """Drop an append log / value (log compaction after an operator
        snapshot bakes its events into operator state)."""
        raise NotImplementedError


class FilesystemBackend(PersistenceBackend):
    def __init__(self, path: str):
        self.root = path
        os.makedirs(path, exist_ok=True)
        self._locks: Dict[str, threading.Lock] = {}

    def _path(self, key: str) -> str:
        safe = key.replace("/", "__")
        return os.path.join(self.root, safe)

    def put_value(self, key: str, value: bytes) -> None:
        _store_fault(key)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)

    def get_value(self, key: str) -> bytes | None:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def append(self, key: str, value: bytes) -> None:
        _store_fault(key)
        with open(self._path(key), "ab") as f:
            f.write(len(value).to_bytes(8, "little"))
            f.write(value)

    def read_appended(self, key: str) -> List[bytes]:
        path = self._path(key)
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                n = int.from_bytes(header, "little")
                chunk = f.read(n)
                if len(chunk) < n:
                    break  # torn tail write from a crash — ignore
                out.append(chunk)
        return out

    def list_keys(self) -> List[str]:
        return os.listdir(self.root)

    def truncate(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)


class MockBackend(PersistenceBackend):
    """In-memory backend for tests (reference: backends/mock.rs)."""

    def __init__(self, store: Dict[str, Any] | None = None):
        self.values: Dict[str, bytes] = (store or {}).setdefault("values", {}) if isinstance(store, dict) else {}
        self.logs: Dict[str, List[bytes]] = {}
        if isinstance(store, dict):
            self.logs = store.setdefault("logs", {})

    def put_value(self, key, value):
        _store_fault(key)
        self.values[key] = value

    def get_value(self, key):
        return self.values.get(key)

    def append(self, key, value):
        _store_fault(key)
        self.logs.setdefault(key, []).append(value)

    def read_appended(self, key):
        return list(self.logs.get(key, []))

    def list_keys(self):
        return list(set(self.values) | set(self.logs))

    def truncate(self, key):
        self.values.pop(key, None)
        self.logs.pop(key, None)


class ObjectStoreBackend(PersistenceBackend):
    """Persistence over any object store with put/get/delete/list
    (reference: persistence/backends/s3.rs, azure.rs — a K/V trait over
    immutable objects).

    Objects are immutable, so `append` is emulated with numbered chunk
    objects under `<key>/log.<n>`; `read_appended` lists and sorts them.
    The client interface is minimal and injectable for tests:
    put(key, bytes), get(key) -> bytes|None, delete(key), list(prefix) ->
    [key]."""

    def __init__(self, client, prefix: str = ""):
        self.client = client
        self.prefix = prefix.strip("/")
        self._counters: Dict[str, int] = {}

    def _full(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put_value(self, key, value):
        _store_fault(key)
        self.client.put(self._full(key), value)

    def get_value(self, key):
        return self.client.get(self._full(key))

    def append(self, key, value):
        _store_fault(key)
        n = self._counters.get(key)
        if n is None:
            existing = self.client.list(self._full(key) + "/log.")
            n = len(existing)
        self.client.put(self._full(key) + f"/log.{n:08d}", value)
        self._counters[key] = n + 1

    def read_appended(self, key):
        names = sorted(self.client.list(self._full(key) + "/log."))
        out = []
        for name in names:
            blob = self.client.get(name)
            if blob is not None:
                out.append(blob)
        return out

    def list_keys(self):
        skip = len(self.prefix) + 1 if self.prefix else 0
        return [k[skip:] for k in self.client.list(self.prefix)]

    def truncate(self, key):
        for name in self.client.list(self._full(key) + "/log."):
            self.client.delete(name)
        self.client.delete(self._full(key))
        self._counters.pop(key, None)


class _Boto3ObjectClient:
    """S3 client adapter (gated on boto3; injectable fake in tests)."""

    def __init__(self, bucket: str, **kwargs):
        import boto3  # type: ignore

        self.bucket = bucket
        self.client = boto3.client("s3", **kwargs)

    def put(self, key, value):
        self.client.put_object(Bucket=self.bucket, Key=key, Body=value)

    def get(self, key):
        try:
            resp = self.client.get_object(Bucket=self.bucket, Key=key)
        except Exception:  # noqa: BLE001 — NoSuchKey and friends
            return None
        return resp["Body"].read()

    def delete(self, key):
        self.client.delete_object(Bucket=self.bucket, Key=key)

    def list(self, prefix):
        out = []
        paginator = self.client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                out.append(obj["Key"])
        return out


class _AzureBlobClient:
    """Azure Blob adapter (gated on azure-storage-blob)."""

    def __init__(self, container: str, connection_string: str | None = None, **kwargs):
        from azure.storage.blob import BlobServiceClient  # type: ignore

        if connection_string is not None:
            service = BlobServiceClient.from_connection_string(
                connection_string, **kwargs
            )
        else:
            service = BlobServiceClient(**kwargs)
        self.container = service.get_container_client(container)

    def put(self, key, value):
        self.container.upload_blob(key, value, overwrite=True)

    def get(self, key):
        try:
            return self.container.download_blob(key).readall()
        except Exception:  # noqa: BLE001
            return None

    def delete(self, key):
        try:
            self.container.delete_blob(key)
        except Exception:  # noqa: BLE001
            pass

    def list(self, prefix):
        return [
            b.name for b in self.container.list_blobs(name_starts_with=prefix)
        ]


class Backend:
    """Factory namespace (reference: persistence/__init__.py Backend:27)."""

    def __init__(self, engine_backend: PersistenceBackend):
        self._backend = engine_backend

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls(FilesystemBackend(path))

    @classmethod
    def mock(cls, events: Dict | None = None) -> "Backend":
        return cls(MockBackend(events))

    @classmethod
    def s3(
        cls,
        root_path: str,
        bucket_settings=None,
        *,
        _client=None,
        **client_kwargs,
    ) -> "Backend":
        """root_path: s3://bucket/prefix (reference: backends/s3.rs).
        Tests inject `_client`; production uses boto3 credentials from the
        standard chain or `bucket_settings`."""
        bucket, _, prefix = root_path.removeprefix("s3://").partition("/")
        if _client is None:
            if isinstance(bucket_settings, dict):
                client_kwargs.update(bucket_settings)
            _client = _Boto3ObjectClient(bucket, **client_kwargs)
        return cls(ObjectStoreBackend(_client, prefix))

    @classmethod
    def azure(
        cls,
        root_path: str,
        *,
        account=None,
        password=None,
        connection_string=None,
        _client=None,
        **client_kwargs,
    ) -> "Backend":
        """root_path: az://container/prefix (reference: backends/azure.rs)."""
        container, _, prefix = root_path.removeprefix("az://").partition("/")
        if _client is None:
            _client = _AzureBlobClient(
                container, connection_string=connection_string, **client_kwargs
            )
        return cls(ObjectStoreBackend(_client, prefix))


class Config:
    """reference: persistence/__init__.py Config:116."""

    def __init__(
        self,
        backend: Backend,
        *,
        snapshot_interval_ms: int = 0,
        snapshot_access=None,
        persistence_mode=None,
        continue_after_replay: bool = True,
    ):
        self.backend = backend
        self.snapshot_interval_ms = snapshot_interval_ms
        self.persistence_mode = persistence_mode
        self.continue_after_replay = continue_after_replay

    # legacy alias used by reference code: Config.simple_config
    @classmethod
    def simple_config(cls, backend: Backend, **kwargs) -> "Config":
        return cls(backend, **kwargs)

    # run-lifecycle hooks (reference: persistence Config.on_before_run /
    # on_after_run — env setup/teardown for cloud backends); the backend
    # gets first refusal so e.g. an S3 backend can stage credentials
    def on_before_run(self) -> None:
        hook = getattr(self.backend, "on_before_run", None)
        if hook is not None:
            hook()

    def on_after_run(self) -> None:
        hook = getattr(self.backend, "on_after_run", None)
        if hook is not None:
            hook()


class OperatorSnapshotManager:
    """Checkpoint operator state keyed by frontier + compact input logs
    (reference: src/persistence/operator_snapshot.rs:231 snapshot
    writer/merger, tracker.rs:51 frontier commit, dataflow/persist.rs).

    At a quiescent frontier (all node queues drained after `process_time`),
    every stateful node's `snapshot_state()` is pickled under an
    epoch-versioned key `opsnap/<worker>/<epoch>/<node-idx>`; the manifest
    is written LAST and names the epoch, so a crash mid-save leaves the old
    manifest pointing at the old epoch's intact blobs (commit-last
    atomicity, like the reference's snapshot writer). Before the event logs
    are truncated, their deltas merge into a *consolidated base log* per
    source — so even if a later restart cannot restore operator state (the
    graph changed, a blob is missing), full replay of base + tail loses
    nothing. Restore is two-phase: `load_states` reads and unpickles
    without mutating (multi-worker agreement can veto), `apply_states`
    commits. A node whose state fails to pickle is skipped (warn-once)
    and recorded in the manifest as `skipped_nodes`; such a snapshot
    still compacts the logs but restore refuses it (full replay of the
    consolidated base loses nothing). A backend write failure aborts the
    save entirely — the previous manifest and the event logs stay intact
    and the job continues."""

    def __init__(self, backend: PersistenceBackend, worker_id: int = 0):
        self.backend = backend
        self.worker_id = worker_id
        self.manifest_key = f"opsnap/{worker_id}/manifest"

    def _base_key(self, name: str, epoch: int) -> str:
        return f"snapshot/{self.worker_id}/{name}/base.{epoch:016d}"

    def _list_base_epochs(self, name: str) -> List[int]:
        marker = f"snapshot/{self.worker_id}/{name}/base.".replace("/", "__")
        out = []
        for key in self.backend.list_keys():
            flat = key.replace("/", "__")
            if flat.startswith(marker):
                try:
                    out.append(int(flat[len(marker):][:16]))
                except ValueError:
                    continue
        return sorted(set(out))

    def save(
        self, engine, time: int, writers: Dict[str, "InputSnapshotWriter"]
    ) -> bool:
        """Crash-safe ordering: (1) seal log segments, (2) stage the new
        consolidated bases and state blobs under epoch-versioned keys,
        (3) write the manifest — the single commit point, (4) clean up old
        segments/bases/blobs. A crash before (3) leaves the previous
        manifest + its intact epoch; a crash after (3) only leaves garbage
        that the next save deletes. Replay never double-applies because the
        manifest records `folded_through` per source and the restore path
        replays only later segments."""
        import logging

        states: List[Tuple[int, bytes]] = []
        skipped: List[int] = []
        for idx, node in enumerate(engine.nodes):
            state = node.snapshot_state()
            if state is None:
                continue
            try:
                states.append((idx, pickle.dumps(state)))
            except Exception as exc:  # noqa: BLE001 — unpicklable state
                # skip only this node: the manifest records it so restore
                # refuses the partial snapshot and full-replays instead
                skipped.append(idx)
                path = _unpicklable_path(state) or "state"
                warn_once = getattr(engine, "warn_once", None)
                msg = (
                    "operator snapshot skips node %d (%s): state does not "
                    "pickle at %s: %s"
                )
                if warn_once is not None:
                    warn_once(f"snapshot-unpicklable-{idx}", msg, idx,
                              node.name, path, exc)
                else:
                    logging.getLogger("pathway_tpu_torch").warning(
                        msg, idx, node.name, path, exc
                    )
                # structured twin of the warn-once: a flight event naming
                # the offending attribute path (the static PWT904 finding
                # points at the same capture before the run ever starts)
                m = getattr(engine, "metrics", None)
                if m is not None:
                    m.recorder.record(
                        "snapshot_skip",
                        time=time,
                        node=idx,
                        name=f"{node.name}: unpicklable at {path}",
                        errors=1,
                    )

        if memtrack.ENABLED:
            # host-RAM staging footprint of this save (pickled state
            # blobs held until the manifest commits); the entry persists
            # as "what the last snapshot staged" and dies with the manager
            memtrack.tracker().register(
                "snapshot_staging",
                self,
                sum(len(blob) for _, blob in states),
                tier="host",
                nodes=len(states),
            )
        try:
            return self._save_committed(engine, time, writers, states, skipped)
        except Exception as exc:  # noqa: BLE001 — backend write failed
            logging.getLogger("pathway_tpu_torch").warning(
                "operator snapshot at frontier %s failed (%s: %s); job "
                "continues, previous snapshot and event logs kept",
                time,
                type(exc).__name__,
                exc,
            )
            return False

    def _save_committed(
        self,
        engine,
        time: int,
        writers: Dict[str, "InputSnapshotWriter"],
        states: List[Tuple[int, bytes]],
        skipped: List[int],
    ) -> bool:
        from pathway_tpu_torch.engine.stream import consolidate

        epoch = time
        folded_through: Dict[str, int] = {}
        for name, writer in writers.items():
            sealed = writer.start_new_segment()
            folded_through[name] = sealed
            prev_deltas, prev_seg = self.read_base(name)
            # fold sealed segments the previous base has not folded yet
            tail = [
                d
                for seg in writer.list_segments()
                if prev_seg < seg <= sealed
                for d in writer.read_segment(seg)
            ]
            merged = consolidate(prev_deltas + tail)
            self.backend.put_value(
                self._base_key(name, epoch),
                pickle.dumps(
                    {"folded_through": sealed, "deltas": merged}
                ),
            )
        for idx, blob in states:
            self.backend.put_value(
                f"opsnap/{self.worker_id}/{epoch}/{idx}", blob
            )
        prev = self.load_manifest()
        # commit point
        self.backend.put_value(
            self.manifest_key,
            pickle.dumps(
                {
                    "time": time,
                    "epoch": epoch,
                    "format_version": SNAPSHOT_FORMAT_VERSION,
                    "node_count": len(engine.nodes),
                    "graph_fingerprint": graph_fingerprint(engine),
                    "state_nodes": [idx for idx, _ in states],
                    "skipped_nodes": skipped,
                    "folded_through": folded_through,
                    # replay-divergence baselines (PATHWAY_SANITIZE):
                    # per-UDF [rows, hash] as of this snapshot's frontier
                    "udf_hashes": (
                        _sanitizer.tracker().hashes_for_manifest()
                        if _sanitizer.ACTIVE
                        and _sanitizer.tracker().hashing
                        else None
                    ),
                }
            ),
        )
        # cleanup: sealed segments are folded; older epochs superseded
        for name, writer in writers.items():
            writer.drop_segments_through(folded_through[name])
            for e in self._list_base_epochs(name):
                if e != epoch:
                    self.backend.truncate(self._base_key(name, e))
        if prev is not None and prev.get("epoch") not in (None, epoch):
            for idx in prev.get("state_nodes", []):
                self.backend.truncate(
                    f"opsnap/{self.worker_id}/{prev['epoch']}/{idx}"
                )
        return True

    def load_manifest(self) -> dict | None:
        blob = self.backend.get_value(self.manifest_key)
        if blob is None:
            return None
        try:
            return pickle.loads(blob)
        except Exception:  # noqa: BLE001
            return None

    def load_states(self, engine, manifest: dict) -> Dict[int, dict] | None:
        """Phase 1: read + unpickle every state blob WITHOUT touching the
        engine. None = unusable (graph changed / blob missing / corrupt)."""
        # a snapshot written under another format version (or before
        # versioning existed) may encode keys/state the current code
        # derives differently — full replay is the only safe restore
        if manifest.get("format_version") != SNAPSHOT_FORMAT_VERSION:
            return None
        if manifest.get("node_count") != len(engine.nodes):
            return None
        # same node COUNT is not the same GRAPH: a changed predicate or a
        # reordered pair of operators would restore state into the wrong
        # nodes by index.  Refuse on any per-node fingerprint mismatch so
        # the caller falls back to consolidated-base full replay (the
        # reference keys snapshots by stable persistent operator ids).
        if manifest.get("graph_fingerprint") != graph_fingerprint(engine):
            return None
        # a snapshot that skipped unpicklable nodes is incomplete by
        # construction — replaying the consolidated base rebuilds every
        # node's state, restoring the others by index would not
        if manifest.get("skipped_nodes"):
            return None
        epoch = manifest.get("epoch", manifest.get("time"))
        states: Dict[int, dict] = {}
        for idx in manifest.get("state_nodes", []):
            blob = self.backend.get_value(
                f"opsnap/{self.worker_id}/{epoch}/{idx}"
            )
            if blob is None:
                return None
            try:
                states[idx] = pickle.loads(blob)
            except Exception:  # noqa: BLE001
                return None
        return states

    def apply_states(self, engine, states: Dict[int, dict]) -> None:
        """Phase 2: commit (after any multi-worker agreement)."""
        for idx, state in states.items():
            engine.nodes[idx].restore_state(state)

    def read_base(self, name: str) -> Tuple[List, int]:
        """Latest readable consolidated base: (deltas, folded_through).
        (-1 = nothing folded; replay every segment.)"""
        for epoch in reversed(self._list_base_epochs(name)):
            blob = self.backend.get_value(self._base_key(name, epoch))
            if blob is None:
                continue
            try:
                data = pickle.loads(blob)
                return data["deltas"], data["folded_through"]
            except Exception:  # noqa: BLE001
                continue
        return [], -1


class InputSnapshotWriter:
    """Segmented event log per source per worker (reference:
    input_snapshot.rs:286 chunked event logs).

    Events append to `snapshot/<worker>/<name>/events.<segment>`; a
    snapshot rolls the writer onto a fresh segment so compaction folds only
    sealed segments (no read/truncate race with ongoing appends), and the
    worker scoping makes each log single-writer — the contract
    `PersistenceBackend.append` requires."""

    def __init__(
        self, backend: PersistenceBackend, source_name: str, worker_id: int = 0
    ):
        self.backend = backend
        self.prefix = f"snapshot/{worker_id}/{source_name}"
        self.state_key = f"{self.prefix}/state"
        self.segptr_key = f"{self.prefix}/segptr"
        segs = self.list_segments()
        # the segment pointer survives compaction deleting every segment
        # file: without it a restart would reuse a sealed segment number
        # and the replay cursor (folded_through) would skip its events
        ptr = 0
        blob = self.backend.get_value(self.segptr_key)
        if blob is not None:
            try:
                ptr = int(blob.decode())
            except ValueError:
                ptr = 0
        self.active_segment = max(segs[-1] if segs else 0, ptr)

    def _segment_key(self, seg: int) -> str:
        return f"{self.prefix}/events.{seg:08d}"

    _SEGMENT_RE = re.compile(r"events\.(\d{8})(?:$|/)")

    def list_segments(self) -> List[int]:
        # Extract the segment id from the `events.<seg>` path component
        # itself.  ObjectStoreBackend emulates append by storing chunks
        # under `<key>/log.<n>`, so the final dot-suffix of a listed key is
        # the CHUNK number, not the segment number — splitting on the last
        # '.' would invent phantom segments there.
        out = []
        marker = self.prefix.replace("/", "__") + "__events."
        for key in self.backend.list_keys():
            if marker in key.replace("/", "__"):
                m = self._SEGMENT_RE.search(key)
                if m:
                    out.append(int(m.group(1)))
        return sorted(set(out))

    def start_new_segment(self) -> int:
        """Seal the active segment; returns the sealed segment number."""
        sealed = self.active_segment
        self.active_segment = sealed + 1
        self.backend.put_value(
            self.segptr_key, str(self.active_segment).encode()
        )
        return sealed

    def write_batch(self, deltas, subject_state=None) -> None:
        if deltas:
            self.backend.append(
                self._segment_key(self.active_segment), pickle.dumps(deltas)
            )
        if subject_state is not None:
            self.backend.put_value(self.state_key, pickle.dumps(subject_state))

    def read_segment(self, seg: int) -> List:
        out = []
        for chunk in self.backend.read_appended(self._segment_key(seg)):
            try:
                out.extend(pickle.loads(chunk))
            except Exception:  # noqa: BLE001 — torn chunk at crash point
                break
        return out

    def read_events(self, after_segment: int = -1) -> List:
        out: List = []
        for seg in self.list_segments():
            if seg > after_segment:
                out.extend(self.read_segment(seg))
        return out

    def drop_segments_through(self, seg: int) -> None:
        for s in self.list_segments():
            if s <= seg:
                self.backend.truncate(self._segment_key(s))

    def read_state(self):
        blob = self.backend.get_value(self.state_key)
        if blob is None:
            return None
        try:
            return pickle.loads(blob)
        except Exception:  # noqa: BLE001
            return None


class SinkCommitLog:
    """Durable per-(worker, sink) commit metadata for exactly-once output.

    Output written for epoch T only becomes durable when the operator
    snapshot frontier reaches >= T — everything newer is provisional and
    rolled back on recovery, then regenerated by replay.  The commit log
    carries that protocol: one atomically-replaced marker record

        {"frontier": F,          # highest finalized commit frontier
         "offsets": {F: bytes},  # file length per frontier (truncate
                                 # recovery for append-style sinks)
         "staged": [F...]}       # staged-payload frontiers awaiting
                                 # finalize (buffered sinks: postgres/mq)

    plus one staged-payload blob per prepared frontier.  Atomicity comes
    from the ordering against the operator-snapshot manifest, the run's
    single commit point:

      prepare(F):  record_offset / stage — BEFORE the manifest, so the
                   restore frontier M always has its entry;
      commit(F):   mark_committed / apply staged — AFTER the manifest,
                   idempotent, re-runnable by recover(M) after a crash.
    """

    _KEEP_OFFSETS = 8

    def __init__(
        self, backend: PersistenceBackend, name: str, worker_id: int = 0
    ):
        self.backend = backend
        self.prefix = f"sinkcommit/{worker_id}/{name}"
        self._marker_key = f"{self.prefix}/marker"
        self._rec = self._load()

    def _load(self) -> Dict[str, Any]:
        blob = self.backend.get_value(self._marker_key)
        if blob is not None:
            try:
                rec = pickle.loads(blob)
                if isinstance(rec, dict):
                    rec.setdefault("frontier", -1)
                    rec.setdefault("offsets", {})
                    rec.setdefault("staged", [])
                    return rec
            except Exception:  # noqa: BLE001 — torn write
                pass
        return {"frontier": -1, "offsets": {}, "staged": []}

    def _write(self) -> None:
        self.backend.put_value(self._marker_key, pickle.dumps(self._rec))

    def _stage_key(self, frontier: int) -> str:
        return f"{self.prefix}/stage.{frontier:016d}"

    def committed_frontier(self) -> int:
        return self._rec["frontier"]

    # -- file-offset protocol (append-style sinks: jsonlines/csv) --------

    def record_offset(self, frontier: int, offset: int) -> None:
        offsets = self._rec["offsets"]
        offsets[frontier] = offset
        for f in sorted(offsets)[: -self._KEEP_OFFSETS]:
            del offsets[f]
        self._write()

    def offset_for(self, frontier: int) -> Optional[int]:
        return self._rec["offsets"].get(frontier)

    # -- staged-payload protocol (buffered sinks: postgres/kafka) --------

    def stage(self, frontier: int, payload: bytes) -> None:
        self.backend.put_value(self._stage_key(frontier), payload)
        if frontier not in self._rec["staged"]:
            self._rec["staged"].append(frontier)
            self._rec["staged"].sort()
        self._write()

    def read_staged(
        self, lo_exclusive: int, hi_inclusive: int
    ) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        for f in self._rec["staged"]:
            if lo_exclusive < f <= hi_inclusive:
                blob = self.backend.get_value(self._stage_key(f))
                if blob is not None:
                    out.append((f, blob))
        return out

    def rollback_to(self, frontier: int) -> None:
        """Recovery: drop staged payloads and offsets recorded past the
        restore frontier.  Post-restore epochs renumber from the restore
        frontier, so a stale staged blob at a colliding frontier number
        would later be applied as if it were regenerated output."""
        keep = []
        for f in self._rec["staged"]:
            if f > frontier:
                self.backend.truncate(self._stage_key(f))
            else:
                keep.append(f)
        self._rec["staged"] = keep
        offsets = self._rec["offsets"]
        for f in [f for f in offsets if f > frontier]:
            del offsets[f]
        self._write()

    def mark_committed(self, frontier: int) -> None:
        """Finalize: advance the marker and prune staged payloads the
        sink has durably applied."""
        self._rec["frontier"] = max(self._rec["frontier"], frontier)
        keep = []
        for f in self._rec["staged"]:
            if f <= self._rec["frontier"]:
                self.backend.truncate(self._stage_key(f))
            else:
                keep.append(f)
        self._rec["staged"] = keep
        self._write()


class CachedObjectStorage:
    """Persistence-backed cache of downloaded source objects (reference:
    src/persistence/cached_object_storage.rs — 833 LoC of exactly this
    contract): bytes fetched from slow external sources (GDrive,
    SharePoint) are stored under (object id, version) so a restarted
    pipeline re-serves them from the persistent store instead of
    re-downloading and re-parsing.

    Keys are hashed into the backend namespace; the object id and version
    live inside the blob, so listing works on plain key enumeration."""

    def __init__(self, backend: PersistenceBackend, scope: str):
        import hashlib as _hashlib

        self.backend = backend
        self.scope = scope
        self._h = lambda s: _hashlib.blake2b(
            s.encode(), digest_size=12
        ).hexdigest()

    def _key(self, object_id: str) -> str:
        return f"objcache/{self._h(self.scope)}/{self._h(object_id)}"

    def get(self, object_id: str, version: Any) -> Optional[bytes]:
        """Cached bytes for this exact (id, version); None on miss."""
        blob = self.backend.get_value(self._key(object_id))
        if blob is None:
            return None
        try:
            entry = pickle.loads(blob)
        except Exception:  # noqa: BLE001 — torn write
            return None
        if entry.get("version") != version:
            return None
        return entry.get("payload")

    def put(
        self,
        object_id: str,
        version: Any,
        payload: bytes,
        metadata: Any = None,
    ) -> None:
        self.backend.put_value(
            self._key(object_id),
            pickle.dumps(
                {
                    "object_id": object_id,
                    "version": version,
                    "payload": payload,
                    "metadata": metadata,
                }
            ),
        )

    def evict(self, object_id: str) -> None:
        self.backend.truncate(self._key(object_id))

    def list_objects(self) -> Dict[str, Any]:
        """object_id -> version for every cached object in this scope."""
        prefix_raw = f"objcache/{self._h(self.scope)}/"
        prefix_flat = prefix_raw.replace("/", "__")
        out: Dict[str, Any] = {}
        for key in self.backend.list_keys():
            if not (
                key.startswith(prefix_raw) or key.startswith(prefix_flat)
            ):
                continue
            blob = self.backend.get_value(key)
            if blob is None:
                continue
            try:
                entry = pickle.loads(blob)
            except Exception:  # noqa: BLE001
                continue
            out[entry["object_id"]] = entry["version"]
        return out


from contextlib import contextmanager as _contextmanager

from pathway_tpu_torch.io.s3 import AwsS3Settings  # noqa: E402 — parity re-export


@_contextmanager
def get_persistence_engine_config(persistence_config):
    """Context manager yielding the engine-facing persistence config with
    the run-lifecycle hooks bracketed (reference: persistence/__init__.py
    get_persistence_engine_config:193 — on_before_run before the run,
    on_after_run guaranteed after it). The runner enters this around
    every persistent run."""
    if persistence_config is None:
        yield None
        return
    persistence_config.on_before_run()
    try:
        yield persistence_config
    finally:
        persistence_config.on_after_run()
