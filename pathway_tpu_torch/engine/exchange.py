"""Multi-worker data exchange: TCP transport, coordination, ExchangeNode.

TPU-native rebuild of the reference's data-parallel scale-out (reference:
src/engine/dataflow/shard.rs:15-20 hash-sharded exchange,
src/engine/dataflow/config.rs:88-120 process/worker wiring over
`PATHWAY_PROCESSES`/`PATHWAY_PROCESS_ID`/`PATHWAY_FIRST_PORT`). Instead of
timely dataflow's channel allocator, each worker process runs the same
dataflow graph; ExchangeNodes re-partition delta batches by key shard over a
localhost TCP full mesh, and the engine advances micro-batch times in
lockstep: every `process_time` call is preceded by a global agreement on the
time (`Coordinator.agree`), which is what differential frontiers give the
reference.

Wire protocol: length-prefixed typed binary frames (engine/wire.py; C++
codec in native/wire_ext.cpp) on simplex sockets (worker i listens on
first_port+i; every peer opens one outgoing connection to every other).
Messages:
  ("hello", from_worker, run_id)
  ("data",  channel, time, deltas)   — deltas routed to this worker
  ("punct", channel, time)           — sender finished channel@time
  ("coord", round_no, payload)       — lockstep agreement votes
A dead peer (socket EOF/reset) turns every pending wait into EngineError —
failure detection, not silent hangs.

The shuffle itself is columnar end to end when the native module is
available (gate: PATHWAY_DISABLE_VECTOR_EXCHANGE): shard codes for a whole
delta batch come from one wire_ext pass, partitioning into per-worker
slabs is a single C pass, each remote partition is consolidated before
encoding (cancelling insert/retract pairs never hit the socket), frames
are encoded length-prefix-and-all in one buffer, and per-peer writer
threads overlap encoding with the TCP sends while eager per-destination
punctuation lets receivers unblock as their partition arrives.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import struct
import sys
import threading
import time as time_mod
from typing import Any, Callable, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import costledger as _costledger
from pathway_tpu_torch.internals import sanitizer as _sanitizer

_LEN = struct.Struct("!I")

logger = logging.getLogger("pathway_tpu_torch.exchange")

# Columnar exchange gate: vectorized shard routing, single-pass
# partitioning, sender-side consolidation, fused frame encoding and
# per-peer writer threads. The classic row-wise path stays available as
# the always-working fallback (and the parity baseline for tests).
VECTOR_EXCHANGE_ENABLED = (
    os.environ.get("PATHWAY_DISABLE_VECTOR_EXCHANGE") != "1"
)

# chunked sends bound peak frame/socket buffers on bulk-ingest batches (a
# single million-row message costs hundreds of MB on both ends)
_CHUNK = 65536

# frames buffered per peer writer before senders block (backpressure)
_SEND_QUEUE_FRAMES = 64

# failover fence sentinel carried in a coord frame's round slot.  The wire
# codec packs rounds as u64, so the sentinel must be a positive value no
# real agree round can reach (rounds restart from 0 after every failover).
FENCE_ROUND = (1 << 64) - 1

_TRACE = os.environ.get("PATHWAY_EXCHANGE_TRACE") == "1"


def _trace(worker_id: int, msg: str) -> None:
    """Failover-protocol event trace (PATHWAY_EXCHANGE_TRACE=1): hello,
    EOF, dead-marking, fence and rendezvous steps, with timestamps —
    mesh-teardown races are invisible without the interleaving."""
    if _TRACE:
        print(
            f"[exch w{worker_id} {time_mod.monotonic():.3f}] {msg}",
            file=sys.stderr,
            flush=True,
        )


class ExchangeError(Exception):
    pass


class Coordinator:
    """Single-worker no-op coordination (the default)."""

    worker_id = 0
    worker_count = 1
    metrics = None  # multi-worker transports carry a MetricsRegistry

    def owns(self, shard: int) -> bool:
        return True

    def is_remote(self, dest: int) -> bool:
        """True when frames for `dest` cross a process boundary (encode +
        socket). Sender-side consolidation only pays for remote peers —
        local handoffs are plain list appends and the receiver's emit()
        consolidates the merged batch anyway."""
        return dest != self.worker_id

    def agree(self, payload: Any) -> List[Any]:
        """All-gather `payload` across workers; returns payloads ordered by
        worker id. Calls must happen in the same order on every worker."""
        return [payload]

    def send_data(self, dest: int, channel: int, time: int, deltas: list) -> None:
        raise ExchangeError("single-worker coordinator cannot send")

    def broadcast_data(self, channel: int, time: int, deltas: list) -> None:
        """Ship the same deltas to every peer. Transports override this to
        encode the message once and fan the identical blob out."""
        for w in range(self.worker_count):
            if w != self.worker_id:
                self.send_data(w, channel, time, deltas)

    def punctuate(self, channel: int, time: int) -> None:
        pass

    def punctuate_one(self, dest: int, channel: int, time: int) -> None:
        """Point-to-point punctuation toward one destination (the eager
        form: a peer's collect() can unblock before the sender finishes
        its full fan-out). Broadcast-only transports may fall back to
        punctuate() — duplicate puncts are idempotent because receivers
        count distinct senders."""
        self.punctuate(channel, time)

    def collect(self, channel: int, time: int) -> list:
        return []

    def send_stamp(
        self, dest: int, channel: int, time: int, origin: int, wall: float
    ) -> None:
        """Tracing stamp toward one destination: (origin worker, epoch,
        send wall-time).  Fire-and-forget — stamps ride the same per-peer
        FIFO as data/punct frames but are NEVER counted toward
        punctuation, so they cannot affect collect() semantics."""

    def take_stamps(self, channel: int, time: int) -> dict:
        """Pop stamps received for channel@time:
        {origin: (send_wall, recv_wall)}.  Called unconditionally by the
        exchange node after collect() so stamp state stays bounded even
        when peers' sampling config diverges."""
        return {}

    def send_qspans(self, dest: int, origin: int, payload: Any) -> None:
        """Ship a query-span payload (internals/qtrace.py marks) toward
        one destination worker.  Fire-and-forget like stamps: rides the
        per-peer FIFO, never counted toward punctuation.  Single-worker
        and same-process workers share one tracker, so the default is a
        no-op."""

    def take_qspans(self) -> list:
        """Pop every received query-span payload: [(origin, payload)]."""
        return []

    def send_lineage(self, dest: int, origin: int, payload: Any) -> None:
        """Ship a lineage-edge payload (internals/provenance.py) toward
        one destination worker.  Same contract as qspans: fire-and-
        forget, rides the per-peer FIFO, never counted toward
        punctuation; same-process workers share one tracker, so the
        default is a no-op."""

    def take_lineage(self) -> list:
        """Pop every received lineage payload: [(origin, payload)]."""
        return []

    def close(self) -> None:
        pass


class _PeerWriter:
    """Per-peer send thread behind a small bounded queue: encoding (and
    consolidating) partition w+1 overlaps the TCP send of partition w.

    ALL post-hello traffic to a peer flows through its writer, so the
    per-socket FIFO — data frames before the punctuation that covers
    them, both before the next agreement round — is exactly the ordering
    direct sendall calls gave. A full queue blocks the sender
    (backpressure); a dead socket flips the writer into drain mode so
    blocked senders always unblock and failure surfaces via the
    coordinator's dead-peer bookkeeping instead of a hang."""

    _CLOSE = object()

    def __init__(
        self,
        peer: int,
        sock: socket.socket,
        lock: threading.Lock,
        on_dead: Callable[[int], None],
    ):
        self.peer = peer
        self.sock = sock
        # shared with the coordinator's synchronous control-plane sends
        # (agree votes bypass the queue); holding it around each sendall
        # keeps whole frames atomic on the stream
        self.lock = lock
        self.on_dead = on_dead
        self.dead = False
        self.q: queue.Queue = queue.Queue(maxsize=_SEND_QUEUE_FRAMES)
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"exchange-send-{peer}"
        )
        self.thread.start()

    def depth(self) -> int:
        return self.q.qsize()

    def send(self, frame: bytes) -> None:
        if self.dead:
            return
        self.q.put(frame)

    def _run(self) -> None:
        while True:
            frame = self.q.get()
            if frame is self._CLOSE:
                return
            if self.dead:
                continue  # drain so blocked senders never deadlock
            try:
                with self.lock:
                    self.sock.sendall(frame)
            except OSError:
                self.dead = True
                self.on_dead(self.peer)

    def close(self, timeout: float = 5.0) -> None:
        """Flush queued frames, then stop the thread. If the writer is
        wedged (peer stopped reading), give up after the timeout — the
        coordinator closes the socket right after, which unblocks it."""
        try:
            self.q.put(self._CLOSE, timeout=timeout)
        except queue.Full:
            self.dead = True
            return
        self.thread.join(timeout)


class TcpCoordinator(Coordinator):
    """Full-mesh localhost TCP transport + lockstep agreement."""

    def __init__(
        self,
        worker_id: int,
        worker_count: int,
        first_port: int,
        *,
        run_id: str = "",
        host: str = "127.0.0.1",
        connect_timeout: float = 30.0,
    ):
        self.worker_id = worker_id
        self.worker_count = worker_count
        self.first_port = first_port
        self.run_id = run_id or os.environ.get("PATHWAY_RUN_ID", "")
        self.host = host
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (channel, time) -> list of deltas received
        self._data: Dict[Tuple[int, int], list] = {}
        # (channel, time) -> set of workers that punctuated
        self._punct: Dict[Tuple[int, int], set] = {}
        # (channel, time) -> {origin: (send_wall, recv_wall)} tracing stamps
        self._stamps: Dict[Tuple[int, int], dict] = {}
        # received query-span payloads: [(origin, payload)] — bounded by
        # the drain in take_qspans(); capped defensively on receive
        self._qspans: list = []
        # received lineage payloads (internals/provenance.py), same
        # bounding discipline as _qspans
        self._lineage: list = []
        # round -> {worker: payload}
        self._coord: Dict[int, Dict[int, Any]] = {}
        self._round = 0
        self._dead: set[int] = set()
        self._dead_reasons: Dict[int, str] = {}
        # live failover (enable_failover): peer death/rejoin surfaces as
        # FailoverRequired so the driver can roll back instead of failing.
        # _helloed tracks peers that ever identified; a SECOND hello from
        # one of them is a rejoin (replacement process or re-handshake
        # after a severed socket).  _conn_gen guards against a stale
        # connection's late EOF re-killing a rejoined peer.
        self._failover = False
        self._helloed: set[int] = set()
        self._rejoined: set[int] = set()
        self._conn_gen: Dict[int, int] = {}
        self._closed = False
        self._out: Dict[int, socket.socket] = {}
        self._out_locks: Dict[int, threading.Lock] = {}
        self._writers: Dict[int, _PeerWriter] = {}
        # snapshot: writer threads are a transport choice made once per
        # mesh; the per-batch routing gate stays flippable at runtime.
        # Overlapped sends need a second core to overlap ONTO — on a
        # single-CPU host the extra thread is pure GIL ping-pong, so the
        # default is auto; PATHWAY_EXCHANGE_WRITERS=1/0 forces it.
        writers_env = os.environ.get("PATHWAY_EXCHANGE_WRITERS")
        if writers_env is not None:
            self._use_writers = writers_env == "1"
        else:
            self._use_writers = (
                VECTOR_EXCHANGE_ENABLED and (os.cpu_count() or 1) > 1
            )
        self._threads: List[threading.Thread] = []
        from pathway_tpu_torch.engine.wire import encode_frame

        self._encode_frame = encode_frame
        self._init_metrics()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, first_port + worker_id))
        self._listener.listen(worker_count + 4)
        accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="exchange-accept"
        )
        accept_thread.start()
        self._threads.append(accept_thread)
        self._connect_peers(connect_timeout)

    def _init_metrics(self) -> None:
        """Exchange backpressure telemetry: bytes on the wire,
        buffered queue depth, and how long collect()/agree() block — the
        direct signal that this worker is waiting on a slow peer."""
        from pathway_tpu_torch.internals.metrics import MetricsRegistry

        reg = self.metrics = MetricsRegistry(
            worker=str(self.worker_id), transport="tcp"
        )
        self._m_bytes_sent = reg.counter(
            "pathway_exchange_bytes_sent",
            help="bytes written to peer sockets",
        ).labels()
        self._m_bytes_recv = reg.counter(
            "pathway_exchange_bytes_received",
            help="bytes read from peer sockets",
        ).labels()
        self._m_collect_wait = reg.histogram(
            "pathway_exchange_collect_wait_seconds",
            help="time collect() blocked waiting for peer punctuation",
            labels=("channel",),
        )
        self._m_agree_wait = reg.histogram(
            "pathway_exchange_agree_wait_seconds",
            help="time agree() blocked waiting for peer votes",
        ).labels()

        def _depth(store):
            def cb():
                try:
                    return sum(
                        len(lst)
                        for per_sender in list(store.values())
                        for lst in list(per_sender.values())
                    )
                except RuntimeError:  # racing a concurrent insert
                    return None

            return cb

        reg.gauge(
            "pathway_exchange_queue_depth",
            help="delta rows buffered awaiting collect()",
            callback=_depth(self._data),
        )
        reg.gauge(
            "pathway_exchange_pending_puncts",
            help="(channel, time) pairs with outstanding punctuation",
            callback=lambda: len(self._punct),
        )
        reg.gauge(
            "pathway_exchange_send_queue_depth",
            help="encoded frames buffered on per-peer writer threads",
            callback=lambda: sum(
                w.depth() for w in list(self._writers.values())
            ),
        )

    # -- connection setup -------------------------------------------------
    def _connect_peers(self, timeout: float) -> None:
        deadline = time_mod.monotonic() + timeout
        for peer in range(self.worker_count):
            if peer == self.worker_id:
                continue
            while True:
                try:
                    s = socket.create_connection(
                        (self.host, self.first_port + peer), timeout=2.0
                    )
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._out[peer] = s
                    self._out_locks[peer] = threading.Lock()
                    self._send_on(s, ("hello", self.worker_id, self.run_id))
                    if self._use_writers:
                        self._writers[peer] = _PeerWriter(
                            peer, s, self._out_locks[peer], self._mark_peer_dead
                        )
                    break
                except OSError:
                    if time_mod.monotonic() > deadline:
                        raise ExchangeError(
                            f"worker {self.worker_id}: cannot reach peer "
                            f"{peer} on port {self.first_port + peer}"
                        )
                    time_mod.sleep(0.05)

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            try:
                # accepted sockets carry punct/coord replies on some
                # topologies; leaving Nagle on there adds 40ms stalls
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            t = threading.Thread(
                target=self._recv_loop, args=(conn,), daemon=True,
                name="exchange-recv",
            )
            t.start()
            self._threads.append(t)

    # -- wire -------------------------------------------------------------
    def _send_on(self, sock: socket.socket, msg: Any) -> None:
        frame = self._encode_frame(msg)
        self._m_bytes_sent.inc(len(frame))
        if _costledger.ENABLED:
            _costledger.charge("ingest", bytes_moved=float(len(frame)))
        sock.sendall(frame)

    def _mark_peer_dead(self, peer: int) -> None:
        with self._cv:
            _trace(self.worker_id, f"send failure -> mark peer {peer} dead")
            self._dead.add(peer)
            self._cv.notify_all()

    def _dispatch(self, dest: int, frame: bytes) -> None:
        """Hand one encoded frame to `dest`'s writer (overlapped) or send
        it inline when writers are disabled. Send failures mark the peer
        dead; callers surface that via _check_dead / collect / agree."""
        self._m_bytes_sent.inc(len(frame))
        if _costledger.ENABLED:
            _costledger.charge("ingest", bytes_moved=float(len(frame)))
        writer = self._writers.get(dest)
        if writer is not None:
            writer.send(frame)
            if writer.dead:
                self._mark_peer_dead(dest)
            return
        sock = self._out[dest]
        with self._out_locks[dest]:
            try:
                sock.sendall(frame)
            except OSError:
                self._mark_peer_dead(dest)

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
        # recv_into a preallocated buffer: the old `buf += chunk` loop
        # reallocated-and-copied per chunk (O(n^2) on multi-MB frames)
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = sock.recv_into(view[got:])
            if not r:
                return None
            got += r
        return bytes(buf)

    def _recv_loop(self, conn: socket.socket) -> None:
        from pathway_tpu_torch.engine.wire import (
            MSG_HELLO,
            WireError,
            decode_message,
        )

        peer = None
        conn_gen = 0
        try:
            while True:
                head = self._recv_exact(conn, _LEN.size)
                if head is None:
                    break
                (length,) = _LEN.unpack(head)
                blob = self._recv_exact(conn, length)
                if blob is None:
                    break
                self._m_bytes_recv.inc(_LEN.size + length)
                if _costledger.ENABLED:
                    _costledger.charge(
                        "ingest", bytes_moved=float(_LEN.size + length)
                    )
                if peer is None and (not blob or blob[0] != MSG_HELLO):
                    # refuse to even decode value payloads (incl. the
                    # pickle escape) from a connection that has not
                    # identified itself — the first frame must be a hello
                    raise ExchangeError("message before hello; dropping")
                try:
                    msg = decode_message(blob)
                except WireError as exc:
                    # a malformed frame is a protocol violation, not data:
                    # fail the run loudly instead of corrupting state
                    # (frames from connections that never identified
                    # themselves just drop the connection, like any stray
                    # connect would)
                    if peer is not None:
                        with self._cv:
                            self._dead_reasons[peer] = (
                                f"malformed frame: {exc}"
                            )
                    raise ExchangeError(
                        f"malformed frame from peer: {exc}"
                    ) from None
                kind = msg[0]
                if kind == "hello":
                    peer = msg[1]
                    if self.run_id and msg[2] and msg[2] != self.run_id:
                        raise ExchangeError(
                            f"peer {peer} belongs to run {msg[2]!r}, "
                            f"expected {self.run_id!r}"
                        )
                    with self._cv:
                        conn_gen = self._conn_gen.get(peer, 0) + 1
                        self._conn_gen[peer] = conn_gen
                        _trace(
                            self.worker_id,
                            f"hello from peer {peer} gen={conn_gen} "
                            f"rejoin={peer in self._helloed or peer in self._dead}",
                        )
                        if self._failover and (
                            peer in self._helloed or peer in self._dead
                        ):
                            # rejoin: the peer (or its replacement) opened a
                            # fresh connection mid-run.  Purge its old-
                            # timeline contributions and flag the rejoin so
                            # this side's agree/collect trigger rollback too
                            # — epoch-fenced: anything it sent before this
                            # hello belongs to the abandoned timeline.
                            self._purge_peer_locked(peer)
                            self._rejoined.add(peer)
                        self._helloed.add(peer)
                        self._cv.notify_all()
                    continue
                with self._cv:
                    if kind == "data":
                        _, channel, time, deltas = msg
                        # keep per-sender order: the merged batch is later
                        # concatenated by worker id, which is deterministic
                        # without any per-row sort (each sender's local
                        # order is SPMD-deterministic)
                        self._data.setdefault((channel, time), {}).setdefault(
                            peer, []
                        ).extend(deltas)
                    elif kind == "punct":
                        _, channel, time = msg
                        self._punct.setdefault((channel, time), set()).add(peer)
                    elif kind == "stamp":
                        _, channel, time, origin, wall = msg
                        self._stamps.setdefault((channel, time), {})[
                            origin
                        ] = (wall, time_mod.time())
                    elif kind == "qspan":
                        _, origin, payload = msg
                        if len(self._qspans) < 4096:  # drop, never grow
                            self._qspans.append((origin, payload))
                    elif kind == "lineage":
                        _, origin, payload = msg
                        if len(self._lineage) < 4096:  # drop, never grow
                            self._lineage.append((origin, payload))
                    elif kind == "coord":
                        _, round_no, payload = msg
                        if round_no == FENCE_ROUND:
                            # failover fence: every frame this peer sent
                            # before this one is old-timeline.  Purging on
                            # fence arrival (per-socket FIFO) guarantees
                            # stale entries are gone before any new-
                            # timeline frame can alias a (channel, time)
                            # or round key after the rollback reset.
                            self._purge_peer_locked(peer)
                        else:
                            self._coord.setdefault(round_no, {})[
                                peer
                            ] = payload
                    self._cv.notify_all()
        except Exception as exc:  # noqa: BLE001 — socket teardown paths
            if peer is not None:
                with self._cv:
                    self._dead_reasons.setdefault(
                        peer, f"{type(exc).__name__}: {exc}"
                    )
        finally:
            with self._cv:
                # generation guard: only the CURRENT connection for this
                # peer may declare it dead — a replaced connection's late
                # EOF must not re-kill a peer that already rejoined
                current = (
                    peer is not None
                    and self._conn_gen.get(peer, 0) == conn_gen
                )
                _trace(
                    self.worker_id,
                    f"recv EOF peer={peer} gen={conn_gen} "
                    f"current={current} closed={self._closed}",
                )
                if current and not self._closed:
                    self._dead.add(peer)
                    self._dead_reasons.setdefault(peer, "connection closed")
                self._cv.notify_all()
            try:
                conn.close()
            except OSError:
                pass

    def _broadcast(self, msg: Any) -> None:
        # encode ONCE; every peer gets the identical blob
        frame = self._encode_frame(msg)
        for peer in self._out:
            self._dispatch(peer, frame)

    def _broadcast_sync(self, msg: Any) -> None:
        """Broadcast on the caller's thread, bypassing the writer queues.

        Agreement votes MUST go out synchronously: a worker may exit the
        process right after its final agree() returns, and frames still
        sitting in a daemon writer queue die with it — the peer then
        blocks on a vote that never arrives and reports the worker dead.
        Synchronous sendall puts the bytes in the kernel buffer before
        agree() can return, so they survive process exit (classic-path
        behavior). Votes have no ordering constraint against queued
        data/punct frames — they are keyed by round number and only
        consumed once the peer itself reaches that agree round, which is
        after all its collects completed. The per-peer out-lock (shared
        with the writer thread) keeps frames atomic on the stream."""
        frame = self._encode_frame(msg)
        for peer, sock in self._out.items():
            self._m_bytes_sent.inc(len(frame))
            if _costledger.ENABLED:
                _costledger.charge("ingest", bytes_moved=float(len(frame)))
            try:
                with self._out_locks[peer]:
                    sock.sendall(frame)
            except OSError:
                self._mark_peer_dead(peer)

    def _purge_peer_locked(self, peer: int) -> None:
        """Drop every buffered contribution from ``peer`` (caller holds
        _cv).  Runs on rejoin-hello and fence arrival so old-timeline
        frames can never alias post-rollback (channel, time)/round keys."""
        for per_sender in self._data.values():
            per_sender.pop(peer, None)
        for got in self._punct.values():
            got.discard(peer)
        for stamps in self._stamps.values():
            stamps.pop(peer, None)
        self._qspans = [q for q in self._qspans if q[0] != peer]
        self._lineage = [q for q in self._lineage if q[0] != peer]
        for votes in self._coord.values():
            votes.pop(peer, None)

    def _dead_context(self) -> str:
        """Flight-recorder tail (installed by the engine as
        ``on_dead_context``) appended to dead-peer errors: what THIS
        worker was doing when the peer died, not just 'peer N dead'."""
        cb = getattr(self, "on_dead_context", None)
        if cb is None:
            return ""
        try:
            tail = cb()
        except Exception:  # noqa: BLE001 — diagnostics must not mask
            return ""
        return f" | recent engine events: {tail}" if tail else ""

    def _check_dead(self) -> None:
        if (self._dead or self._rejoined) and not self._closed:
            reasons = "; ".join(
                f"peer {p}: {r}" for p, r in sorted(self._dead_reasons.items())
            )
            detail = (
                f" ({reasons})" if reasons else ""
            ) + self._dead_context()
            if self._failover:
                from pathway_tpu_torch.engine.engine import FailoverRequired

                raise FailoverRequired(
                    f"worker {self.worker_id}: peer(s) "
                    f"{sorted(self._dead | self._rejoined)} left the mesh"
                    + detail,
                    dead=tuple(sorted(self._dead)),
                )
            raise ExchangeError(
                f"worker {self.worker_id}: peer(s) {sorted(self._dead)} died"
                + detail
            )

    # -- live failover -----------------------------------------------------
    def enable_failover(self) -> None:
        """Dead/rejoined peers raise FailoverRequired (rollback + rejoin)
        out of agree/collect instead of a fatal ExchangeError.  The
        streaming driver enables this only when operator snapshots are on
        — without a snapshot there is no frontier to roll back to."""
        self._failover = True

    def sever_peer(self, peer: int) -> None:
        """Fault injection (faults.sever_peer): hard-close the outbound
        socket to ``peer``.  Its recv side sees EOF, our next send fails —
        both sides observe the break and, with failover enabled, roll back
        and re-handshake through failover_rendezvous."""
        sock = self._out.get(peer)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            self._mark_peer_dead(peer)

    def failover_rendezvous(self, timeout: float | None = None) -> None:
        """Epoch-fenced rejoin handshake, called by the driver after its
        rollback.  Order matters:

        1. drain writer queues to intact peers (their frames precede the
           fence on each socket),
        2. send the fence (round FENCE_ROUND) to intact peers — they purge our
           old-timeline frames on arrival, strictly before anything we
           send afterwards (per-socket FIFO),
        3. reconnect to every dead/rejoined peer's listener (the
           replacement rebinds the same port) with a retry deadline,
        4. wait for each target's fresh hello — a replacement process
           hellos when it joins the mesh, a surviving peer hellos from
           its own rendezvous reconnect.  Consuming the hello INSIDE the
           rendezvous window prevents a late rejoin-hello from triggering
           a second, spurious rollback, and its _conn_gen bump guarantees
           stale EOFs from the peer's abandoned sockets can no longer
           re-mark it dead,
        5. verify each reconnected socket actually reaches the NEW
           incarnation.  Step 3 can race the old process's teardown and
           land in the DYING listener's backlog — its corpse socket
           swallows our hello and the first vote we send dies with
           ECONNRESET.  The rejoin hello proves the old process already
           exited (the port could not rebind before that), so by now a
           corpse socket has EOF queued and a zero-byte peek
           discriminates reliably; reconnect goes to the live listener,
        6. clear dead/rejoin state and reset the agreement round counter
           — both sides restart at round 0 on the rolled-back timeline.
           No buffer purge here: the rejoin-hello handler already purged
           the peer's old-timeline frames, and purging again could eat a
           round-0 vote the peer sent right after its hello."""
        if timeout is None:
            try:
                timeout = float(os.environ.get("PATHWAY_REJOIN_TIMEOUT", 30))
            except ValueError:
                timeout = 30.0
        with self._cv:
            targets = set(self._dead) | set(self._rejoined)
        _trace(self.worker_id, f"rendezvous start targets={sorted(targets)}")
        for peer, w in list(self._writers.items()):
            if peer in targets:
                continue
            drain_deadline = time_mod.monotonic() + 5.0
            while w.depth() > 0 and time_mod.monotonic() < drain_deadline:
                time_mod.sleep(0.005)
        fence = self._encode_frame(("coord", FENCE_ROUND, self.worker_id))
        for peer, sock in list(self._out.items()):
            if peer in targets:
                continue
            try:
                with self._out_locks[peer]:
                    sock.sendall(fence)
            except OSError:
                targets.add(peer)
        deadline = time_mod.monotonic() + timeout

        def reconnect(peer: int) -> None:
            old = self._out.pop(peer, None)
            w = self._writers.pop(peer, None)
            if w is not None:
                w.dead = True  # drain mode: unblock queued senders
                w.close(timeout=0.5)
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            while True:
                try:
                    s = socket.create_connection(
                        (self.host, self.first_port + peer), timeout=2.0
                    )
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._out[peer] = s
                    self._out_locks[peer] = threading.Lock()
                    self._send_on(s, ("hello", self.worker_id, self.run_id))
                    if self._use_writers:
                        self._writers[peer] = _PeerWriter(
                            peer, s, self._out_locks[peer],
                            self._mark_peer_dead,
                        )
                    return
                except OSError:
                    if time_mod.monotonic() > deadline:
                        raise ExchangeError(
                            f"worker {self.worker_id}: failover rendezvous "
                            f"could not reach replacement worker {peer} on "
                            f"port {self.first_port + peer}"
                        ) from None
                    time_mod.sleep(0.05)

        for peer in sorted(targets):
            reconnect(peer)
        with self._cv:
            while not targets <= self._rejoined:
                remaining = deadline - time_mod.monotonic()
                if remaining <= 0:
                    missing = sorted(targets - self._rejoined)
                    raise ExchangeError(
                        f"worker {self.worker_id}: failover rendezvous "
                        f"timed out waiting for a rejoin hello from "
                        f"peer(s) {missing}"
                    )
                self._cv.wait(min(remaining, 0.1))
        for peer in sorted(targets):
            if self._sock_eof(self._out.get(peer)):
                _trace(
                    self.worker_id,
                    f"outbound to {peer} went to the dying incarnation; "
                    f"reconnecting",
                )
                reconnect(peer)
        with self._cv:
            for peer in targets:
                self._dead.discard(peer)
                self._dead_reasons.pop(peer, None)
                self._rejoined.discard(peer)
            self._round = 0
            _trace(
                self.worker_id,
                f"rendezvous done targets={sorted(targets)} round=0",
            )
            self._cv.notify_all()

    @staticmethod
    def _sock_eof(sock: Optional[socket.socket]) -> bool:
        """True when `sock` is closed/reset by its remote end.  Peers
        never write on our outbound sockets (the mesh is simplex), so a
        non-blocking 1-byte peek sees either EAGAIN (alive) or EOF/reset
        (corpse) — it can never consume payload."""
        if sock is None:
            return True
        try:
            return (
                sock.recv(1, socket.MSG_DONTWAIT | socket.MSG_PEEK) == b""
            )
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True

    # -- Coordinator API --------------------------------------------------
    def owns(self, shard: int) -> bool:
        return shard % self.worker_count == self.worker_id

    def send_data(self, dest: int, channel: int, time: int, deltas: list) -> None:
        self._dispatch(dest, self._encode_frame(("data", channel, time, deltas)))
        if self._dead:
            self._check_dead()

    def broadcast_data(self, channel: int, time: int, deltas: list) -> None:
        self._broadcast(("data", channel, time, deltas))
        if self._dead:
            self._check_dead()

    def punctuate(self, channel: int, time: int) -> None:
        self._broadcast(("punct", channel, time))

    def punctuate_one(self, dest: int, channel: int, time: int) -> None:
        self._dispatch(dest, self._encode_frame(("punct", channel, time)))

    def send_stamp(
        self, dest: int, channel: int, time: int, origin: int, wall: float
    ) -> None:
        self._dispatch(
            dest, self._encode_frame(("stamp", channel, time, origin, wall))
        )

    def take_stamps(self, channel: int, time: int) -> dict:
        with self._cv:
            return self._stamps.pop((channel, time), {})

    def send_qspans(self, dest: int, origin: int, payload: Any) -> None:
        if dest == self.worker_id:
            return
        self._dispatch(dest, self._encode_frame(("qspan", origin, payload)))

    def take_qspans(self) -> list:
        with self._cv:
            out, self._qspans = self._qspans, []
            return out

    def send_lineage(self, dest: int, origin: int, payload: Any) -> None:
        if dest == self.worker_id:
            return
        self._dispatch(dest, self._encode_frame(("lineage", origin, payload)))

    def take_lineage(self) -> list:
        with self._cv:
            out, self._lineage = self._lineage, []
            return out

    def collect(self, channel: int, time: int, timeout: float = 600.0) -> list:
        """Block until every peer punctuated channel@time; return received
        deltas concatenated in sender-id order (deterministic merge)."""
        need = self.worker_count - 1
        t0 = time_mod.monotonic()
        deadline = t0 + timeout
        with self._cv:
            while True:
                got = self._punct.get((channel, time), set())
                if len(got) >= need:
                    self._punct.pop((channel, time), None)
                    by_sender = self._data.pop((channel, time), {})
                    out: list = []
                    for sender in sorted(by_sender):
                        out.extend(by_sender[sender])
                    self._m_collect_wait.labels(str(channel)).observe(
                        time_mod.monotonic() - t0
                    )
                    return out
                # a peer that finished its run closes cleanly while we may
                # still be waiting on OTHER peers' frames — only a dead
                # peer whose punctuation we still lack is fatal (its punct
                # rides the same per-peer FIFO as its data, so punct
                # present => all its data arrived).  A rejoined peer means
                # ITS side already rolled back: this wait can never
                # complete either.
                if (self._dead - got) or self._rejoined:
                    break
                if not self._cv.wait(timeout=min(1.0, deadline - time_mod.monotonic())):
                    if time_mod.monotonic() >= deadline:
                        raise ExchangeError(
                            f"worker {self.worker_id}: timeout waiting for "
                            f"channel {channel} @ time {time} "
                            f"(have {sorted(got)})"
                        )
        self._check_dead()
        raise ExchangeError("unreachable")  # pragma: no cover

    def agree(self, payload: Any, timeout: float = 600.0) -> List[Any]:
        round_no = self._round
        self._round += 1
        if _TRACE and round_no < 3:
            _trace(self.worker_id, f"agree round {round_no} send")
        self._broadcast_sync(("coord", round_no, payload))
        t0 = time_mod.monotonic()
        deadline = t0 + timeout
        with self._cv:
            while True:
                votes = self._coord.get(round_no, {})
                if len(votes) >= self.worker_count - 1:
                    self._coord.pop(round_no, None)
                    votes = dict(votes)
                    self._m_agree_wait.observe(time_mod.monotonic() - t0)
                    break
                # during the FINAL round early finishers exit (clean EOF)
                # as soon as their agree completes; their vote already
                # arrived, so only a dead peer whose vote is still missing
                # means the round can never complete.  A rejoined peer is
                # on the rolled-back timeline — its old-round vote will
                # never come.
                if self._rejoined or any(
                    w in self._dead for w in range(self.worker_count)
                    if w != self.worker_id and w not in votes
                ):
                    self._check_dead()
                if not self._cv.wait(timeout=min(1.0, deadline - time_mod.monotonic())):
                    if time_mod.monotonic() >= deadline:
                        raise ExchangeError(
                            f"worker {self.worker_id}: timeout in agreement "
                            f"round {round_no}"
                        )
        votes[self.worker_id] = payload
        return [votes[w] for w in range(self.worker_count)]

    def close(self) -> None:
        self._closed = True
        for writer in self._writers.values():
            writer.close()
        try:
            self._listener.close()
        except OSError:
            pass
        for sock in self._out.values():
            try:
                sock.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# In-process thread workers (workers = threads x processes; reference:
# src/engine/dataflow/config.rs:89-97 — the reference builds
# threads-per-process timely workers the same way)
# ---------------------------------------------------------------------------


class ThreadGroupCoordinator:
    """Shared state for T thread-workers inside one process, optionally
    bridged across processes by a TcpCoordinator.

    Global worker id = process_id * T + thread_index; total workers =
    T x processes.  Intra-process exchange stays in memory; cross-process
    traffic multiplexes thread pairs onto the process mesh by widening the
    channel id: wire(channel, dest_t, sender_t) = (channel*T + dest_t)*T
    + sender_t, so per-sender streams stay segregated (deterministic
    merges) and punctuation counts stay exact.

    Agreement runs ONE TCP round per agree() regardless of T: threads
    rendezvous on a barrier, thread 0 exchanges the aggregated local vote
    list with peer processes, and the flattened result (global worker
    order) is shared back through the barrier."""

    def __init__(
        self,
        threads: int,
        *,
        tcp: Optional[TcpCoordinator] = None,
        process_id: int = 0,
    ):
        self.threads = threads
        self.tcp = tcp
        self.processes = tcp.worker_count if tcp is not None else 1
        self.process_id = tcp.worker_id if tcp is not None else process_id
        self.total = threads * self.processes
        self._cv = threading.Condition()
        self._barrier = threading.Barrier(threads)
        self._votes: List[Any] = [None] * threads
        self._result: Any = None
        self._aborted = False
        # live failover (in-memory thread mode only): when enabled, one
        # worker thread dying flips _failover_pending instead of aborting;
        # survivors raise FailoverRequired, roll back, and park in
        # failover_rendezvous() until the supervisor (runner) swaps in a
        # replacement thread and bumps _generation
        self._failover_enabled = False
        self._failover_pending = False
        self._failed: set = set()
        self._parked: set = set()
        self._generation = 0
        self._restarts = 0
        try:
            self._max_restarts = int(
                os.environ.get("PATHWAY_MAX_FAILOVERS", 3)
            )
        except ValueError:
            self._max_restarts = 3
        # (dest_thread, channel, time) -> {sender_global: [deltas]}
        self._data: Dict[tuple, dict] = {}
        # (dest_thread, channel, time) -> {sender_global}
        self._punct: Dict[tuple, set] = {}
        # (dest_thread, channel, time) -> {origin: send_wall} tracing stamps
        self._stamps: Dict[tuple, dict] = {}
        # engines register themselves here (Engine.__init__) so worker 0's
        # Prometheus / status server can export every thread worker
        self.engines: List[Any] = []

    def facade(self, thread_index: int) -> "_ThreadWorkerCoordinator":
        return _ThreadWorkerCoordinator(self, thread_index)

    def abort(self) -> None:
        """Fail fast when a thread dies: break the barrier (wakes agree()
        waiters) and flag + notify collect() waiters."""
        self._aborted = True
        self._barrier.abort()
        with self._cv:
            self._cv.notify_all()

    # -- live failover -----------------------------------------------------
    def enable_failover(self) -> None:
        """Worker-thread deaths become live failovers instead of group
        aborts.  In-memory thread mode only: the hybrid threads x
        processes topology would need the thread swap AND the TCP fence
        in one transaction, which is out of scope — it keeps fail-fast."""
        if self.tcp is None and self.threads > 1:
            self._failover_enabled = True

    def note_worker_failure(
        self, thread_index: int, exc: BaseException
    ) -> bool:
        """Called by the runner when worker ``thread_index`` died with
        ``exc``.  True: the group absorbs the death as a live failover
        and the caller must spawn a replacement (supervise_failover).
        False: fatal — abort the group as before.  Injected kills
        (faults.WorkerKilled) are always failover-eligible; organic
        crashes only under PATHWAY_FAILOVER=1 (an organic crash usually
        recurs deterministically on replay)."""
        from pathway_tpu_torch.internals.faults import WorkerKilled

        injected = isinstance(exc, WorkerKilled)
        with self._cv:
            if (
                not self._failover_enabled
                or self._failover_pending
                or self._aborted
                or self._restarts >= self._max_restarts
                or not (
                    injected or os.environ.get("PATHWAY_FAILOVER") == "1"
                )
            ):
                return False
            self._restarts += 1
            self._failed.add(thread_index)
            self._failover_pending = True
            self._cv.notify_all()
        # wake agree() waiters; they convert the broken barrier into
        # FailoverRequired while _failover_pending is set
        self._barrier.abort()
        return True

    def failover_rendezvous(self, thread_index: int) -> None:
        """Survivor parks here after its rollback; released when the
        supervisor has installed the replacement worker, reset the
        barrier, and bumped the generation."""
        with self._cv:
            gen = self._generation
            self._parked.add(thread_index)
            self._cv.notify_all()
            while self._generation == gen and not self._aborted:
                self._cv.wait(timeout=0.1)
            if self._aborted:
                raise ExchangeError(
                    f"thread worker {thread_index}: group aborted during "
                    f"failover"
                )

    def complete_failover(self) -> None:
        """Supervisor side (runner): called once every survivor is parked
        and the replacement thread is about to start.  Purges all
        exchange state from the abandoned timeline, installs a fresh
        barrier, and releases the parked survivors."""
        with self._cv:
            self._data.clear()
            self._punct.clear()
            self._stamps.clear()
            self._votes = [None] * self.threads
            self._result = None
            self._barrier = threading.Barrier(self.threads)
            self._failed.clear()
            self._parked.clear()
            self._failover_pending = False
            self._generation += 1
            self._cv.notify_all()

    # -- called by facades -------------------------------------------------
    def agree(self, thread_index: int, payload: Any) -> List[Any]:
        if self._failover_pending and not self._aborted:
            # a failover is in flight: survivors that were not blocked on
            # the barrier when it broke learn about it here, BEFORE they
            # could wait on the replacement barrier with a stale vote
            from pathway_tpu_torch.engine.engine import FailoverRequired

            raise FailoverRequired(
                f"thread worker {thread_index}: sibling worker(s) "
                f"{sorted(self._failed)} died; rolling back",
                dead=tuple(sorted(self._failed)),
            )
        self._votes[thread_index] = payload
        try:
            idx = self._barrier.wait()
            if idx == 0:
                local = list(self._votes)
                if self.tcp is not None:
                    per_proc = self.tcp.agree(local)
                    self._result = [
                        v for proc_votes in per_proc for v in proc_votes
                    ]
                else:
                    self._result = local
            self._barrier.wait()
        except threading.BrokenBarrierError:
            if self._failover_pending and not self._aborted:
                from pathway_tpu_torch.engine.engine import FailoverRequired

                raise FailoverRequired(
                    f"thread worker {thread_index}: sibling worker(s) "
                    f"{sorted(self._failed)} died; rolling back",
                    dead=tuple(sorted(self._failed)),
                ) from None
            raise ExchangeError(
                f"thread worker {thread_index}: a sibling worker died"
            ) from None
        return self._result

    def send_local(
        self, dest_t: int, channel: int, time: int, sender: int, deltas: list
    ) -> None:
        with self._cv:
            self._data.setdefault((dest_t, channel, time), {}).setdefault(
                sender, []
            ).extend(deltas)

    def punct_local(
        self, dest_t: int, channel: int, time: int, sender: int
    ) -> None:
        with self._cv:
            self._punct.setdefault((dest_t, channel, time), set()).add(sender)
            self._cv.notify_all()

    def stamp_local(
        self, dest_t: int, channel: int, time: int, origin: int, wall: float
    ) -> None:
        with self._cv:
            self._stamps.setdefault((dest_t, channel, time), {})[origin] = wall


class _ThreadWorkerCoordinator(Coordinator):
    """Coordinator facade for one thread-worker (see
    ThreadGroupCoordinator)."""

    def __init__(self, group: ThreadGroupCoordinator, thread_index: int):
        from pathway_tpu_torch.internals.metrics import MetricsRegistry

        self.group = group
        self.thread_index = thread_index
        self.worker_id = group.process_id * group.threads + thread_index
        self.worker_count = group.total
        reg = self.metrics = MetricsRegistry(
            worker=str(self.worker_id), transport="threads"
        )
        self._m_collect_wait = reg.histogram(
            "pathway_exchange_collect_wait_seconds",
            help="time collect() blocked waiting for sibling punctuation",
            labels=("channel",),
        )
        self._m_agree_wait = reg.histogram(
            "pathway_exchange_agree_wait_seconds",
            help="time agree() blocked on the thread barrier",
        ).labels()

        def _depth():
            me_t = self.thread_index
            try:
                return sum(
                    len(lst)
                    for key, per_sender in list(group._data.items())
                    if key[0] == me_t
                    for lst in list(per_sender.values())
                )
            except RuntimeError:  # racing a concurrent insert
                return None

        reg.gauge(
            "pathway_exchange_queue_depth",
            help="delta rows buffered for this worker awaiting collect()",
            callback=_depth,
        )

    def owns(self, shard: int) -> bool:
        return shard % self.worker_count == self.worker_id

    def is_remote(self, dest: int) -> bool:
        # in-process siblings get their deltas by reference (send_local);
        # only cross-process destinations hit encode + socket
        return dest // self.group.threads != self.group.process_id

    def _ctx(self) -> str:
        """Flight-recorder tail for dead-sibling errors (installed by the
        engine as on_dead_context)."""
        cb = getattr(self, "on_dead_context", None)
        if cb is None:
            return ""
        try:
            tail = cb()
        except Exception:  # noqa: BLE001 — diagnostics must not mask
            return ""
        return f" | recent engine events: {tail}" if tail else ""

    def enable_failover(self) -> None:
        self.group.enable_failover()

    def failover_rendezvous(self) -> None:
        self.group.failover_rendezvous(self.thread_index)

    def agree(self, payload: Any) -> List[Any]:
        t0 = time_mod.monotonic()
        try:
            result = self.group.agree(self.thread_index, payload)
        except ExchangeError as exc:
            raise ExchangeError(str(exc) + self._ctx()) from None
        self._m_agree_wait.observe(time_mod.monotonic() - t0)
        return result

    def _wire(self, channel: int, dest_t: int, sender_t: int) -> int:
        T = self.group.threads
        return (channel * T + dest_t) * T + sender_t

    def send_data(self, dest: int, channel: int, time: int, deltas: list) -> None:
        g = self.group
        dest_p, dest_t = divmod(dest, g.threads)
        if dest_p == g.process_id:
            g.send_local(dest_t, channel, time, self.worker_id, deltas)
        else:
            g.tcp.send_data(
                dest_p, self._wire(channel, dest_t, self.thread_index),
                time, deltas,
            )

    def broadcast_data(self, channel: int, time: int, deltas: list) -> None:
        g = self.group
        for t2 in range(g.threads):
            if t2 != self.thread_index:
                g.send_local(t2, channel, time, self.worker_id, deltas)
        if g.tcp is not None:
            # one encode per destination thread slot, shared by every peer
            # process (T encodes instead of T x P)
            for dest_t in range(g.threads):
                g.tcp.broadcast_data(
                    self._wire(channel, dest_t, self.thread_index),
                    time,
                    deltas,
                )

    def punctuate(self, channel: int, time: int) -> None:
        g = self.group
        for t2 in range(g.threads):
            if t2 != self.thread_index:
                g.punct_local(t2, channel, time, self.worker_id)
        if g.tcp is not None:
            for dest_t in range(g.threads):
                g.tcp.punctuate(
                    self._wire(channel, dest_t, self.thread_index), time
                )

    def punctuate_one(self, dest: int, channel: int, time: int) -> None:
        """Eager per-destination punctuation. A broadcast here would be
        wrong, not just wasteful: it would tell thread dest_t in EVERY
        process "my data is in" while only dest's partition has been
        sent — dest_t's collect() in the other processes could pop before
        their data arrives. Point-to-point puncts ride the same per-peer
        FIFO as the data frames, so data-before-punct holds per
        destination."""
        g = self.group
        dest_p, dest_t = divmod(dest, g.threads)
        if dest_p == g.process_id:
            if dest_t != self.thread_index:
                g.punct_local(dest_t, channel, time, self.worker_id)
        else:
            g.tcp.punctuate_one(
                dest_p, self._wire(channel, dest_t, self.thread_index), time
            )

    def send_stamp(
        self, dest: int, channel: int, time: int, origin: int, wall: float
    ) -> None:
        g = self.group
        dest_p, dest_t = divmod(dest, g.threads)
        if dest_p == g.process_id:
            if dest_t != self.thread_index:
                g.stamp_local(dest_t, channel, time, origin, wall)
        else:
            g.tcp.send_stamp(
                dest_p,
                self._wire(channel, dest_t, self.thread_index),
                time,
                origin,
                wall,
            )

    def send_qspans(self, dest: int, origin: int, payload: Any) -> None:
        g = self.group
        dest_p, _dest_t = divmod(dest, g.threads)
        if dest_p == g.process_id:
            return  # same process: the qtrace tracker is already shared
        g.tcp.send_qspans(dest_p, origin, payload)

    def take_qspans(self) -> list:
        g = self.group
        if g.tcp is None:
            return []
        return g.tcp.take_qspans()

    def send_lineage(self, dest: int, origin: int, payload: Any) -> None:
        g = self.group
        dest_p, _dest_t = divmod(dest, g.threads)
        if dest_p == g.process_id:
            return  # same process: the provenance tracker is shared
        g.tcp.send_lineage(dest_p, origin, payload)

    def take_lineage(self) -> list:
        g = self.group
        if g.tcp is None:
            return []
        return g.tcp.take_lineage()

    def take_stamps(self, channel: int, time: int) -> dict:
        g = self.group
        me_t = self.thread_index
        out: dict = {}
        with g._cv:
            local = g._stamps.pop((me_t, channel, time), None)
        if local:
            # local handoffs have no socket: receive time is the moment
            # this worker drains the stamp (≈ queue wait until collect)
            now = time_mod.time()
            for origin, wall in local.items():
                out[origin] = (wall, now)
        if g.tcp is not None:
            for sender_t in range(g.threads):
                out.update(
                    g.tcp.take_stamps(
                        self._wire(channel, me_t, sender_t), time
                    )
                )
        return out

    def collect(self, channel: int, time: int, timeout: float = 600.0) -> list:
        g = self.group
        me_t = self.thread_index
        need_local = g.threads - 1
        t_enter = time_mod.monotonic()
        deadline = t_enter + timeout
        key = (me_t, channel, time)
        with g._cv:
            while len(g._punct.get(key, ())) < need_local:
                if g._failover_pending and not g._aborted:
                    from pathway_tpu_torch.engine.engine import FailoverRequired

                    raise FailoverRequired(
                        f"worker {self.worker_id}: sibling worker(s) "
                        f"{sorted(g._failed)} died; rolling back",
                        dead=tuple(sorted(g._failed)),
                    )
                if g._aborted:
                    raise ExchangeError(
                        f"worker {self.worker_id}: a sibling worker died"
                        + self._ctx()
                    )
                if g.tcp is not None:
                    g.tcp._check_dead()
                if not g._cv.wait(
                    timeout=min(1.0, deadline - time_mod.monotonic())
                ):
                    if time_mod.monotonic() >= deadline:
                        raise ExchangeError(
                            f"worker {self.worker_id}: timeout waiting for "
                            f"local punctuation on channel {channel} @ "
                            f"{time} (have "
                            f"{sorted(g._punct.get(key, ()))})"
                        )
            local = g._data.pop(key, {})
            g._punct.pop(key, None)
        out: list = []
        # deterministic merge: remote parts first (sender-thread-major,
        # sender-process order inside — tcp.collect's own convention),
        # then local parts by sender global id
        if g.tcp is not None:
            for sender_t in range(g.threads):
                out.extend(
                    g.tcp.collect(
                        self._wire(channel, me_t, sender_t), time,
                        timeout=max(1.0, deadline - time_mod.monotonic()),
                    )
                )
        for sender in sorted(local):
            out.extend(local[sender])
        self._m_collect_wait.labels(str(channel)).observe(
            time_mod.monotonic() - t_enter
        )
        return out

    def close(self) -> None:
        if self.thread_index == 0 and self.group.tcp is not None:
            self.group.tcp.close()


# ---------------------------------------------------------------------------
# ExchangeNode + routing helpers
# ---------------------------------------------------------------------------


class _Route:
    """Declarative routing spec for exchange nodes.

    `kind` selects how a row's 16-bit shard code is derived: "key" (the
    row key's own shard bits), "value" (ref_scalar hash of value_fn's
    per-row output), "worker" (a fixed destination). Keeping the spec
    declarative — instead of the closures the helpers used to build —
    is what lets the exchange node route a whole batch through the
    native kernels; codes() remains the row-wise reference the classic
    path runs and the columnar path must agree with."""

    __slots__ = ("kind", "value_fn", "worker")

    def __init__(
        self,
        kind: str,
        value_fn: Optional[Callable] = None,
        worker: int = 0,
    ):
        self.kind = kind
        self.value_fn = value_fn
        self.worker = worker

    def codes(
        self,
        keys: list,
        rows: tuple,
        note_unroutable: Optional[Callable[[int], None]] = None,
    ) -> List[int]:
        from pathway_tpu_torch.engine.value import Pointer, ref_scalar

        if self.kind == "key":
            return [k.shard for k in keys]
        if self.kind == "worker":
            return [self.worker] * len(keys)
        values = self.value_fn(keys, rows)
        out: List[int] = []
        n_bad = 0
        for v in values:
            if isinstance(v, Pointer):
                out.append(v.shard)
            else:
                try:
                    out.append(ref_scalar(v).shard)
                except Exception:  # noqa: BLE001 — unhashable: worker 0
                    out.append(0)
                    n_bad += 1
        if n_bad and note_unroutable is not None:
            note_unroutable(n_bad)
        return out


def _make_exchange_node():
    from pathway_tpu_torch.engine.engine import Node
    from pathway_tpu_torch.engine.stream import consolidate
    from pathway_tpu_torch.engine.value import ref_scalar, shard_kernels

    class _ExchangeNode(Node):
        """Re-partitions a delta stream across workers by a routing spec.

        Placed before stateful operators so rows that must interact (same
        group / join key / instance) meet on one worker (reference:
        shard.rs — the exchange pact on keyed edges). Channel ids come from
        a dedicated counter: exchange creation points are SPMD-
        deterministic, so ids align across workers.

        Two scatter paths, same contract as the columnar nodes
        (path="columnar"/"classic" + live row counters): the columnar one
        derives every shard code in one native pass, partitions in one C
        pass, consolidates each remote partition before encoding, and
        punctuates each destination eagerly; the classic row-wise loop is
        the always-available fallback (PATHWAY_DISABLE_VECTOR_EXCHANGE,
        no native module, or a routing shape the kernels reject). Both
        produce the identical consolidated output multiset — emit()
        re-consolidates the merged batch."""

        name = "exchange"

        def __init__(self, engine, input_, route_fn):
            super().__init__(engine, [input_])
            self.route_fn = route_fn
            # channel ids come from a dedicated counter: exchange creation
            # points are SPMD-deterministic, total node counts are NOT
            # (worker 0 attaches extra sink nodes)
            self.channel = getattr(engine, "_exchange_channels", 0)
            engine._exchange_channels = self.channel + 1
            reg = getattr(engine.coord, "metrics", None)
            self._m_unroutable = (
                reg.counter(
                    "pathway_exchange_unroutable_rows",
                    help="rows whose routing value could not be hashed "
                    "(routed to worker 0)",
                ).labels()
                if reg is not None
                else None
            )
            # per-peer transit/queue latency from the tracing stamps
            # (sampled epochs only — the stamps that feed cross-worker
            # trace edges also feed this histogram)
            self._m_transit = (
                reg.histogram(
                    "pathway_exchange_transit_seconds",
                    help="send->receive wall time of exchange stamps "
                    "(per origin peer, sampled epochs)",
                    labels=("channel", "peer"),
                )
                if reg is not None
                else None
            )

        def _note_unroutable(self, n: int) -> None:
            if self._m_unroutable is not None:
                self._m_unroutable.inc(n)
            # Engine.warn_once is per-engine: every worker engine of a
            # multi-engine test (and every re-run) warns exactly once
            self.engine.warn_once(
                "exchange_unroutable",
                "exchange: %d row(s) with unhashable routing values "
                "routed to worker 0 (see "
                "pathway_exchange_unroutable_rows; logged once per run)",
                n,
            )

        def process(self, time: int) -> None:
            deltas = self.take(0)
            engine = self.engine
            coord = engine.coord
            if deltas:
                self.rows_processed += len(deltas)
                self.batches_processed += 1
            m = engine.metrics
            tr = m.trace if m is not None else None
            # sampling is SPMD-deterministic (time % N), so every worker
            # stamps exactly the epochs every other worker samples
            stamp = tr is not None and tr.in_epoch(time)
            own = self._scatter(deltas, coord, time, stamp)
            received = coord.collect(self.channel, time)
            if _sanitizer.ACTIVE:
                # routing invariant (key.shard % n == me) + per-channel
                # frontier monotonicity; raises SanitizerError on breach
                _sanitizer.tracker().on_exchange(self, time, received)
            # stamps are drained UNCONDITIONALLY so the coordinator's
            # stamp buffers stay bounded even if a peer's sampling env
            # diverges; they arrive before collect() returns because they
            # ride the same per-peer FIFO ahead of the punctuation
            stamps = coord.take_stamps(self.channel, time)
            if stamps:
                transit = self._m_transit
                for origin, (sw, rw) in sorted(stamps.items()):
                    if transit is not None:
                        transit.labels(str(self.channel), str(origin)).observe(
                            max(0.0, rw - sw)
                        )
                    if stamp:
                        tr.note_edge(time, self.channel, origin, sw, rw)
            # deterministic merge without a per-row sort: received deltas
            # arrive concatenated in sender-id order (each sender's local
            # order is SPMD-deterministic), own part appended last — the
            # same convention on every run.  Per-key retraction-before-
            # insertion within the merged batch is restored by emit()'s
            # consolidation.
            self.emit(time, received + own)

        def _send_chunked(self, coord, w: int, time: int, part: list) -> None:
            for s in range(0, len(part), _CHUNK):
                coord.send_data(w, self.channel, time, part[s : s + _CHUNK])

        def _send_stamps(self, coord, time: int, w_count: int) -> None:
            """One tracing stamp per peer, sent right before the
            punctuation that covers this epoch (per-peer FIFO => stamps
            land before the receiver's collect() returns)."""
            me = coord.worker_id
            channel = self.channel
            for w in range(w_count):
                if w != me:
                    coord.send_stamp(w, channel, time, me, time_mod.time())

        def _scatter(self, deltas, coord, time: int, stamp: bool = False) -> list:
            """Route the batch, ship every remote partition, punctuate.
            Returns the partition this worker keeps for itself."""
            w_count = coord.worker_count
            me = coord.worker_id
            if not deltas:
                if stamp:
                    self._send_stamps(coord, time, w_count)
                coord.punctuate(self.channel, time)
                return []
            if self.route_fn is None:
                # broadcast: every worker receives every delta (reference:
                # timely Broadcast, used for threshold / index streams
                # every worker must see in full)
                if VECTOR_EXCHANGE_ENABLED:
                    self.path = "columnar"
                    for s in range(0, len(deltas), _CHUNK):
                        coord.broadcast_data(
                            self.channel, time, deltas[s : s + _CHUNK]
                        )
                    for w in range(w_count):
                        if w != me:
                            if stamp:
                                coord.send_stamp(
                                    w, self.channel, time, me,
                                    time_mod.time(),
                                )
                            coord.punctuate_one(w, self.channel, time)
                else:
                    self.path = "classic"
                    for w in range(w_count):
                        if w != me:
                            self._send_chunked(coord, w, time, list(deltas))
                    if stamp:
                        self._send_stamps(coord, time, w_count)
                    coord.punctuate(self.channel, time)
                return list(deltas)
            parts = (
                self._partition_columnar(deltas, w_count)
                if VECTOR_EXCHANGE_ENABLED
                else None
            )
            if parts is None:
                self.path = "classic"
                route = self.route_fn
                keys = [d[0] for d in deltas]
                rows = ([d[1] for d in deltas],)
                codes = (
                    route.codes(keys, rows, self._note_unroutable)
                    if isinstance(route, _Route)
                    else route(keys, rows)
                )
                parts = [[] for _ in range(w_count)]
                for d, sh in zip(deltas, codes):
                    parts[sh % w_count].append(d)
                for w in range(w_count):
                    if w != me and parts[w]:
                        self._send_chunked(coord, w, time, parts[w])
                if stamp:
                    self._send_stamps(coord, time, w_count)
                coord.punctuate(self.channel, time)
                return parts[me]
            self.path = "columnar"
            for w in range(w_count):
                if w == me:
                    continue
                part = parts[w]
                if part:
                    # sender-side consolidation: insert/retract pairs that
                    # cancel within the tick never hit the socket. Only
                    # worth a pass when bytes actually hit one (local
                    # handoffs are list appends) AND the batch carries a
                    # retraction — on an insert-only stream the dict pass
                    # can cancel nothing (per-row keys keep duplicates
                    # apart). emit() consolidates the merged batch on the
                    # receiver either way, so sink output is byte-identical.
                    if coord.is_remote(w) and any(
                        d[2] < 0 for d in part
                    ):
                        part = consolidate(part)
                    self._send_chunked(coord, w, time, part)
                if stamp:
                    coord.send_stamp(
                        w, self.channel, time, me, time_mod.time()
                    )
                # eager punctuation: dest w's collect() can unblock as
                # soon as ITS partition is on the wire (the per-peer FIFO
                # keeps data before punct), not after our full fan-out
                coord.punctuate_one(w, self.channel, time)
            return parts[me]

        def _partition_columnar(self, deltas, w_count: int):
            """Per-worker delta slabs via the native kernels: all shard
            codes in one pass, partitioning (with the % w_count fused in)
            in another. None when ineligible — no native module, a
            non-declarative route, or a shape the kernels reject — which
            sends the batch down the classic row-wise path."""
            kernels = shard_kernels()
            route = self.route_fn
            if kernels is None or not isinstance(route, _Route):
                return None
            pointer_shards, ref_shards, partition_deltas = kernels
            try:
                if route.kind == "worker":
                    parts: List[list] = [[] for _ in range(w_count)]
                    parts[route.worker % w_count] = list(deltas)
                    return parts
                if route.kind == "key":
                    shards = pointer_shards([d[0] for d in deltas])
                else:  # "value"
                    values = route.value_fn(
                        [d[0] for d in deltas], ([d[1] for d in deltas],)
                    )
                    if not isinstance(values, list):
                        values = list(values)
                    shards, unresolved = ref_shards(values)
                    if unresolved:
                        shards = self._patch_unresolved(
                            values, shards, unresolved
                        )
                return partition_deltas(deltas, shards, w_count)
            except TypeError:
                # e.g. non-Pointer keys: the classic path handles them
                return None

        def _patch_unresolved(self, values, shards, unresolved) -> bytes:
            """Fill in shard codes the native kernel would not derive
            (containers, ndarrays, oversized scalars) via the python
            routing — including the unroutable-to-worker-0 convention."""
            shards = bytearray(shards)
            n_bad = 0
            for i in unresolved:
                try:
                    code = ref_scalar(values[i]).shard
                except Exception:  # noqa: BLE001 — unhashable: worker 0
                    code = 0
                    n_bad += 1
                shards[2 * i : 2 * i + 2] = code.to_bytes(2, "little")
            if n_bad:
                self._note_unroutable(n_bad)
            return bytes(shards)

    return _ExchangeNode


_exchange_node_cls = None


def _exchange(engine, node, route_fn):
    global _exchange_node_cls
    if engine.coord.worker_count == 1:
        return node
    if _exchange_node_cls is None:
        _exchange_node_cls = _make_exchange_node()
    return _exchange_node_cls(engine, node, route_fn)


def exchange_broadcast(engine, node):
    """Replicate a (small) delta stream to every worker — each worker sees
    the full table (reference: timely ``Broadcast`` on the external-index
    and gradual-broadcast threshold streams)."""
    return _exchange(engine, node, None)


def exchange_by_key(engine, node):
    """Partition by row-key shard — the standing table invariant:
    owner(row) = key.shard % worker_count."""
    return _exchange(engine, node, _Route("key"))


def exchange_by_value(engine, node, value_fn):
    """Partition by the stable hash of a computed per-row value (join keys,
    instances). value_fn(keys, rows) -> one routing value per row.
    Unhashable routing values go to worker 0 — counted in the
    pathway_exchange_unroutable_rows metric and logged once per run."""
    return _exchange(engine, node, _Route("value", value_fn=value_fn))


def exchange_to_worker(engine, node, worker: int = 0):
    """Gather the whole stream onto one worker (sinks, global operators).
    Memoized per (node, worker): several consumers of the same gathered
    stream (e.g. a transformer's output tables) share one exchange node."""
    if engine.coord.worker_count == 1:
        return node
    memo = getattr(engine, "_gather_memo", None)
    if memo is None:
        memo = engine._gather_memo = {}
    key = (id(node), worker)
    if key in memo:
        return memo[key]
    out = _exchange(engine, node, _Route("worker", worker=worker))
    memo[key] = out
    return out


def coordinator_from_config() -> Coordinator:
    """Build the process-wide coordinator from PATHWAY_* env config."""
    from pathway_tpu_torch.internals.config import pathway_config as cfg
    from pathway_tpu_torch.internals.license import check_worker_count

    # free tier caps TOTAL workers (threads x processes) at 8, regardless
    # of how they are split (reference: config.rs:7-11, 89-97)
    check_worker_count(getattr(cfg, "worker_count", cfg.processes))
    if cfg.processes <= 1:
        return Coordinator()
    return TcpCoordinator(cfg.process_id, cfg.processes, cfg.first_port)


_global_coord: Optional[Coordinator] = None


def global_coordinator() -> Coordinator:
    """The process-wide coordinator. One TCP mesh serves every engine run in
    this process: all workers execute the same SPMD script, so runs and
    agreement rounds line up."""
    global _global_coord
    if _global_coord is None:
        _global_coord = coordinator_from_config()
        if isinstance(_global_coord, TcpCoordinator):
            # flush writer queues before the interpreter tears down the
            # daemon send threads — peers may still be reading
            import atexit

            atexit.register(_global_coord.close)
    return _global_coord
