"""pw.io.postgres — PostgreSQL writers (reference: python/pathway/io/postgres
write:22, write_snapshot:141; Rust formatters PsqlUpdates / PsqlSnapshot,
src/connectors/data_format.rs:1821,1880).

SQL statement generation is pure and unit-testable; execution needs a DBAPI
connection — psycopg/psycopg2 if installed, or any connection injected via
`_connection` (e.g. sqlite3 in tests, modulo placeholder style).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


def _connection_string_from_settings(settings: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in settings.items())


def _connect(postgres_settings: dict):
    try:
        import psycopg  # type: ignore

        return psycopg.connect(_connection_string_from_settings(postgres_settings))
    except ImportError:
        pass
    try:
        import psycopg2  # type: ignore

        return psycopg2.connect(**postgres_settings)
    except ImportError:
        raise ImportError(
            "pw.io.postgres requires psycopg or psycopg2; install one or "
            "inject a DBAPI connection via _connection"
        )


def build_insert_statement(
    table_name: str, columns: Sequence[str], *, placeholder: str = "%s"
) -> str:
    """INSERT used by the updates writer (reference: PsqlUpdatesFormatter,
    data_format.rs:1821 — appends time/diff columns)."""
    cols = ", ".join(list(columns) + ["time", "diff"])
    ph = ", ".join([placeholder] * (len(columns) + 2))
    return f"INSERT INTO {table_name} ({cols}) VALUES ({ph})"


def build_snapshot_statements(
    table_name: str,
    columns: Sequence[str],
    primary_key: Sequence[str],
    *,
    placeholder: str = "%s",
) -> Tuple[str, str]:
    """(upsert, delete) used by the snapshot writer (reference:
    PsqlSnapshotFormatter, data_format.rs:1880)."""
    cols = ", ".join(columns)
    ph = ", ".join([placeholder] * len(columns))
    pk = ", ".join(primary_key)
    updates = ", ".join(
        f"{c}=EXCLUDED.{c}" for c in columns if c not in primary_key
    )
    upsert = (
        f"INSERT INTO {table_name} ({cols}) VALUES ({ph}) "
        f"ON CONFLICT ({pk}) DO UPDATE SET {updates}"
    )
    where = " AND ".join(f"{c}={placeholder}" for c in primary_key)
    delete = f"DELETE FROM {table_name} WHERE {where}"
    return upsert, delete


_COMMIT_TABLE_DDL = (
    "CREATE TABLE IF NOT EXISTS __pathway_commit "
    "(sink TEXT PRIMARY KEY, frontier BIGINT)"
)


class PostgresUpdatesWriter(OutputWriter):
    """Append-updates writer, exactly-once under a persistent run.

    Without persistence it writes through per batch, as before.  With a
    bound SinkCommitLog, epochs buffer in memory; `prepare(F)` durably
    stages everything <= F in the commit log BEFORE the snapshot
    manifest, and `commit(F)` finalizes: in one DB transaction it applies
    every staged epoch past the `__pathway_commit` frontier row and
    advances that row to F.  The conditional apply makes finalize
    idempotent — `recover(M)` after a crash simply re-runs it — so rows
    land exactly once however the run dies.

    `connection` may be a live DBAPI connection or a zero-arg factory;
    multi-worker runs must pass a factory so each worker's fork opens its
    own connection.
    """

    transactional = True

    def __init__(self, connection, table_name: str, columns: Sequence[str], *, placeholder: str = "%s"):
        self._conn_src = connection
        # DBAPI connections can themselves be callable (sqlite3.Connection
        # has a __call__), so "factory" means callable AND not a connection.
        self._is_factory = callable(connection) and not hasattr(
            connection, "cursor"
        )
        self._conn = None if self._is_factory else connection
        self.table_name = table_name
        self.columns = list(columns)
        self.placeholder = placeholder
        self.stmt = build_insert_statement(table_name, columns, placeholder=placeholder)
        self.log = None
        self._worker_id = 0
        self._epochs: List[Tuple[int, List[list]]] = []

    # a live injected connection is shared (single-worker tests); a
    # factory gives every worker its own session
    def fork(self, worker_id: int) -> "PostgresUpdatesWriter":
        if self._is_factory:
            w = PostgresUpdatesWriter(
                self._conn_src,
                self.table_name,
                self.columns,
                placeholder=self.placeholder,
            )
        else:
            w = self
        w._worker_id = worker_id
        return w

    @property
    def conn(self):
        if self._conn is None:
            self._conn = self._conn_src()
        return self._conn

    def bind_commit_log(self, log) -> None:
        self.log = log

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        rows = [
            [jsonable(ev.values[c]) for c in self.columns] + [ev.time, ev.diff]
            for ev in events
        ]
        if self.log is None:
            cur = self.conn.cursor()
            for row in rows:
                cur.execute(self.stmt, row)
            self.conn.commit()
            return
        self._epochs.append((events[0].time, rows))

    # -- transactional protocol ------------------------------------------

    def _sink_key(self) -> str:
        return f"{self.table_name}/{self._worker_id}"

    def _ensure_commit_table(self, cur) -> None:
        cur.execute(_COMMIT_TABLE_DDL)

    def _db_frontier(self, cur) -> int:
        ph = self.placeholder
        cur.execute(
            f"SELECT frontier FROM __pathway_commit WHERE sink={ph}",
            [self._sink_key()],
        )
        row = cur.fetchone()
        return int(row[0]) if row else -1

    def prepare(self, frontier: int) -> None:
        import pickle

        ready = [(t, rows) for t, rows in self._epochs if t <= frontier]
        self._epochs = [(t, rows) for t, rows in self._epochs if t > frontier]
        self.log.stage(frontier, pickle.dumps(ready))

    def commit(self, frontier: int) -> None:
        self._finalize(frontier)

    def _finalize(self, frontier: int) -> None:
        import pickle

        cur = self.conn.cursor()
        self._ensure_commit_table(cur)
        db_frontier = self._db_frontier(cur)
        if db_frontier < frontier:
            # one transaction: staged epochs + the frontier row — atomic
            # with respect to any crash, conditional so re-runs are no-ops
            for _f, blob in self.log.read_staged(db_frontier, frontier):
                for _t, rows in pickle.loads(blob):
                    for row in rows:
                        cur.execute(self.stmt, row)
            ph = self.placeholder
            cur.execute(
                f"INSERT INTO __pathway_commit (sink, frontier) "
                f"VALUES ({ph}, {ph}) "
                f"ON CONFLICT (sink) DO UPDATE SET frontier=EXCLUDED.frontier",
                [self._sink_key(), frontier],
            )
            self.conn.commit()
        self.log.mark_committed(frontier)

    def recover(self, frontier: int) -> None:
        self._epochs.clear()
        if self.log is None:
            return
        self.log.rollback_to(frontier)
        if frontier >= 0:
            # re-run any finalize the crash interrupted (idempotent)
            self._finalize(frontier)

    def committed_frontier(self) -> int:
        return -1 if self.log is None else self.log.committed_frontier()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


class PostgresSnapshotWriter(OutputWriter):
    def __init__(self, connection, table_name: str, columns: Sequence[str], primary_key: Sequence[str], *, placeholder: str = "%s"):
        self.conn = connection
        self.columns = list(columns)
        self.primary_key = list(primary_key)
        self.upsert, self.delete = build_snapshot_statements(
            table_name, columns, primary_key, placeholder=placeholder
        )

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        cur = self.conn.cursor()
        # within one time, deletions before insertions so upserts win
        for ev in sorted(events, key=lambda e: e.diff):
            if ev.diff > 0:
                cur.execute(
                    self.upsert, [jsonable(ev.values[c]) for c in self.columns]
                )
            else:
                cur.execute(
                    self.delete,
                    [jsonable(ev.values[c]) for c in self.primary_key],
                )
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()


def write(
    table,
    postgres_settings: dict,
    table_name: str,
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    _connection=None,
    _placeholder: str = "%s",
    **kwargs,
) -> None:
    """Append the change stream (with time/diff columns) to a Postgres table
    (reference: io/postgres write:22). Exactly-once when the run is
    persistent with operator snapshots enabled (see PostgresUpdatesWriter)."""
    conn = (
        _connection
        if _connection is not None
        else (lambda: _connect(postgres_settings))
    )
    attach_writer(
        table,
        PostgresUpdatesWriter(
            conn, table_name, table.column_names(), placeholder=_placeholder
        ),
        name=name,
    )


def write_snapshot(
    table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    _connection=None,
    _placeholder: str = "%s",
    **kwargs,
) -> None:
    """Maintain the table as an up-to-date Postgres snapshot keyed by
    primary_key (reference: io/postgres write_snapshot:141)."""
    conn = _connection if _connection is not None else _connect(postgres_settings)
    attach_writer(
        table,
        PostgresSnapshotWriter(
            conn,
            table_name,
            table.column_names(),
            primary_key,
            placeholder=_placeholder,
        ),
        name=name,
    )
