"""The port's connectors against the JAX package's, on the CPU.

Each case is one function `case(pw, tmp)` that drives connectors of the
package it is given on the doubles that tests/test_io_connectors.py and
tests/test_lakes_and_db.py use (in-memory brokers behind
`_mq.MessageQueueClient`, fake DB / search / cloud clients, sqlite as a
real SQL engine, tests/_fakes.py's object store, the local disk for the
lakes) and returns what came out: the rows read, or the events, bytes or
SQL rows written, in a package-neutral form. It runs once through
`pathway_tpu` and once through `pathway_tpu_torch`, each in a fresh
directory, and the two results must be EQUAL (floats within 1e-6
relative). Where a connector's client library is not installed, the case
goes as far as its lazy import: both packages must raise the same
ImportError. Nothing is fetched.

Every case runs on a thread of its own and must end within CASE_SECONDS:
the connectors start reader threads, and a hung one fails its case
instead of the run.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sqlite3
import sys
import threading
import time

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _fakes import FakeObjectClient  # noqa: E402

pytest.importorskip("pyarrow")

PACKAGES = {"jax": jpw, "port": tpw}
CASE_SECONDS = 60.0


def _mod(pw, name: str):
    """`pw`'s own submodule `name` (e.g. "io._mq")."""
    return importlib.import_module(f"{pw.__name__}.{name}")


def _run_tables(pw, *tables):
    return _mod(pw, "internals.runner").run_tables(*tables)


def _rows(pw, table) -> list:
    (cap,) = _run_tables(pw, table)
    return sorted((_norm(r) for r in cap.state.rows.values()), key=repr)


def _norm(v):
    """Package-neutral form of an engine value."""
    name = type(v).__name__
    if name == "Pointer":
        return ("Pointer", v.value)
    if name == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True, default=str))
    if name == "RowEvent":
        return ("RowEvent", _norm(v.key), _norm(v.values), v.time, v.diff)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(a, b, rel_tol=1e-6)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_close, a, b))
    return type(a) is type(b) and a == b


def _collect(pw, table) -> list:
    rows = []
    pw.io.subscribe(
        table, on_change=lambda key, row, time, is_addition: rows.append((row, is_addition))
    )
    return rows


def _finite_client(pw, messages):
    """tests/test_io_connectors.py's FiniteMQClient on `pw`'s own base:
    yields the canned messages two at a time, then ends the stream."""

    class FiniteMQClient(_mod(pw, "io._mq").MessageQueueClient):
        def __init__(self):
            self.messages = list(messages)
            self.produced = []
            self.closed = False

        def poll(self, timeout):
            if not self.messages:
                return None
            batch, self.messages = self.messages[:2], self.messages[2:]
            return [(None, m, {}) for m in batch]

        def produce(self, topic, key, payload):
            self.produced.append((topic, key, payload))

        def close(self):
            self.closed = True

    return FiniteMQClient()


def _schema(pw, **cols):
    dt = _mod(pw, "internals.dtype")
    schema = _mod(pw, "internals.schema")
    return schema.schema_from_columns(
        {k: schema.ColumnSchema(name=k, dtype=getattr(dt, v)) for k, v in cols.items()},
        name="S" + "_".join(cols),
    )


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return ("raises", type(exc).__name__, str(exc).replace("pathway_tpu_torch", "pathway_tpu"))
    return ("no error",)


# -- message queues: _mq, kafka / redpanda, debezium, nats, mqtt ------------


def case_mq_parse_payload_json_and_dsv(pw, tmp):
    mq = _mod(pw, "io._mq")
    schema = _schema(pw, a="INT", b="STR")
    return [
        list(mq.parse_payload(b'{"a": 1, "b": "x"}', "json", schema)),
        list(mq.parse_payload(b"2,y\n3,z", "dsv", schema)),
        list(mq.parse_payload(b"raw bytes", "raw", schema)),
        list(mq.parse_payload(b"a line\n", "plaintext", schema)),
    ]


def case_kafka_read_json(pw, tmp):
    msgs = [json.dumps({"a": i, "b": f"m{i}"}).encode() for i in range(5)]
    t = pw.io.kafka.read(
        {}, "topic", schema=_schema(pw, a="INT", b="STR"), format="json",
        _client_factory=lambda: _finite_client(pw, msgs),
    )
    rows = _collect(pw, t)
    pw.run()
    return sorted(((r["a"], r["b"]), add) for r, add in rows)


def case_kafka_read_raw_and_plaintext(pw, tmp):
    msgs = [b"first", b"second line", b"third"]
    raw = pw.io.kafka.read({}, "topic", format="raw",
                           _client_factory=lambda: _finite_client(pw, msgs))
    text = pw.io.kafka.simple_read("localhost:9092", "topic", format="plaintext",
                                   _client_factory=lambda: _finite_client(pw, msgs))
    rows_raw, rows_text = _collect(pw, raw), _collect(pw, text)
    pw.run()
    return [sorted((r["data"], add) for r, add in rows_raw),
            sorted((r["data"], add) for r, add in rows_text)]


def case_kafka_write_produces_json(pw, tmp):
    t = _md(pw, "a | b\n1 | x\n2 | y")
    client = _finite_client(pw, [])
    pw.io.kafka.write(t, {}, "out_topic", _client=client)
    pw.run()
    return sorted(
        (topic, key, json.dumps({k: v for k, v in json.loads(p).items() if k != "time"},
                                sort_keys=True))
        for topic, key, p in client.produced
    )


def case_kafka_write_with_key(pw, tmp):
    t = _md(pw, "k | v\nx | 1\ny | 2")
    client = _finite_client(pw, [])
    pw.io.kafka.write(t, {}, "keyed", key=t.k, format="json", _client=client)
    pw.run()
    return sorted((topic, key, json.loads(p)["v"]) for topic, key, p in client.produced)


def case_redpanda_is_kafka(pw, tmp):
    return [pw.io.redpanda.read is pw.io.kafka.read, pw.io.redpanda.write is pw.io.kafka.write,
            pw.io.redpanda.simple_read is pw.io.kafka.simple_read]


def case_debezium_parse_ops(pw, tmp):
    parse = _mod(pw, "io.debezium").parse_debezium_message
    create = {"payload": {"op": "c", "after": {"id": 1, "v": "a"}}}
    update = {"payload": {"op": "u", "before": {"id": 1, "v": "a"}, "after": {"id": 1, "v": "b"}}}
    delete = {"payload": {"op": "d", "before": {"id": 1, "v": "b"}}}
    return [parse(json.dumps(m)) for m in (create, update, delete)]


def case_debezium_read_applies_updates(pw, tmp):
    class DzSchema(pw.Schema, primary_key=["id"]):
        id: int
        v: str

    msgs = [
        json.dumps({"payload": {"op": "c", "after": {"id": 1, "v": "a"}}}).encode(),
        json.dumps({"payload": {"op": "u", "before": {"id": 1, "v": "a"},
                                "after": {"id": 1, "v": "b"}}}).encode(),
        json.dumps({"payload": {"op": "c", "after": {"id": 2, "v": "c"}}}).encode(),
        json.dumps({"payload": {"op": "d", "before": {"id": 2, "v": "c"}}}).encode(),
    ]
    t = pw.io.debezium.read(schema=DzSchema, _client_factory=lambda: _finite_client(pw, msgs))
    rows = _collect(pw, t)
    pw.run()
    final = {}
    for row, add in rows:
        if add:
            final[row["id"]] = row["v"]
        elif final.get(row["id"]) == row["v"]:
            del final[row["id"]]
    return [sorted(((r["id"], r["v"]), add) for r, add in rows), final]


def case_nats_read_and_write(pw, tmp):
    msgs = [json.dumps({"a": i}).encode() for i in range(4)]
    t = pw.io.nats.read("nats://127.0.0.1:4222", "subj", schema=_schema(pw, a="INT"),
                        format="json", _client_factory=lambda: _finite_client(pw, msgs))
    out = _finite_client(pw, [])
    pw.io.nats.write(t, "nats://127.0.0.1:4222", "out", _client=out)
    rows = _collect(pw, t)
    pw.run()
    return [sorted(r["a"] for r, add in rows if add),
            sorted((topic, json.loads(p)["a"]) for topic, _k, p in out.produced)]


def case_mqtt_read_and_write(pw, tmp):
    msgs = [b"on", b"off", b"on"]
    t = pw.io.mqtt.read("mqtt://127.0.0.1:1883", "sensors/#", format="plaintext",
                        _client_factory=lambda: _finite_client(pw, msgs))
    out = _finite_client(pw, [])
    pw.io.mqtt.write(t, "mqtt://127.0.0.1:1883", "echo", _client=out)
    rows = _collect(pw, t)
    pw.run()
    return [sorted(r["data"] for r, add in rows if add),
            sorted((topic, json.loads(p)["data"]) for topic, _k, p in out.produced)]


# -- sqlite and postgres ------------------------------------------------------


def _items_db(tmp) -> str:
    db = os.path.join(tmp, "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE items (id INTEGER PRIMARY KEY, name TEXT)")
    conn.executemany("INSERT INTO items VALUES (?, ?)", [(1, "a"), (2, "b")])
    conn.commit()
    conn.close()
    return db


def case_sqlite_static_read(pw, tmp):
    class ItemSchema(pw.Schema, primary_key=["id"]):
        id: int
        name: str

    return _rows(pw, pw.io.sqlite.read(_items_db(tmp), "items", ItemSchema, mode="static"))


def case_sqlite_cdc_diffing(pw, tmp):
    db = _items_db(tmp)

    class ItemSchema(pw.Schema, primary_key=["id"]):
        id: int
        name: str

    events = []

    class Sink:
        def push_row(self, row, diff=1):
            events.append((dict(row), diff))

        def commit(self):
            pass

        def close(self):
            pass

    subject = _mod(pw, "io.sqlite")._SqliteSubject(db, "items", ItemSchema, "static", 0.01)
    subject._bind(Sink())
    subject.run()
    first = sorted(events, key=repr)
    conn = sqlite3.connect(db)
    conn.execute("UPDATE items SET name='z' WHERE id=1")
    conn.execute("DELETE FROM items WHERE id=2")
    conn.execute("INSERT INTO items VALUES (3, 'c')")
    conn.commit()
    conn.close()
    events.clear()
    subject.run()
    return [first, sorted(events, key=repr)]


def case_sqlite_cdc_reader_roundtrip(pw, tmp):
    path = os.path.join(tmp, "cdc.db")
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER)")
    db.executemany("INSERT INTO kv VALUES (?, ?)", [("x", 1), ("y", 2), ("z", 3)])
    db.commit()
    db.close()

    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    got = {}
    t = pw.io.sqlite.read(path, "kv", KV, mode="static")
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: got.__setitem__(
        row["k"], row["v"]))
    pw.run(monitoring_level=None)
    return got


def case_sqlite_read_types(pw, tmp):
    path = os.path.join(tmp, "types.db")
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE m (id INTEGER PRIMARY KEY, f REAL, s TEXT, b INTEGER, n REAL)")
    db.executemany("INSERT INTO m VALUES (?, ?, ?, ?, ?)",
                   [(1, 0.25, "x", 1, None), (2, -1.5, "", 0, 3.0)])
    db.commit()
    db.close()

    class M(pw.Schema, primary_key=["id"]):
        id: int
        f: float
        s: str
        b: bool
        n: float | None

    return _rows(pw, pw.io.sqlite.read(path, "m", M, mode="static"))


def case_postgres_write_against_sqlite(pw, tmp):
    db = os.path.join(tmp, "out.db")
    conn = sqlite3.connect(db, check_same_thread=False)
    conn.execute("CREATE TABLE out (a INTEGER, b TEXT, time INTEGER, diff INTEGER)")
    conn.commit()
    t = _md(pw, "a | b\n1 | x\n2 | y")
    pw.io.postgres.write(t, {}, "out", _connection=conn, _placeholder="?")
    pw.run()
    return list(sqlite3.connect(db).execute("SELECT a, b, diff FROM out ORDER BY a"))


def case_postgres_write_snapshot_upserts(pw, tmp):
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    conn.execute("CREATE TABLE snap (id INTEGER PRIMARY KEY, v TEXT)")
    pg = _mod(pw, "io.postgres")
    RowEvent = _mod(pw, "io._writer").RowEvent
    w = pg.PostgresSnapshotWriter(conn, "snap", ["id", "v"], ["id"], placeholder="?")
    w.write_batch([RowEvent(key=1, values={"id": 1, "v": "a"}, time=2, diff=1),
                   RowEvent(key=2, values={"id": 2, "v": "b"}, time=2, diff=1)])
    w.write_batch([RowEvent(key=1, values={"id": 1, "v": "a"}, time=4, diff=-1),
                   RowEvent(key=1, values={"id": 1, "v": "c"}, time=4, diff=1)])
    return list(conn.execute("SELECT id, v FROM snap ORDER BY id"))


def case_postgres_statements(pw, tmp):
    pg = _mod(pw, "io.postgres")
    return [pg.build_insert_statement("t", ["a", "b"]),
            pg.build_insert_statement("t", ["a"], placeholder="?"),
            list(pg.build_snapshot_statements("t", ["k", "v"], ["k"]))]


def case_postgres_updates_writer_roundtrip_sqlite(pw, tmp):
    path = os.path.join(tmp, "out.db")
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE events (name TEXT, qty INTEGER, time INTEGER, diff INTEGER)")
    t = _md(pw, """
        name | qty | __time__ | __diff__
        a    | 1   | 2        | 1
        b    | 2   | 2        | 1
        a    | 1   | 4        | -1
    """)
    writer = _mod(pw, "io.postgres").PostgresUpdatesWriter(db, "events", ["name", "qty"],
                                                          placeholder="?")
    _mod(pw, "io._writer").attach_writer(t, writer)
    pw.run(monitoring_level=None)
    return sorted(sqlite3.connect(path).execute("SELECT name, qty, time, diff FROM events"))


def case_postgres_snapshot_writer_roundtrip_sqlite(pw, tmp):
    path = os.path.join(tmp, "snap.db")
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE state (name TEXT PRIMARY KEY, qty INTEGER)")
    t = _md(pw, """
        name | qty | __time__ | __diff__
        a    | 1   | 2        | 1
        b    | 2   | 2        | 1
        a    | 1   | 4        | -1
        a    | 9   | 4        | 1
        b    | 2   | 6        | -1
    """)
    writer = _mod(pw, "io.postgres").PostgresSnapshotWriter(db, "state", ["name", "qty"],
                                                           ["name"], placeholder="?")
    _mod(pw, "io._writer").attach_writer(t, writer)
    pw.run(monitoring_level=None)
    return sorted(sqlite3.connect(path).execute("SELECT name, qty FROM state"))


# -- the sinks: questdb, logstash, slack, bigquery, pubsub, mongodb, dynamodb,
# -- elasticsearch --------------------------------------------------------------


def case_questdb_ilp_format(pw, tmp):
    fmt = _mod(pw, "io.questdb").format_ilp_line
    return [fmt("tbl", {"a": 1, "b": "x y", "c": 2.5}, 2, 1),
            fmt("t t", {"flag": True, "s": 'q"uote', "n": None}, 4, -1)]


def case_questdb_write_over_socket(pw, tmp):
    class FakeSock:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += b

        def close(self):
            pass

    sock = FakeSock()
    pw.io.questdb.write(_md(pw, "a | b\n1 | x\n2 | y"), "localhost", "metrics", _sock=sock)
    pw.run()
    return sorted(sock.data.decode().splitlines())


def case_logstash_and_slack_writers(pw, tmp):
    posts = []

    def fake_post(url, **kwargs):
        posts.append((url, kwargs))

    t = _md(pw, "msg\nalert1\nalert2")
    pw.io.logstash.write(t, "http://ls:8080", _post=fake_post)
    pw.io.slack.send_alerts(t.msg, "C01", "xoxb-token", _post=fake_post)
    pw.run()
    return sorted((_norm(p) for p in posts), key=repr)


def case_bigquery_and_pubsub_writers(pw, tmp):
    class FakeBQ:
        def __init__(self):
            self.rows = []

        def insert_rows_json(self, ref, rows):
            self.rows.extend((ref, r) for r in rows)
            return []

    class FakePublisher:
        def __init__(self):
            self.published = []

        def topic_path(self, project, topic):
            return f"projects/{project}/topics/{topic}"

        def publish(self, topic, data, **attrs):
            self.published.append((topic, json.loads(data.decode()), attrs))

    bq, pub = FakeBQ(), FakePublisher()
    t = _md(pw, "a | s\n7 | x\n8 | y")
    pw.io.bigquery.write(t, "ds", "tbl", _client=bq)
    pw.io.pubsub.write(t, publisher=pub, project_id="p", topic_id="top")
    pw.run()
    return [sorted(_norm(bq.rows), key=repr), sorted(_norm(pub.published), key=repr)]


def case_logstash_writer_with_fake_post(pw, tmp):
    posts = []

    def fake_post(endpoint, data=None, headers=None, **kwargs):
        posts.append((endpoint, data, headers, kwargs))

    pw.io.logstash.write(_md(pw, "msg\nhello"), "http://localhost:5044", _post=fake_post)
    pw.run()
    return _norm(posts)


def case_mongodb_dynamodb_elasticsearch_writers(pw, tmp):
    class FakeCollection:
        def __init__(self):
            self.docs = []

        def insert_many(self, docs):
            self.docs.extend(docs)

    class FakeDynamoTable:
        def __init__(self):
            self.items, self.log = {}, []

        def put_item(self, Item):
            self.items[Item["k"]] = Item
            self.log.append(("put", Item))

        def delete_item(self, Key):
            self.items.pop(Key["k"], None)
            self.log.append(("delete", Key))

    class FakeES:
        def __init__(self):
            self.docs = []

        def index(self, index, document):
            self.docs.append((index, document))

    coll, dyn, es = FakeCollection(), FakeDynamoTable(), FakeES()
    t = _md(pw, """
        k | v | __time__ | __diff__
        1 | a | 2        | 1
        2 | b | 2        | 1
        2 | b | 4        | -1
    """)
    pw.io.mongodb.write(t, _collection=coll)
    pw.io.dynamodb.write(t, "tbl", "k", _table_client=dyn)
    pw.io.elasticsearch.write(t, "http://es", None, "idx", _client=es)
    pw.run()
    return [sorted(_norm(coll.docs), key=repr), _norm(dyn.items),
            sorted(_norm(dyn.log), key=repr), sorted(_norm(es.docs), key=repr)]


# -- object stores and lakes: minio, deltalake, iceberg, _avro, _lake_fs -----


def _fake_s3_client(pw, objects):
    class FakeS3(_mod(pw, "io.s3").S3Client):
        def __init__(self):
            self.objects = dict(objects)

        def list_objects(self, prefix):
            return [(k, "v1") for k in self.objects if k.startswith(prefix)]

        def get_object(self, key):
            return self.objects[key]

    return FakeS3


def case_minio_read_with_fake_client(pw, tmp):
    settings = pw.io.minio.MinIOSettings(
        endpoint="minio.local:9000", bucket_name="b", access_key="k", secret_access_key="s"
    )
    factory = _fake_s3_client(pw, {"pfx/a.jsonl": b'{"a": 1}\n{"a": 2}', "pfx/b.jsonl": b'{"a": 3}'})
    t = pw.io.minio.read("pfx/", settings, format="json", schema=_schema(pw, a="INT"),
                         mode="static", _client_factory=factory)
    aws = settings.create_aws_settings()
    return [_rows(pw, t), aws.boto3_kwargs()]


def case_deltalake_round_trip(pw, tmp):
    uri = os.path.join(tmp, "delta")
    pw.io.deltalake.write(_md(pw, "a | b\n1 | x\n2 | y"), uri)
    pw.run()
    logs = sorted(os.listdir(os.path.join(uri, "_delta_log")))
    pw.G.clear()

    class ABSchema(pw.Schema):
        a: int
        b: str

    return [logs, _rows(pw, pw.io.deltalake.read(uri, ABSchema, mode="static"))]


def _kv(pw):
    """tests/test_lakes_and_db.py's _KV schema in `pw`."""

    class _KV(pw.Schema):
        k: str
        v: int

    return _KV


def _delta_state(pw, uri):
    import pyarrow.parquet as pq

    dl = _mod(pw, "io.deltalake")
    rows = []
    for f in sorted(dl._live_files(uri)):
        rows += pq.read_table(os.path.join(uri, f)).to_pylist()
    actions = [sorted(a) for v in dl._list_versions(uri) for a in dl._read_actions(uri, v)]
    return sorted(((r["k"], r["v"]), sorted(r)) for r in rows), sorted(actions)


def case_delta_snapshot_maintenance_round_trip(pw, tmp):
    uri = os.path.join(tmp, "snap")
    t = _md(pw, """
        id | k | v | __time__ | __diff__
         1 | a | 1 |    2     |    1
         2 | b | 2 |    2     |    1
         1 | a | 1 |    4     |   -1
         1 | a | 9 |    4     |    1
         3 | c | 3 |    6     |    1
    """)
    pw.io.deltalake.write(t, uri, output_table_type="snapshot")
    pw.run(monitoring_level=None)
    pw.G.clear()
    state = _delta_state(pw, uri)
    return [state, _rows(pw, pw.io.deltalake.read(uri, _kv(pw), mode="static"))]


def case_delta_snapshot_append_only_appends(pw, tmp):
    uri = os.path.join(tmp, "snap_app")
    t = _md(pw, """
        id | k | v | __time__
         1 | a | 1 |    2
         2 | b | 2 |    4
    """)
    pw.io.deltalake.write(t, uri, output_table_type="snapshot")
    pw.run(monitoring_level=None)
    dl = _mod(pw, "io.deltalake")
    removes = [a for v in dl._list_versions(uri) for a in dl._read_actions(uri, v) if "remove" in a]
    return [removes, len(dl._live_files(uri)), _delta_state(pw, uri)]


def case_delta_snapshot_resume_existing_table(pw, tmp):
    uri = os.path.join(tmp, "snap_resume")
    pw.io.deltalake.write(_md(pw, "id | k | v\n1 | a | 1\n2 | b | 2"), uri,
                          output_table_type="snapshot")
    pw.run(monitoring_level=None)
    pw.G.clear()
    t2 = _md(pw, """
        id | k | v | __time__ | __diff__
         1 | a | 1 |    2     |    1
         1 | a | 1 |    4     |   -1
         3 | c | 3 |    4     |    1
    """)
    pw.io.deltalake.write(t2, uri, output_table_type="snapshot")
    pw.run(monitoring_level=None)
    pw.G.clear()
    return _rows(pw, pw.io.deltalake.read(uri, _kv(pw), mode="static"))


def case_delta_read_start_from_timestamp(pw, tmp):
    uri = os.path.join(tmp, "by_time")
    pw.io.deltalake.write(_md(pw, "k | v\na | 1"), uri)
    pw.run(monitoring_level=None)
    pw.G.clear()
    time.sleep(0.05)
    cut_ms = int(time.time() * 1000)
    time.sleep(0.05)
    pw.io.deltalake.write(_md(pw, "k | v\nb | 2"), uri)
    pw.run(monitoring_level=None)
    pw.G.clear()
    return _rows(pw, pw.io.deltalake.read(uri, _kv(pw), mode="static",
                                          start_from_timestamp_ms=cut_ms))


def case_delta_round_trip_over_fake_s3(pw, tmp):
    client = FakeObjectClient()
    pw.io.deltalake.write(_md(pw, "k | v\na | 1\nb | 2"), "s3://bucket/lake/t1",
                          _object_client=client)
    pw.run(monitoring_level=None)
    pw.G.clear()
    keys = client.list("lake/t1/")
    shape = [any("_delta_log" in k for k in keys), sum(k.endswith(".parquet") for k in keys)]
    r = pw.io.deltalake.read("s3://bucket/lake/t1", _kv(pw), mode="static",
                             _object_client=client)
    return [shape, _rows(pw, r)]


def case_delta_snapshot_over_fake_s3_with_deletions(pw, tmp):
    client = FakeObjectClient()
    t = _md(pw, """
        id | k | v | __time__ | __diff__
         1 | a | 1 |    2     |    1
         2 | b | 2 |    2     |    1
         1 | a | 1 |    4     |   -1
         1 | a | 9 |    4     |    1
    """)
    pw.io.deltalake.write(t, "s3://bucket/snap", output_table_type="snapshot",
                          _object_client=client)
    pw.run(monitoring_level=None)
    pw.G.clear()
    r = pw.io.deltalake.read("s3://bucket/snap", _kv(pw), mode="static",
                             _object_client=client)
    return _rows(pw, r)


def _iceberg_write(pw, warehouse, rows, **kwargs):
    t = pw.debug.table_from_rows(pw.schema_from_types(name=str, qty=int), rows)
    pw.io.iceberg.write(t, warehouse=warehouse, namespace=["db"], table_name="items", **kwargs)
    pw.run(monitoring_level=None)
    pw.G.clear()


def _iceberg_read(pw, warehouse, **kwargs):
    return pw.io.iceberg.read(warehouse=warehouse, namespace=["db"], table_name="items",
                              schema=pw.schema_from_types(name=str, qty=int), mode="static",
                              **kwargs)


def _iceberg_meta(uri):
    meta_dir = os.path.join(uri, "metadata")
    with open(os.path.join(meta_dir, "version-hint.text")) as fh:
        hint = fh.read()
    with open(os.path.join(meta_dir, f"v{hint}.metadata.json")) as fh:
        return hint, json.load(fh)


def case_iceberg_round_trip(pw, tmp):
    uri = os.path.join(tmp, "iceberg")
    pw.io.iceberg.write(_md(pw, "a | b\n3 | p\n4 | q"), warehouse=uri)
    pw.run()
    pw.G.clear()

    class ABSchema(pw.Schema):
        a: int
        b: str

    t2 = pw.io.iceberg.read(warehouse=uri, schema=ABSchema, mode="static")
    return [os.path.isdir(os.path.join(uri, "metadata")), _rows(pw, t2)]


def case_iceberg_v2_metadata_shape(pw, tmp):
    ice = _mod(pw, "io.iceberg")
    lake_fs = _mod(pw, "io._lake_fs")
    _iceberg_write(pw, tmp, [("a", 1), ("b", 2)])
    uri = os.path.join(tmp, "db", "items")
    hint, meta = _iceberg_meta(uri)
    (schema,) = meta["schemas"]
    (snap,) = meta["snapshots"]
    fs = lake_fs.LocalLakeFS(uri)
    (mf,) = ice._load_manifest_list(fs, snap["manifest-list"])
    (entry,) = ice._load_manifest_entries(fs, mf["manifest_path"])
    data_file = entry["data_file"]
    return [hint, sorted(meta), meta["format-version"], schema,
            snap["sequence-number"], snap["summary"]["operation"],
            snap["snapshot-id"] == meta["current-snapshot-id"],
            mf["added_rows_count"], entry["status"], data_file["file_format"],
            data_file["record_count"],
            os.path.getsize(os.path.join(uri, data_file["file_path"]))
            == data_file["file_size_in_bytes"]]


def case_iceberg_manifests_are_spec_avro(pw, tmp):
    read_ocf = _mod(pw, "io._avro").read_ocf
    _iceberg_write(pw, tmp, [("a", 1), ("b", 2)])
    meta_dir = os.path.join(tmp, "db", "items", "metadata")
    out = []
    for f in sorted(os.listdir(meta_dir)):
        if not f.endswith(".avro"):
            continue
        path = os.path.join(meta_dir, f)
        with open(path, "rb") as fh:
            magic = fh.read(4)
        schema, records = read_ocf(path)
        out.append((f.startswith("snap-"), magic, schema, len(records)))
    return sorted(out, key=repr)


def case_iceberg_legacy_json_manifests_still_read(pw, tmp):
    ice = _mod(pw, "io.iceberg")
    with open(os.path.join(tmp, "legacy-list.json"), "w") as fh:
        json.dump({"manifests": [{"manifest_path": "m.json", "manifest_length": 10}]}, fh)
    with open(os.path.join(tmp, "m.json"), "w") as fh:
        json.dump({"entries": [{"status": 1, "data_file": {"file_path": "d.parquet"}}]}, fh)
    fs = _mod(pw, "io._lake_fs").LocalLakeFS(tmp)
    return [ice._load_manifest_list(fs, "legacy-list.json"),
            ice._load_manifest_entries(fs, "m.json")]


def case_iceberg_roundtrip_multiple_snapshots(pw, tmp):
    _iceberg_write(pw, tmp, [("a", 1), ("b", 2)])
    _iceberg_write(pw, tmp, [("c", 3)])
    hint, meta = _iceberg_meta(os.path.join(tmp, "db", "items"))
    got = {}
    pw.io.subscribe(_iceberg_read(pw, tmp), on_change=lambda key, row, time, is_addition:
                    got.__setitem__(row["name"], row["qty"]))
    pw.run(monitoring_level=None)
    snaps = meta["snapshots"]
    return [hint, len(snaps), snaps[1]["parent-snapshot-id"] == snaps[0]["snapshot-id"],
            meta["last-sequence-number"], len(meta["metadata-log"]), got]


def case_iceberg_append_upgrades_old_layout(pw, tmp):
    meta_dir_name = _mod(pw, "io.iceberg")._META_DIR
    uri = os.path.join(tmp, "old_table")
    os.makedirs(os.path.join(uri, meta_dir_name))
    with open(os.path.join(uri, meta_dir_name, "v1.metadata.json"), "w") as fh:
        json.dump({"format-version": 2, "snapshots": [], "current-snapshot-id": -1}, fh)
    t = pw.debug.table_from_rows(pw.schema_from_types(name=str, qty=int), [("a", 1)])
    pw.io.iceberg.write(t, warehouse=uri)
    pw.run(monitoring_level=None)
    hint, meta = _iceberg_meta(uri)
    return [hint, len(meta["snapshot-log"]), len(meta["snapshots"])]


def case_iceberg_round_trip_over_fake_s3(pw, tmp):
    client = FakeObjectClient()
    _iceberg_write(pw, "s3://bucket/wh", [("a", 1), ("b", 2)], _object_client=client)
    keys = client.list("wh/db/items/")
    shape = [sum(k.endswith(".metadata.json") for k in keys), sum(k.endswith(".avro") for k in keys),
             sum(k.endswith(".parquet") for k in keys)]
    return [shape, _rows(pw, _iceberg_read(pw, "s3://bucket/wh", _object_client=client))]


def case_iceberg_catalog_uri_not_silently_repurposed(pw, tmp):
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
    return [
        _raises(lambda: pw.io.iceberg.write(t, catalog_uri="http://localhost:8181",
                                            namespace=["db"], table_name="x")),
        _raises(lambda: pw.io.iceberg.read(catalog_uri="https://catalog.example.com/",
                                           namespace=["db"], table_name="x",
                                           schema=pw.schema_from_types(a=int), mode="static")),
    ]


def case_avro_codec_round_trip_edge_values(pw, tmp):
    avro = _mod(pw, "io._avro")
    schema = {
        "type": "record",
        "name": "row",
        "fields": [
            {"name": "n", "type": "long"},
            {"name": "s", "type": ["null", "string"]},
            {"name": "d", "type": "double"},
            {"name": "b", "type": "boolean"},
            {"name": "xs", "type": {"type": "array", "items": "long"}},
            {"name": "m", "type": {"type": "map", "values": "string"}},
        ],
    }
    records = [
        {"n": 0, "s": None, "d": 0.0, "b": False, "xs": [], "m": {}},
        {"n": -1, "s": "żółć", "d": -2.5, "b": True, "xs": [-(2**40), 7], "m": {"k": "v"}},
        {"n": 2**62, "s": "", "d": 1e300, "b": False, "xs": [0], "m": {}},
    ]
    path = os.path.join(tmp, "t.avro")
    avro.write_ocf(path, schema, records)
    with open(path, "rb") as fh:
        magic = fh.read(4)
    return [magic, avro.read_ocf(path)]


def case_lake_fs_local_and_object_store(pw, tmp):
    import pyarrow as pa

    lake_fs = _mod(pw, "io._lake_fs")
    local = lake_fs.LocalLakeFS(os.path.join(tmp, "lake"))
    local.write_bytes("a/b.bin", b"payload")
    table = pa.table({"x": [1, 2, 3], "s": ["p", "q", "r"]})
    n_local = lake_fs.write_parquet(local, "t/part-0.parquet", table)
    client = FakeObjectClient()
    remote = lake_fs.resolve_lake_fs("s3://bucket/root", _object_client=client)
    remote.write_bytes("a/b.bin", b"payload")
    n_remote = lake_fs.write_parquet(remote, "t/part-0.parquet", table)
    return [local.read_bytes("a/b.bin"), remote.read_bytes("a/b.bin"), n_local == n_remote,
            lake_fs.read_parquet(local, "t/part-0.parquet").to_pylist(),
            lake_fs.read_parquet(remote, "t/part-0.parquet").to_pylist(),
            sorted(client.objects), local.listdir("t"), remote.listdir("t"),
            type(lake_fs.as_fs(os.path.join(tmp, "lake"))).__name__]


# -- drives and file systems: gdrive, pyfilesystem ---------------------------


def case_gdrive_read_with_fake_client(pw, tmp):
    class FakeDrive:
        def tree(self, root_id):
            return {
                "f1": {"id": "f1", "name": "doc.txt", "mimeType": "text/plain", "modifiedTime": "t1"},
                "f2": {"id": "f2", "name": "b.md", "mimeType": "text/markdown", "modifiedTime": "t2"},
            }

        def download(self, meta):
            return f"hello {meta['name']}".encode()

    t = pw.io.gdrive.read("root", mode="static", with_metadata=True, _client_factory=FakeDrive)
    (cap,) = _run_tables(pw, t)
    # seen_at is the read's clock, in seconds
    return sorted((data, {k: v for k, v in meta.value.items() if k != "seen_at"})
                  for data, meta in cap.state.rows.values())


def case_pyfilesystem_read_with_fake_fs(pw, tmp):
    class Walk:
        def files(self, path):
            return ["/a.txt", "/b.txt"]

    class FakeFS:
        walk = Walk()

        def getinfo(self, path, namespaces=None):
            class I:
                modified = None

            return I()

        def readbytes(self, path):
            return path.encode()

    plain = _rows(pw, pw.io.pyfilesystem.read(FakeFS(), mode="static"))
    pw.G.clear()
    (cap,) = _run_tables(pw, pw.io.pyfilesystem.read(FakeFS(), mode="static", with_metadata=True))
    # seen_at is the read's clock, in seconds
    return [plain, sorted((data, {k: v for k, v in meta.value.items() if k != "seen_at"})
                          for data, meta in cap.state.rows.values())]


# -- the client libraries this machine lacks: each connector up to its import --


def case_missing_client_libraries(pw, tmp):
    t = _md(pw, "k | v\n1 | a")
    out = {
        "postgres": _raises(lambda: _mod(pw, "io.postgres")._connect({"host": "localhost"})),
        "kafka": _raises(lambda: _mod(pw, "io.kafka")._ConfluentClient({}, ["t"], for_read=True)),
        "nats": _raises(lambda: _mod(pw, "io.nats")._NatsClient("nats://localhost:4222", "t",
                                                                  for_read=True)),
        "mqtt": _raises(lambda: _mod(pw, "io.mqtt")._PahoClient("mqtt://localhost:1883", "t",
                                                                  for_read=True)),
        "mongodb": _raises(lambda: pw.io.mongodb.write(t, connection_string="mongodb://localhost",
                                                       database="d", collection="c")),
        "dynamodb": _raises(lambda: pw.io.dynamodb.write(t, "tbl", "k")),
        "elasticsearch": _raises(lambda: pw.io.elasticsearch.write(t, "http://localhost:9200",
                                                                   None, "idx")),
        "pubsub": _raises(lambda: pw.io.pubsub.write(t, project_id="p", topic_id="x")),
        "gdrive": _raises(lambda: _mod(pw, "io.gdrive")._GDriveApiClient("creds.json")),
    }
    return out


# -- pw.demo: synthetic and replayed streams ---------------------------------


def _final(pw, table) -> list:
    """The table's rows once its stream has ended, and how many deltas
    came; the engine times of a demo stream follow the clock."""
    rows = _collect(pw, table)
    pw.run(monitoring_level=None)
    state: dict = {}
    for row, add in rows:
        key = json.dumps(_norm(row), sort_keys=True, default=repr)
        state[key] = state.get(key, 0) + (1 if add else -1)
    return [sorted(k for k, n in state.items() for _ in range(n)), len(rows)]


def case_demo_range_and_noisy_linear_streams(pw, tmp):
    out = _final(pw, pw.demo.range_stream(nb_rows=25, offset=3, input_rate=1e5))
    pw.G.clear()
    return [out, _final(pw, pw.demo.noisy_linear_stream(nb_rows=12, input_rate=1e5))]


def case_demo_generate_custom_stream(pw, tmp):
    schema = pw.schema_from_types(i=int, sq=int, s=str)
    t = pw.demo.generate_custom_stream(
        {"i": lambda i: i, "sq": lambda i: i * i, "s": lambda i: f"row{i % 4}"},
        schema=schema, nb_rows=40, input_rate=1e5,
    )
    agg = t.groupby(pw.this.s).reduce(s=pw.this.s, n=pw.reducers.count(),
                                        total=pw.reducers.sum(pw.this.sq))
    return _final(pw, agg)[0]


def _replay_file(tmp) -> str:
    path = os.path.join(tmp, "replay.csv")
    rng = np.random.default_rng(5)
    with open(path, "w") as fh:
        fh.write("key,value,flag,ts\n")
        for i in range(60):
            fh.write(f"k{int(rng.integers(5))},{int(rng.integers(100))},"
                     f"{'true' if i % 3 else 'false'},{i * 2}\n")
    return path


def case_demo_replay_csv_through_a_groupby(pw, tmp):
    schema = pw.schema_from_types(key=str, value=int, flag=bool)
    t = pw.demo.replay_csv(_replay_file(tmp), schema=schema, input_rate=1e5)
    agg = t.groupby(pw.this.key).reduce(key=pw.this.key, n=pw.reducers.count(),
                                        total=pw.reducers.sum(pw.this.value))
    return _final(pw, agg)[0]


def case_demo_replay_csv_with_time(pw, tmp):
    schema = pw.schema_from_types(key=str, value=int, flag=bool, ts=int)
    t = pw.demo.replay_csv_with_time(_replay_file(tmp), schema=schema, time_column="ts",
                                     unit="ms", speedup=100.0)
    return _final(pw, t)


# -- connector-runtime cases of tests/test_io_connectors.py ------------------


def case_synchronization_group_semantics(pw, tmp):
    SynchronizationGroup = _mod(pw, "io._synchronization").SynchronizationGroup

    class Src:
        sync_group = None
        sync_column = None

    a, b = Src(), Src()
    g = SynchronizationGroup(max_difference=10)
    g.add_source(a, "t")
    g.add_source(b, "t")
    g.wait_for(a, 0)
    g.wait_for(b, 0)
    out = [g._may_emit(b, 5), g._may_emit(b, 10), g._may_emit(b, 11)]
    g._frontier[a] = 100
    out.append(g._may_emit(b, 50))
    g.source_closed(a)
    out.append(g._may_emit(b, 1000))
    return out


def case_synchronization_group_end_to_end(pw, tmp):
    class TSchema(pw.Schema):
        t: int

    class FastSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(0, 50, 10):
                self.next(t=i)
            self.commit()

    class SlowSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(0, 50, 10):
                time.sleep(0.02)
                self.next(t=i)
            self.commit()

    t1 = pw.io.python.read(FastSubject, schema=TSchema)
    t2 = pw.io.python.read(SlowSubject, schema=TSchema)
    pw.io.register_input_synchronization_group(t1.t, t2.t, max_difference=10)
    r1, r2 = _collect(pw, t1), _collect(pw, t2)
    pw.run()
    return [sorted(r["t"] for r, add in r1 if add), sorted(r["t"] for r, add in r2 if add)]


def case_synchronization_group_all_jump_ahead_no_deadlock(pw, tmp):
    class TSchema(pw.Schema):
        t: int

    class JumpSubject(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(t=0)
            self.next(t=100)
            self.next(t=200)
            self.commit()

    t1 = pw.io.python.read(JumpSubject, schema=TSchema)
    t2 = pw.io.python.read(JumpSubject, schema=TSchema)
    pw.io.register_input_synchronization_group(t1.t, t2.t, max_difference=10)
    r1, r2 = _collect(pw, t1), _collect(pw, t2)
    pw.run()
    return [sorted(r["t"] for r, add in r1 if add), sorted(r["t"] for r, add in r2 if add)]


def case_keyless_retraction_cancels_insert(pw, tmp):
    class DSchema(pw.Schema):
        data: str

    class UpsertSubject(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(data="v1")
            self.commit()
            self._remove({"data": "v1"})
            self.next(data="v2")
            self.commit()

    rows = _collect(pw, pw.io.python.read(UpsertSubject, schema=DSchema))
    pw.run()
    final = {}
    for row, add in rows:
        final[row["data"]] = final.get(row["data"], 0) + (1 if add else -1)
    return {k: v for k, v in final.items() if v}


def case_schema_primary_key_typo_rejected(pw, tmp):
    def make():
        class Bad(pw.Schema, primary_key=["idd"]):
            id: int

    return _raises(make)


def case_s3_read_with_fake_client(pw, tmp):
    factory = _fake_s3_client(pw, {"pfx/a.jsonl": b'{"a": 1}\n{"a": 2}', "pfx/b.jsonl": b'{"a": 3}'})
    t = pw.io.s3.read("pfx/", format="json", schema=_schema(pw, a="INT"), mode="static",
                      _client_factory=factory)
    return _rows(pw, t)


def case_s3_csv_settings_honored(pw, tmp):
    factory = _fake_s3_client(pw, {"pre/d.csv": b"# c\na;b\n1;x\n"})
    t = pw.io.s3.read("pre", format="csv", schema=pw.schema_from_types(a=int, b=str),
                      mode="static", csv_settings=pw.io.CsvParserSettings(
                          delimiter=";", comment_character="#"), _client_factory=factory)
    return _rows(pw, t)


def case_csv_parser_settings(pw, tmp):
    with open(os.path.join(tmp, "d.csv"), "w") as fh:
        fh.write('# header comment\na;b\n1;"x;1"\n2;y\n')
    with open(os.path.join(tmp, "e.csv"), "w") as fh:
        fh.write('a;b\n3;"x\n# not a comment\ny"\n')
    t = pw.io.csv.read(tmp, schema=pw.schema_from_types(a=int, b=str), mode="static",
                       csv_settings=pw.io.CsvParserSettings(delimiter=";", comment_character="#"))
    return _rows(pw, t)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def _limited(fn, seconds: float):
    """fn() on a daemon thread; its value, or a failure after `seconds`."""
    box: dict = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"the case did not end within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _run_case(package: str, case, tmp_path):
    pw = PACKAGES[package]
    tmp = str(tmp_path / package)
    os.makedirs(tmp)
    pw.G.clear()
    try:
        return _norm(_limited(lambda: case(pw, tmp), CASE_SECONDS))
    finally:
        pw.G.clear()


def _non_empty(v) -> bool:
    if isinstance(v, (list, tuple, dict)):
        return len(v) > 0 and any(_non_empty(x) for x in (v.values() if isinstance(v, dict) else v))
    return v is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_connector_matches_jax(case, tmp_path):
    want = _run_case("jax", CASES[case], tmp_path)
    got = _run_case("port", CASES[case], tmp_path)
    assert _close(got, want), f"{case}: port {got!r}\n  jax {want!r}"
    assert _non_empty(want), f"{case}: nothing came out"
