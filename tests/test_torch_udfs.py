"""UDFs through the port and the JAX package, on the CPU.

The cases of tests/test_udf_system.py (7) and
tests/test_matrix_udf_ported.py (24 functions) run once through
`pathway_tpu` and once through `pathway_tpu_torch` (the `pw` fixture),
on the same inputs and with the same expectations: sync batching, async
capacity / timeout / retry, the in-memory and disk caches, the
fully-async executor, determinism, propagate_none and return-type casts.
A further case runs a set of UDF dataflows through both packages and
requires the two subscribe streams to be equal, keys and times included.

Last, the port's device probe: its probe code imports torch and not JAX,
and without a CUDA card it reports an error and never falls back to the
CPU.
"""

import asyncio
import ast
import json
import pathlib
import threading
import time
from importlib import import_module

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(params=["jax", "port"])
def pw(request):
    pkg = PACKAGES[request.param]
    pkg.G.clear()
    yield pkg
    pkg.G.clear()


def _run_tables(pw, *tables, **kwargs):
    return import_module(f"{pw.__name__}.internals.runner").run_tables(*tables, **kwargs)


def _engine(pw):
    return import_module(f"{pw.__name__}.engine.engine").Engine()


def _rows(pw, table):
    (cap,) = _run_tables(pw, table)
    return sorted(cap.state.rows.values(), key=repr)


def _rows_plain(pw, table):
    (cap,) = _run_tables(pw, table)
    return sorted(cap.state.rows.values())


def T(pw, md):
    return pw.debug.table_from_markdown(md)


def _t123(pw):
    return pw.debug.table_from_markdown(
        """
        v
        1
        2
        3
        """
    )


# -- the cases of tests/test_udf_system.py ------------------------------------


def test_sync_udf_batches_by_max_batch_size(pw):
    batch_sizes = []

    @pw.udf(max_batch_size=2)
    def doubled(vs: list) -> list:
        batch_sizes.append(len(vs))
        return [v * 2 for v in vs]

    res = _t123(pw).select(d=doubled(pw.this.v))
    assert _rows(pw, res) == [(2,), (4,), (6,)]
    assert max(batch_sizes) <= 2 and sum(batch_sizes) == 3


def test_async_udf_capacity_limits_concurrency(pw):
    active = [0]
    peak = [0]
    lock = threading.Lock()

    @pw.udf(executor=pw.udfs.async_executor(capacity=2))
    async def slow(v: int) -> int:
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        await asyncio.sleep(0.05)
        with lock:
            active[0] -= 1
        return v * 10

    t = pw.debug.table_from_rows(
        pw.schema_from_types(v=int), [(i,) for i in range(6)]
    )
    res = t.select(r=slow(pw.this.v))
    assert [r[0] for r in _rows(pw, res)] == [0, 10, 20, 30, 40, 50]
    assert peak[0] <= 2


def test_async_udf_timeout_yields_error(pw):
    @pw.udf(executor=pw.udfs.async_executor(timeout=0.05))
    async def too_slow(v: int) -> int:
        await asyncio.sleep(1.0)
        return v

    t = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(1,)])
    res = t.select(r=too_slow(pw.this.v))
    eng = _engine(pw)
    (cap,) = _run_tables(pw, res, engine=eng)
    ((r,),) = cap.state.rows.values()
    assert r is pw.Error
    assert eng.error_log


def test_retry_strategy_retries_until_success(pw):
    attempts = [0]

    @pw.udf(
        executor=pw.udfs.async_executor(
            retry_strategy=pw.udfs.ExponentialBackoffRetryStrategy(
                max_retries=5, initial_delay=1, backoff_factor=1
            )
        )
    )
    async def flaky(v: int) -> int:
        attempts[0] += 1
        if attempts[0] < 3:
            raise RuntimeError("transient")
        return v * 2

    t = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(21,)])
    res = t.select(r=flaky(pw.this.v))
    assert _rows(pw, res) == [(42,)]
    assert attempts[0] == 3


def test_in_memory_cache_deduplicates_calls(pw):
    calls = [0]

    @pw.udf(cache_strategy=pw.udfs.InMemoryCache())
    def expensive(v: int) -> int:
        calls[0] += 1
        return v + 100

    t = pw.debug.table_from_rows(
        pw.schema_from_types(v=int), [(1,), (1,), (2,), (1,)]
    )
    res = t.select(r=expensive(pw.this.v))
    assert [r[0] for r in _rows(pw, res)] == [101, 101, 101, 102]
    assert calls[0] == 2  # one evaluation per distinct argument


def test_fully_async_udf_streams_results(pw):
    """Fully-async UDFs return Pending first, then upsert the result
    (reference: async_transformer.rs design; executors.py:226)."""

    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def enrich(v: int) -> int:
        await asyncio.sleep(0.01)
        return v * 3

    t = pw.debug.table_from_markdown(
        """
        v | __time__
        5 | 2
        """
    )
    res = t.select(r=enrich(pw.this.v))
    got = []
    pw.io.subscribe(
        res,
        on_change=lambda key, row, time, is_addition: got.append(
            (row["r"], is_addition)
        ),
    )
    pw.run()
    assert (15, True) in got
    final = [v for v, add in got if add][-1]
    assert final == 15


def test_udf_deterministic_false_keeps_results_stable_on_update(pw):
    """Non-deterministic UDFs must not re-execute for unchanged rows when
    an unrelated row updates (the engine caches their outputs)."""
    calls = [0]

    @pw.udf(deterministic=False)
    def tag(v: int) -> int:
        calls[0] += 1
        return v

    t = pw.debug.table_from_markdown(
        """
        name | v | __time__ | __diff__
        a    | 1 | 2        | 1
        b    | 2 | 2        | 1
        b    | 2 | 4        | -1
        b    | 5 | 4        | 1
        """
    ).with_id_from(pw.this.name)
    t = t.select(v=pw.this.v)
    res = t.select(r=tag(pw.this.v))
    (cap,) = _run_tables(pw, res)
    assert sorted(r[0] for r in cap.state.rows.values()) == [1, 5]
    assert calls[0] == 3  # a, b, updated b — NOT a second evaluation of a


# -- the cases of tests/test_matrix_udf_ported.py -------------------------------
# basics: function and class UDFs, sync and async


def test_udf_function_basic(pw):
    @pw.udf
    def inc(a: int) -> int:
        return a + 1

    t = T(pw, 
        """
        a
        1
        2
        """
    )
    r = t.select(v=inc(t.a))
    assert r.typehints()["v"] is int
    assert _rows_plain(pw, r) == [(2,), (3,)]


def test_udf_class_with_state(pw):
    class Inc(pw.UDF):
        def __init__(self, by: int):
            super().__init__()
            self.by = by

        def __wrapped__(self, a: int) -> int:
            return a + self.by

    inc = Inc(by=10)
    t = T(pw, 
        """
        a
        1
        2
        """
    )
    r = t.select(v=inc(t.a))
    assert _rows_plain(pw, r) == [(11,), (12,)]


def test_udf_async_function(pw):
    @pw.udf
    async def inc(a: int) -> int:
        await asyncio.sleep(0.001)
        return a + 1

    t = T(pw, 
        """
        a
        1
        2
        3
        """
    )
    r = t.select(v=inc(t.a))
    assert _rows_plain(pw, r) == [(2,), (3,), (4,)]


def test_udf_async_runs_concurrently(pw):
    """Async udf calls in one batch overlap — total stall far below the
    sum of individual sleeps (reference: test_udf_async)."""

    @pw.udf
    async def slow(a: int) -> int:
        await asyncio.sleep(0.2)
        return a

    t = T(pw, 
        """
        a
        1
        2
        3
        4
        """
    )
    start = time.monotonic()
    r = t.select(v=slow(t.a))
    assert _rows_plain(pw, r) == [(1,), (2,), (3,), (4,)]
    assert time.monotonic() - start < 0.7  # 4 x 0.2s would be 0.8+


def test_udf_with_kwargs_and_defaults(pw):
    @pw.udf
    def combine(a: int, plus: int = 5) -> int:
        return a + plus

    t = T(pw, 
        """
        a
        1
        """
    )
    r = t.select(x=combine(t.a), y=combine(t.a, plus=100))
    assert _rows_plain(pw, r) == [(6, 101)]


# propagate_none (reference: test_udf_propagate_none)


@pytest.mark.parametrize("is_async", [False, True])
def test_udf_propagate_none(pw, is_async):
    calls = []

    if is_async:

        @pw.udf(propagate_none=True)
        async def f(a: int, b: int) -> int:
            calls.append((a, b))
            return a + b

    else:

        @pw.udf(propagate_none=True)
        def f(a: int, b: int) -> int:
            calls.append((a, b))
            return a + b

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int, b=int),
        [(1, 2), (3, None), (None, 4)],
    )
    r = t.select(v=f(t.a, t.b))
    vals = sorted(
        (v for (v,) in _rows(pw, r)), key=lambda x: (x is None, x or 0)
    )
    assert vals == [3, None, None]
    # the function body never saw a None argument
    assert calls == [(1, 2)]


def test_udf_without_propagate_none_sees_none(pw):
    seen = []

    @pw.udf
    def f(a) -> int:
        seen.append(a)
        return 0 if a is None else 1

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(1,), (None,)]
    )
    r = t.select(v=f(t.a))
    assert sorted(v for (v,) in _rows_plain(pw, r)) == [0, 1]
    assert None in seen


# determinism and result storage (reference: test_udf_make_deterministic)


def test_non_deterministic_udf_results_stored_for_retraction(pw):
    """A non-deterministic udf must NOT be re-run to process a
    retraction; the engine replays the stored result (reference:
    test_udf_make_deterministic)."""
    counter = {"n": 0}

    @pw.udf  # deterministic=False is the default
    def fresh(a: int) -> int:
        counter["n"] += 1
        return a * 100 + counter["n"]

    t = pw.debug.table_from_markdown(
        """
        k | a | __time__ | __diff__
        1 | 7 |    2     |    1
        1 | 7 |    4     |   -1
        """
    )
    r = t.select(v=fresh(t.a))
    assert _rows_plain(pw, r) == []  # inserted then retracted cleanly
    assert counter["n"] == 1  # called once, retraction reused the result


def test_deterministic_udf_may_rerun(pw):
    counter = {"n": 0}

    @pw.udf(deterministic=True)
    def det(a: int) -> int:
        counter["n"] += 1
        return a * 2

    t = pw.debug.table_from_markdown(
        """
        k | a | __time__ | __diff__
        1 | 7 |    2     |    1
        1 | 7 |    4     |   -1
        """
    )
    r = t.select(v=det(t.a))
    assert _rows_plain(pw, r) == []
    assert counter["n"] >= 1


# caching (reference: test_udf_cache / in_memory_cache)


def test_udf_in_memory_cache_deduplicates_calls(pw):
    counter = {"n": 0}

    @pw.udf(cache_strategy=pw.udfs.InMemoryCache())
    def slow_id(a: int) -> int:
        counter["n"] += 1
        return a

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(1,), (1,), (1,), (2,)]
    )
    r = t.select(v=slow_id(t.a))
    assert sorted(v for (v,) in _rows_plain(pw, r)) == [1, 1, 1, 2]
    assert counter["n"] == 2  # one call per distinct argument


def test_udf_disk_cache_survives_runs(pw, tmp_path: pathlib.Path, monkeypatch):
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(tmp_path))
    counter = {"n": 0}

    @pw.udf(cache_strategy=pw.udfs.DiskCache(name="c1"))
    def slow_id(a: int) -> int:
        counter["n"] += 1
        return a * 3

    def run_once():
        t = pw.debug.table_from_rows(
            pw.schema_from_types(a=int), [(1,), (2,)]
        )
        return _rows_plain(pw, t.select(v=slow_id(t.a)))

    assert run_once() == [(3,), (6,)]
    first = counter["n"]
    assert first >= 2
    assert run_once() == [(3,), (6,)]
    assert counter["n"] == first  # second run served from disk
    # the cache really lives under the configured storage root
    import os

    assert os.path.isdir(tmp_path / "udf_cache" / "c1")


# timeouts / retries (reference: test_udf_timeout)


def test_async_udf_timeout_is_error(pw):
    @pw.udf(executor=pw.udfs.async_executor(timeout=0.05))
    async def hang(a: int) -> int:
        await asyncio.sleep(5)
        return a

    t = T(pw, 
        """
        a
        1
        """
    )
    r = t.select(a=t.a, v=hang(t.a))
    ((_, v),) = _rows(pw, r)
    assert repr(v) == "Error"


def test_async_udf_fast_enough_for_timeout(pw):
    @pw.udf(executor=pw.udfs.async_executor(timeout=5.0))
    async def quick(a: int) -> int:
        return a + 1

    t = T(pw, 
        """
        a
        1
        """
    )
    assert _rows_plain(pw, t.select(v=quick(t.a))) == [(2,)]


def test_async_udf_retries_until_success(pw):
    attempts = {"n": 0}

    @pw.udf(
        executor=pw.udfs.async_executor(
            retry_strategy=pw.udfs.ExponentialBackoffRetryStrategy(
                max_retries=5, initial_delay=1, backoff_factor=1
            )
        )
    )
    async def flaky(a: int) -> int:
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("transient")
        return a

    t = T(pw, 
        """
        a
        7
        """
    )
    assert _rows_plain(pw, t.select(v=flaky(t.a))) == [(7,)]
    assert attempts["n"] == 3


# batching (reference: test_batch_udf*)


def test_batch_udf_receives_lists(pw):
    batches = []

    @pw.udf(max_batch_size=10)
    def add(a: list[int], b: list[int]) -> list[int]:
        batches.append(len(a))
        return [x + y for x, y in zip(a, b)]

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int, b=int),
        [(1, 10), (2, 20), (3, 30)],
    )
    r = t.select(v=add(t.a, t.b))
    assert sorted(v for (v,) in _rows_plain(pw, r)) == [11, 22, 33]
    assert sum(batches) == 3


@pytest.mark.parametrize("max_batch_size", [1, 2])
def test_batch_udf_respects_max_batch_size(pw, max_batch_size):
    batches = []

    @pw.udf(max_batch_size=max_batch_size)
    def ident(a: list[int]) -> list[int]:
        batches.append(len(a))
        return list(a)

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(i,) for i in range(6)]
    )
    r = t.select(v=ident(t.a))
    assert sorted(v for (v,) in _rows_plain(pw, r)) == list(range(6))
    assert all(b <= max_batch_size for b in batches)


def test_batch_udf_wrong_row_count_is_error(pw):
    @pw.udf(max_batch_size=10)
    def bad(a: list[int]) -> list[int]:
        return [1]  # wrong length for multi-row batches

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(1,), (2,), (3,)]
    )
    r = t.select(a=t.a, v=bad(t.a))
    rows = _rows(pw, r)
    assert any(repr(v) == "Error" for _a, v in rows) or len(rows) == 3


def test_error_in_batch_udf_contained_per_batch(pw):
    @pw.udf(max_batch_size=10)
    def boom(a: list[int]) -> list[int]:
        raise RuntimeError("nope")

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(1,)]
    )
    r = t.select(a=t.a, v=boom(t.a))
    ((_, v),) = _rows(pw, r)
    assert repr(v) == "Error"


# return-type handling (reference: test_cast_on_return)


def test_udf_return_type_casts_value(pw):
    @pw.udf(return_type=float)
    def f(a: int):
        return a  # returns int, declared float

    t = T(pw, 
        """
        a
        1
        """
    )
    r = t.select(v=f(t.a))
    assert r.typehints()["v"] is float
    ((v,),) = _rows_plain(pw, r)
    assert v == 1.0 and isinstance(v, float)


def test_udf_exception_is_error_value_and_row_survives(pw):
    @pw.udf
    def boom(a: int) -> int:
        if a == 2:
            raise ValueError("bad")
        return a

    t = T(pw, 
        """
        a
        1
        2
        """
    )
    r = t.select(a=t.a, v=boom(t.a))
    got = {a: v for a, v in _rows(pw, r)}
    assert got[1] == 1
    assert repr(got[2]) == "Error"


# fully-async UDFs (reference: test_fully_async_udf*)


def test_fully_async_udf_completes_with_await_futures(pw):
    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def slow_inc(a: int) -> int:
        await asyncio.sleep(0.01)
        return a + 1

    t = T(pw, 
        """
        a
        1
        2
        """
    )
    r = t.select(v=slow_inc(t.a)).await_futures()
    assert _rows_plain(pw, r) == [(2,), (3,)]


def test_fully_async_udf_chaining(pw):
    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def inc(a: int) -> int:
        await asyncio.sleep(0.005)
        return a + 1

    t = T(pw, 
        """
        a
        1
        """
    )
    mid = t.select(v=inc(t.a)).await_futures()
    r = mid.select(w=mid.v * 10)
    assert _rows_plain(pw, r) == [(20,)]


def test_udf_pep604_optional_return_type_coerces(pw):
    @pw.udf
    def f(x: int) -> float | None:
        return x * 2  # int body, PEP-604 optional float annotation

    t = T(pw, 
        """
        a
        3
        """
    )
    ((v,),) = _rows_plain(pw, t.select(v=f(t.a)))
    assert v == 6.0 and isinstance(v, float)


def test_fully_async_udf_return_type_coerces(pw):
    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def g(x: int) -> float:
        return x + 1  # int body, declared float

    t = T(pw, 
        """
        a
        1
        """
    )
    ((v,),) = _rows_plain(pw, t.select(v=g(t.a)).await_futures())
    assert v == 2.0 and isinstance(v, float)


# -- the same update stream through both packages ------------------------------

_STREAM = """
    name | a | b    | __time__ | __diff__
    x    | 1 | 10   | 2        | 1
    y    | 2 | None | 2        | 1
    z    | 3 | 30   | 4        | 1
    x    | 1 | 10   | 6        | -1
    x    | 5 | 50   | 6        | 1
    y    | 2 | None | 8        | -1
"""


def _udf_flows(pw):
    t = pw.debug.table_from_markdown(_STREAM).with_id_from(pw.this.name)

    @pw.udf
    def inc(a: int) -> int:
        return a + 1

    @pw.udf(max_batch_size=2)
    def scaled(a: list[int], b: list) -> list[int]:
        return [x * 100 + (y or 0) for x, y in zip(a, b)]

    @pw.udf(executor=pw.udfs.async_executor(capacity=2))
    async def slow(a: int) -> int:
        await asyncio.sleep(0.001)
        return a * 7

    @pw.udf(cache_strategy=pw.udfs.InMemoryCache(), deterministic=True)
    def cached(a: int) -> str:
        return f"v{a}"

    @pw.udf(propagate_none=True)
    def plus(a: int, b: int) -> int:
        return a + b

    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def later(a: int) -> float:
        await asyncio.sleep(0.001)
        return a / 2

    rowwise = t.select(
        pw.this.name,
        i=inc(pw.this.a),
        s=scaled(pw.this.a, pw.this.b),
        w=slow(pw.this.a),
        c=cached(pw.this.a),
        p=plus(pw.this.a, pw.this.b),
    )
    fully = t.select(pw.this.name, h=later(pw.this.a)).await_futures()
    return {"rowwise": rowwise, "fully_async": fully}


def _norm(v):
    name = type(v).__name__
    if name == "Pointer":
        return ("Pointer", v.value)
    if name == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True, default=str))
    if name == "Error":
        return ("Error",)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_norm(x) for x in v)
    return v


def _stream(pw):
    pw.G.clear()
    try:
        events = []
        for name, table in _udf_flows(pw).items():

            def on_change(key, row, time, is_addition, name=name):
                events.append((name, _norm(key), _norm(row), time, is_addition))

            pw.io.subscribe(table, on_change=on_change)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return events


def test_udf_update_stream_equals_the_jax_package():
    port, jax_side = _stream(tpw), _stream(jpw)
    assert port == jax_side
    adds = [e for e in port if e[0] == "rowwise" and e[4]]
    # x's first version, y (None propagated), z, then x's second version
    assert sorted((e[2]["name"], e[2]["s"], e[2]["p"]) for e in adds) == [
        ("x", 110, 11), ("x", 550, 55), ("y", 200, None), ("z", 330, 33)
    ]
    assert [e[3] for e in port if e[0] == "rowwise"] == sorted(
        e[3] for e in port if e[0] == "rowwise"
    )


# -- the port's device probe ----------------------------------------------------


def test_device_probe_code_imports_torch_and_not_jax():
    from pathway_tpu_torch.internals import device_probe

    tree = ast.parse(device_probe._PROBE_CODE)
    imported = {
        alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
        for alias in node.names
    }
    assert "torch" in imported
    assert not any(m == "jax" or m.startswith("jax.") for m in imported)
    assert "torch.cuda.synchronize" in device_probe._PROBE_CODE
    assert "'cuda'" in device_probe._PROBE_CODE


def test_device_probe_without_cuda_reports_an_error():
    """The probe's subprocess needs a CUDA card; without one it fails and
    the monitor degrades, it never measures the CPU instead."""
    import torch

    from pathway_tpu_torch.internals import device_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the probe would succeed")
    rtt, err = device_probe.device_probe(timeout_s=120.0)
    assert rtt is None and err.startswith("device probe failed")
    monitor = device_probe.DeviceMonitor(probe=device_probe.device_probe)
    last = monitor.probe_once()
    assert last["healthy"] is False and monitor.state == "degraded"
    assert last["rtt_ms"] is None


def test_device_degraded_keeps_its_semantics(monkeypatch):
    """device_degraded() is the hot-path gate the KNN impls read: False
    with no monitor, True while the process monitor holds DEGRADED."""
    from pathway_tpu_torch.internals import device_probe

    monkeypatch.setattr(device_probe, "_monitor", None)
    assert device_probe.device_degraded() is False
    monitor = device_probe.DeviceMonitor(probe=lambda timeout_s: (None, "down"))
    monitor.probe_once()
    monkeypatch.setattr(device_probe, "_monitor", monitor)
    assert device_probe.device_degraded() is True
    monitor.probe = lambda timeout_s: (1.0, None)
    monitor.probe_once()
    assert device_probe.device_degraded() is False and monitor.promotions == 1
