"""AsyncTransformer — class-based fully-async row transformer.

TPU-native rebuild of the reference machinery (reference:
python/pathway/stdlib/utils/async_transformer.py + the engine protocol in
src/engine/dataflow/async_transformer.rs:1-40 — rows routed out via
subscribe and back via an internal connector with seq-ids, upserts,
Pending placeholders). In this engine, a batch's invocations run
concurrently on one event loop and complete within the batch's engine time —
same results, without the re-entry protocol; Pending values only ever
surface in streaming mode between micro-batches.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional, Type

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.value import ERROR, Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, Schema, schema_from_columns
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


def _run_coro(coro):
    """asyncio.run, but safe when the calling thread already has a running
    loop (notebooks, async servers): falls back to a worker thread."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(lambda: asyncio.run(coro)).result()


class AsyncTransformerNode(Node):
    name = "async_transformer"
    snapshot_attrs = ('emitted',)

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        invoke,  # async callable(**row) -> dict
        input_names,
        output_names,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy=None,
    ):
        super().__init__(engine, [input_])
        self.invoke = invoke
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy
        self.emitted: Dict[Pointer, tuple] = {}

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        out = []
        calls = []
        for key, values, diff in deltas:
            if diff < 0:
                prev = self.emitted.pop(key, None)
                if prev is not None:
                    out.append((key, prev, -1))
                continue
            calls.append((key, dict(zip(self.input_names, values))))
        if calls:
            results = _run_coro(self._run_batch(calls))
            for (key, _kwargs), result in zip(calls, results):
                if isinstance(result, Exception):
                    self.log_error(
                        f"async transformer: {type(result).__name__}: {result}"
                    )
                    row = (*(ERROR for _ in self.output_names), False)
                elif not isinstance(result, dict) or set(result) != set(
                    self.output_names
                ):
                    # keys-only schema validation: extra or missing
                    # columns fail the row (reference:
                    # test_async_transformer.py test_fails_on_too_many_
                    # columns / not_enough_columns). Value DTYPES are not
                    # checked here.
                    got = (
                        sorted(result, key=repr)
                        if isinstance(result, dict)
                        else type(result).__name__
                    )
                    self.log_error(
                        "async transformer: result does not match the "
                        f"output schema: got {got}, "
                        f"expected {sorted(self.output_names)}"
                    )
                    row = (*(ERROR for _ in self.output_names), False)
                else:
                    row = (
                        *(result[n] for n in self.output_names),
                        True,
                    )
                prev = self.emitted.get(key)
                if prev is not None:
                    out.append((key, prev, -1))
                self.emitted[key] = row
                out.append((key, row, 1))
        self.emit(time, out)

    async def _run_batch(self, calls):
        sem = asyncio.Semaphore(self.capacity) if self.capacity else None

        async def one(kwargs):
            try:
                async def call():
                    coro = self.invoke(**kwargs)
                    if self.timeout is not None:
                        return await asyncio.wait_for(coro, self.timeout)
                    return await coro

                if self.retry_strategy is not None:
                    async def wrapped():
                        return await self.retry_strategy.invoke(
                            lambda: call()
                        )

                    if sem:
                        async with sem:
                            return await wrapped()
                    return await wrapped()
                if sem:
                    async with sem:
                        return await call()
                return await call()
            except Exception as exc:  # noqa: BLE001
                return exc

        return await asyncio.gather(*(one(k) for _key, k in calls))


class AsyncTransformer:
    """Subclass with `output_schema` and an async `invoke` (reference:
    stdlib/utils/async_transformer.py AsyncTransformer)::

        class Upper(pw.AsyncTransformer, output_schema=OutSchema):
            async def invoke(self, text: str) -> dict:
                return {"result": text.upper()}

        out = Upper(input_table=t).successful
    """

    output_schema: Type[Schema]

    def __init_subclass__(cls, output_schema: Type[Schema] | None = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(self, input_table: Table, *, instance=None, autocommit_duration_ms: int | None = 1500, **kwargs):
        self._input_table = input_table
        self._capacity: int | None = None
        self._timeout: float | None = None
        self._retry_strategy = None
        self._cache_strategy = None
        self._result: Table | None = None

    async def invoke(self, *args, **kwargs) -> dict:
        raise NotImplementedError

    def open(self) -> None:  # lifecycle hooks kept for parity
        pass

    def close(self) -> None:
        pass

    def with_options(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy=None,
        cache_strategy=None,
    ) -> "AsyncTransformer":
        self._capacity = capacity
        self._timeout = timeout
        self._retry_strategy = retry_strategy
        self._cache_strategy = cache_strategy
        return self

    def _build_result(self) -> Table:
        if self._result is not None:
            return self._result
        input_table = self._input_table
        input_names = input_table.column_names()
        output_names = list(self.output_schema.keys())
        invoke = self.invoke
        if self._cache_strategy is not None:
            from pathway_tpu_torch.internals.udfs.caches import with_cache_strategy

            invoke = with_cache_strategy(
                invoke, self._cache_strategy, is_async=True
            )
        capacity, timeout, retry = (
            self._capacity,
            self._timeout,
            self._retry_strategy,
        )

        def build(ctx):
            return AsyncTransformerNode(
                ctx.engine,
                ctx.node(input_table),
                invoke,
                input_names,
                output_names,
                capacity=capacity,
                timeout=timeout,
                retry_strategy=retry,
            )

        cols = {
            name: ColumnSchema(name=name, dtype=c.dtype)
            for name, c in self.output_schema.columns().items()
        }
        cols["_pw_ok"] = ColumnSchema(name="_pw_ok", dtype=dt.BOOL)
        self._result = Table(
            schema=schema_from_columns(cols),
            universe=input_table._universe.subset(),
            build=build,
        )
        return self._result

    @property
    def successful(self) -> Table:
        t = self._build_result()
        return t.filter(t._pw_ok).without("_pw_ok")

    @property
    def failed(self) -> Table:
        t = self._build_result()
        from pathway_tpu_torch.internals.expression import UnaryOpExpression

        return t.filter(UnaryOpExpression("~", t._pw_ok)).without("_pw_ok")

    @property
    def finished(self) -> Table:
        return self._build_result().without("_pw_ok")

    @property
    def result(self) -> Table:
        return self.successful
