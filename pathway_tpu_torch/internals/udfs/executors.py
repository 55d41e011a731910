"""UDF executors: sync batched / async with capacity+timeout / fully async.

Rebuild of the reference executors (reference:
python/pathway/internals/udfs/executors.py:152,226-237,387).
"""

from __future__ import annotations

import asyncio
import functools
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    FullyAsyncApplyExpression,
)


def _scalar_return_type(ret_type):
    """float/int if the declared return type (possibly Optional) is one."""
    import types
    import typing

    origin = typing.get_origin(ret_type)
    # both Optional[float] and the PEP-604 spelling `float | None`
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(ret_type) if a is not type(None)]
        if len(args) == 1:
            ret_type = args[0]
    return ret_type if ret_type in (float, int) else None


def _coerce_scalar(target, value):
    if target is float and isinstance(value, int):
        # bools included: declared float wins, like pw.cast
        return float(value)
    if target is int and isinstance(value, bool):
        return int(value)
    return value


def _coerce_returns(fun, ret_type, *, is_batch: bool, is_async: bool):
    """Cast returned values to the DECLARED return type (reference:
    test_udf.py test_cast_on_return — a udf annotated/declared float may
    return int and the column is still float-valued)."""
    target = _scalar_return_type(ret_type)
    if target is None:
        return fun
    if is_async:

        @functools.wraps(fun)
        async def awrapper(*args, **kwargs):
            out = await fun(*args, **kwargs)
            return _coerce_scalar(target, out)

        return awrapper

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        out = fun(*args, **kwargs)
        if is_batch and isinstance(out, list):
            return [_coerce_scalar(target, v) for v in out]
        return _coerce_scalar(target, out)

    return wrapper


class Executor:
    def _build_expression(self, udf, fun, args, kwargs) -> ApplyExpression:
        raise NotImplementedError


@dataclass
class SyncExecutor(Executor):
    def _build_expression(self, udf, fun, args, kwargs):
        ret_type = udf._resolve_return_type(fun)
        wrapped = _coerce_returns(
            _apply_cache(udf, fun),
            ret_type,
            is_batch=udf.max_batch_size is not None,
            is_async=False,
        )
        return ApplyExpression(
            wrapped,
            ret_type,
            *args,
            propagate_none=udf.propagate_none,
            deterministic=udf.deterministic,
            max_batch_size=udf.max_batch_size,
            **kwargs,
        )


@dataclass
class AsyncExecutor(Executor):
    capacity: int | None = None
    timeout: float | None = None
    retry_strategy: Any = None

    def _build_expression(self, udf, fun, args, kwargs):
        # ONE wrapping order for both public paths (async_options is the
        # canonical composition; reference semantics: timeout applies to a
        # single retry attempt)
        afun = async_options(
            capacity=self.capacity,
            timeout=self.timeout,
            retry_strategy=self.retry_strategy,
        )(fun)
        afun = _apply_cache(udf, afun, is_async=True)
        ret_type = udf._resolve_return_type(fun)
        afun = _coerce_returns(
            afun, ret_type, is_batch=False, is_async=True
        )
        return ApplyExpression(
            afun,
            ret_type,
            *args,
            propagate_none=udf.propagate_none,
            deterministic=udf.deterministic,
            is_async=True,
            **kwargs,
        )


@dataclass
class FullyAsyncExecutor(Executor):
    capacity: int | None = None
    timeout: float | None = None
    retry_strategy: Any = None
    autocommit_duration_ms: int | None = 100

    def _build_expression(self, udf, fun, args, kwargs):
        from pathway_tpu_torch.internals.udfs import coerce_async

        afun = coerce_async(fun)
        if self.capacity is not None:
            afun = _with_capacity(afun, self.capacity)
        ret_type = udf._resolve_return_type(fun)
        afun = _coerce_returns(
            afun, ret_type, is_batch=False, is_async=True
        )
        expr = FullyAsyncApplyExpression(
            afun,
            ret_type,
            *args,
            propagate_none=udf.propagate_none,
            deterministic=udf.deterministic,
            is_async=True,
            **kwargs,
        )
        expr.autocommit_duration_ms = self.autocommit_duration_ms
        return expr


class AutoExecutor(Executor):
    def _build_expression(self, udf, fun, args, kwargs):
        if asyncio.iscoroutinefunction(fun):
            return AsyncExecutor()._build_expression(udf, fun, args, kwargs)
        return SyncExecutor()._build_expression(udf, fun, args, kwargs)


def auto_executor() -> Executor:
    return AutoExecutor()


def sync_executor() -> Executor:
    return SyncExecutor()


def async_executor(
    *, capacity: int | None = None, timeout: float | None = None, retry_strategy=None
) -> Executor:
    return AsyncExecutor(
        capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
    )


def fully_async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy=None,
    autocommit_duration_ms: int | None = 100,
) -> Executor:
    return FullyAsyncExecutor(
        capacity=capacity,
        timeout=timeout,
        retry_strategy=retry_strategy,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def _with_capacity(afun: Callable, capacity: int) -> Callable:
    semaphores: dict = {}

    @functools.wraps(afun)
    async def wrapper(*args, **kwargs):
        loop = asyncio.get_running_loop()
        sem = semaphores.get(id(loop))
        if sem is None:
            sem = asyncio.Semaphore(capacity)
            semaphores[id(loop)] = sem
        async with sem:
            return await afun(*args, **kwargs)

    return wrapper


def _with_timeout(afun: Callable, timeout: float) -> Callable:
    @functools.wraps(afun)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(afun(*args, **kwargs), timeout)

    return wrapper


with_capacity = _with_capacity
with_timeout = _with_timeout


def _apply_cache(udf, fun: Callable, is_async: bool = False) -> Callable:
    if udf.cache_strategy is None:
        return fun
    from pathway_tpu_torch.internals.udfs.caches import with_cache_strategy

    return with_cache_strategy(fun, udf.cache_strategy, is_async=is_async)


def async_options(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy=None,
    cache_strategy=None,
) -> Callable:
    """Decorator applying async options to a function (reference:
    internals/udfs/executors.py async_options:387): the function is
    coerced to a coroutine and wrapped with timeout / retry / capacity /
    cache in the reference's order."""
    from pathway_tpu_torch.internals.udfs import coerce_async

    def decorator(f: Callable) -> Callable:
        func = coerce_async(f)
        if timeout is not None:
            func = _with_timeout(func, timeout)
        if retry_strategy is not None:
            from pathway_tpu_torch.internals.udfs.retries import (
                with_retry_strategy,
            )

            func = with_retry_strategy(func, retry_strategy)
        if capacity is not None:
            func = _with_capacity(func, capacity)
        if cache_strategy is not None:
            from pathway_tpu_torch.internals.udfs.caches import (
                with_cache_strategy,
            )

            func = with_cache_strategy(func, cache_strategy, is_async=True)
        return func

    return decorator
