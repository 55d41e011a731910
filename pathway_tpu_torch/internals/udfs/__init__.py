"""UDF system: pw.udf decorator, executors, caching, retries.

Rebuild of the reference UDF stack (reference:
python/pathway/internals/udfs/__init__.py:67 UDF, executors.py, caches.py,
retries.py), copied from pathway_tpu/internals/udfs. Sync UDFs batch up to
`max_batch_size` (column-lists in, column out) so device-backed UDFs see
whole batches; async UDFs run
concurrently within an engine batch under a capacity semaphore.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnExpression
from pathway_tpu_torch.internals.udfs.caches import (
    CacheStrategy,
    DefaultCache,
    DiskCache,
    InMemoryCache,
    with_cache_strategy,
)
from pathway_tpu_torch.internals.udfs.retries import (
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
    with_retry_strategy,
)
from pathway_tpu_torch.internals.udfs.executors import (
    async_options,
    Executor,
    async_executor,
    auto_executor,
    fully_async_executor,
    sync_executor,
    with_capacity,
    with_timeout,
)

__all__ = [
    "async_options",
    "UDF",
    "udf",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "InMemoryCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "async_executor",
    "auto_executor",
    "fully_async_executor",
    "sync_executor",
    "with_cache_strategy",
    "with_retry_strategy",
    "with_capacity",
    "with_timeout",
    "coerce_async",
]


def coerce_async(fun: Callable) -> Callable:
    """Wrap a sync callable as async (reference: udfs/utils.py)."""
    if asyncio.iscoroutinefunction(fun):
        return fun

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return fun(*args, **kwargs)

    return wrapper


class UDF:
    """User-defined function usable in expressions (reference: UDF:67).

    Subclass and define `__wrapped__`, or use the @pw.udf decorator.
    """

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or auto_executor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        self.func: Callable | None = getattr(self, "__wrapped__", None)

    def _resolve_return_type(self, fun: Callable) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            hints = typing.get_type_hints(fun)
        except Exception:  # noqa: BLE001
            hints = getattr(fun, "__annotations__", {})
        return hints.get("return", Any)

    def __call__(self, *args, **kwargs) -> ColumnExpression:
        fun = self.func
        if fun is None:
            raise TypeError("UDF has no wrapped function")
        return self.executor._build_expression(self, fun, args, kwargs)


class _FunctionUDF(UDF):
    def __init__(self, fun: Callable, **kwargs):
        super().__init__(**kwargs)
        self.func = fun
        functools.update_wrapper(self, fun)


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | str | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
    **kwargs,
):
    """Decorator turning a function into a UDF (reference: pw.udf).

    >>> import pathway_tpu_torch as pw
    >>> @pw.udf
    ... def double(x: int) -> int:
    ...     return 2 * x
    >>> t = pw.debug.table_from_markdown('''
    ... a
    ... 3
    ... ''')
    >>> pw.debug.compute_and_print(
    ...     t.select(d=double(pw.this.a)), include_id=False
    ... )
    d
    6
    """
    if isinstance(executor, str):
        executor = {"async": async_executor(), "sync": sync_executor()}[executor]

    def decorate(f: Callable) -> UDF:
        return _FunctionUDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )

    if fun is not None:
        return decorate(fun)
    return decorate
