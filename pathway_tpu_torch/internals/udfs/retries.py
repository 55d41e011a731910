"""Async retry strategies (reference:
python/pathway/internals/udfs/retries.py)."""

from __future__ import annotations

import asyncio
import functools
import random
from typing import Callable


class AsyncRetryStrategy:
    async def invoke(self, fun: Callable, /, *args, **kwargs):
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fun, /, *args, **kwargs):
        return await fun(*args, **kwargs)


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    """Retry with exponential backoff + jitter (reference: retries.py)."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000

    async def invoke(self, fun, /, *args, **kwargs):
        delay = self.initial_delay
        for attempt in range(self.max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except Exception:  # noqa: BLE001
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + random.random() * self.jitter)
                delay *= self.backoff_factor
        raise RuntimeError("unreachable")


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(
            max_retries=max_retries,
            initial_delay=delay_ms,
            backoff_factor=1,
            jitter_ms=0,
        )


def with_retry_strategy(fun: Callable, strategy: AsyncRetryStrategy) -> Callable:
    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await strategy.invoke(fun, *args, **kwargs)

    return wrapper
