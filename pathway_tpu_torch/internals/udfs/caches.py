"""UDF result caches (reference: python/pathway/internals/udfs/caches.py).

DiskCache uses a simple sqlite-free file store (the reference depends on
`diskcache`, which is intentionally not required here).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import os
import pickle
from typing import Any, Callable


class CacheStrategy:
    def get(self, key: str, default=None):
        raise NotImplementedError

    def put(self, key: str, value) -> None:
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    """Per-run in-memory cache (reference: caches.py InMemoryCache)."""

    def __init__(self):
        self._data: dict = {}

    def get(self, key, default=None):
        return self._data.get(key, default)

    def put(self, key, value) -> None:
        self._data[key] = value


class DiskCache(CacheStrategy):
    """Persistent file-backed cache (reference: caches.py DefaultCache →
    diskcache). Stored under PATHWAY_PERSISTENT_STORAGE or ./Cache."""

    def __init__(self, name: str | None = None, size_limit: int | None = None):
        root = os.environ.get("PATHWAY_PERSISTENT_STORAGE", "./Cache")
        self._dir = os.path.join(root, "udf_cache", name or "default")
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self._dir, digest)

    def get(self, key, default=None):
        path = self._path(key)
        if not os.path.exists(path):
            return default
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:  # noqa: BLE001
            return default

    def put(self, key, value) -> None:
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)


DefaultCache = DiskCache

_MISSING = object()


def _cache_key(fun: Callable, args, kwargs) -> str:
    name = getattr(fun, "__qualname__", repr(fun))
    try:
        payload = pickle.dumps((args, kwargs))
    except Exception:  # noqa: BLE001
        payload = repr((args, kwargs)).encode()
    return name + ":" + hashlib.sha256(payload).hexdigest()


def with_cache_strategy(
    fun: Callable, cache: CacheStrategy, *, is_async: bool = False
) -> Callable:
    if is_async:

        @functools.wraps(fun)
        async def async_wrapper(*args, **kwargs):
            key = _cache_key(fun, args, kwargs)
            hit = cache.get(key, _MISSING)
            if hit is not _MISSING:
                return hit
            result = await fun(*args, **kwargs)
            cache.put(key, result)
            return result

        return async_wrapper

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        key = _cache_key(fun, args, kwargs)
        hit = cache.get(key, _MISSING)
        if hit is not _MISSING:
            return hit
        result = fun(*args, **kwargs)
        cache.put(key, result)
        return result

    return wrapper
