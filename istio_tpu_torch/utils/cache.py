"""Expiring caches (role of reference pkg/cache/{lruCache,ttlCache}.go)."""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Bounded LRU cache, thread-safe. Tracks hit/miss stats like the
    reference's cache.Stats."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return default

    def set(self, key: Hashable, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            if len(self._data) > self._capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def remove(self, key: Hashable) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


class TTLCache:
    """Cache whose entries expire after a fixed TTL; expired entries are
    dropped lazily on access and by an optional sweep."""

    def __init__(self, ttl_seconds: float, capacity: int = 0,
                 clock: Any = time.monotonic):
        self._ttl = ttl_seconds
        self._capacity = capacity  # 0 = unbounded
        self._clock = clock
        self._data: OrderedDict[Hashable, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        now = self._clock()
        with self._lock:
            item = self._data.get(key)
            if item is None or item[0] < now:
                if item is not None:
                    del self._data[key]
                self.misses += 1
                return default
            self.hits += 1
            return item[1]

    def set(self, key: Hashable, value: Any, ttl: float | None = None) -> None:
        exp = self._clock() + (ttl if ttl is not None else self._ttl)
        with self._lock:
            self._data[key] = (exp, value)
            self._data.move_to_end(key)
            if self._capacity and len(self._data) > self._capacity:
                self._data.popitem(last=False)

    def sweep(self) -> int:
        now = self._clock()
        with self._lock:
            dead = [k for k, (exp, _) in self._data.items() if exp < now]
            for k in dead:
                del self._data[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
