"""RMapCache / RSetCache — maps/sets with per-entry TTL + maxIdle.

Reference: `RedissonMapCache.java` (811 LoC — per-entry TTL via companion
zsets + ~15 Lua scripts, swept by the EvictionScheduler) and
`RedissonSetCache.java`. The engine keeps the TTL next to the value in one
record (`structures/extended.py` mc_*/sc_* ops); the sweep is the
`mc_evict_expired` op scheduled by redisson_tpu_torch.eviction.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from redisson_tpu_torch.models.expirable import RExpirable
from redisson_tpu_torch.models.object import map_future


class RMapCache(RExpirable):
    def __init__(self, name, executor, codec, key_width_buckets=(16, 32, 64, 128, 256), eviction_scheduler=None):
        super().__init__(name, executor, codec, key_width_buckets)
        self._eviction = eviction_scheduler
        if eviction_scheduler is not None:
            eviction_scheduler.schedule(name)

    def delete(self) -> bool:
        if self._eviction is not None:
            self._eviction.unschedule(self.name)
        return super().delete()

    def _ek(self, k: Any) -> bytes:
        return self._codec.encode(k)

    def _ev(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    def put(
        self,
        key: Any,
        value: Any,
        ttl_s: Optional[float] = None,
        max_idle_s: Optional[float] = None,
    ) -> Any:
        return self.put_async(key, value, ttl_s, max_idle_s).result()

    def put_async(self, key, value, ttl_s=None, max_idle_s=None):
        f = self._executor.execute_async(
            self.name,
            "mc_put",
            {
                "field": self._ek(key),
                "value": self._ev(value),
                "ttl_ms": None if ttl_s is None else int(ttl_s * 1000),
                "max_idle_ms": None if max_idle_s is None else int(max_idle_s * 1000),
            },
        )
        return map_future(f, self._d)

    def put_if_absent(
        self,
        key: Any,
        value: Any,
        ttl_s: Optional[float] = None,
        max_idle_s: Optional[float] = None,
    ) -> Any:
        return self._d(
            self._executor.execute_sync(
                self.name,
                "mc_put",
                {
                    "field": self._ek(key),
                    "value": self._ev(value),
                    "ttl_ms": None if ttl_s is None else int(ttl_s * 1000),
                    "max_idle_ms": None if max_idle_s is None else int(max_idle_s * 1000),
                    "if_absent": True,
                },
            )
        )

    def fast_put(self, key, value, ttl_s=None, max_idle_s=None) -> bool:
        return self.put(key, value, ttl_s, max_idle_s) is None

    def get(self, key: Any) -> Any:
        return self._d(
            self._executor.execute_sync(self.name, "mc_get", {"field": self._ek(key)})
        )

    def remove(self, key: Any) -> Any:
        return self._d(
            self._executor.execute_sync(self.name, "mc_remove", {"field": self._ek(key)})
        )

    def contains_key(self, key: Any) -> bool:
        return self._executor.execute_sync(self.name, "mc_contains", {"field": self._ek(key)})

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "mc_size", None)

    def read_all_map(self) -> Dict[Any, Any]:
        raw = self._executor.execute_sync(self.name, "mc_getall", None)
        return {self._codec.decode(f): self._d(v) for f, v in raw.items()}

    def evict_expired(self, limit: int = 300) -> int:
        """One eviction sweep (what the scheduler runs)."""
        return self._executor.execute_sync(self.name, "mc_evict_expired", {"limit": limit})

    def clear(self) -> bool:
        """java.util.Map.clear — drop every entry (and its TTL metadata).
        Keeps the eviction schedule: the cache object stays live, unlike
        delete()."""
        return super().delete()

    def __len__(self) -> int:
        return self.size()

    def __contains__(self, key: Any) -> bool:
        return self.contains_key(key)

    def __iter__(self):
        return iter(self.read_all_map().keys())


class RSetCache(RExpirable):
    def __init__(self, name, executor, codec, key_width_buckets=(16, 32, 64, 128, 256), eviction_scheduler=None):
        super().__init__(name, executor, codec, key_width_buckets)
        self._eviction = eviction_scheduler
        if eviction_scheduler is not None:
            eviction_scheduler.schedule(name)

    def delete(self) -> bool:
        if self._eviction is not None:
            self._eviction.unschedule(self.name)
        return super().delete()

    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def add(self, value: Any, ttl_s: Optional[float] = None) -> bool:
        return self.add_async(value, ttl_s).result()

    def add_async(self, value: Any, ttl_s: Optional[float] = None):
        return self._executor.execute_async(
            self.name,
            "sc_add",
            {"member": self._e(value), "ttl_ms": None if ttl_s is None else int(ttl_s * 1000)},
        )

    def contains(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "sc_contains", {"member": self._e(value)})

    def remove(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "sc_remove", {"member": self._e(value)})

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "sc_size", None)

    def read_all(self) -> set:
        raw = self._executor.execute_sync(self.name, "sc_members", None)
        return {self._codec.decode(m) for m in raw}

    def evict_expired(self, limit: int = 300) -> int:
        return self._executor.execute_sync(self.name, "mc_evict_expired", {"limit": limit})

    def clear(self) -> bool:
        """Drop every member, keeping the eviction schedule live."""
        return super().delete()

    def __len__(self) -> int:
        return self.size()

    def __contains__(self, value: Any) -> bool:
        return self.contains(value)

    def __iter__(self):
        return iter(self.read_all())
