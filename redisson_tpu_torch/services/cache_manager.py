"""Cache manager — the RedissonSpringCacheManager analogue (counterpart of
`redisson_tpu.services.cache_manager`).

Reference (spring/cache/, SURVEY.md §2 L4/L5): maps cache name -> RMap or
RMapCache, with per-cache TTL / max-idle taken from a JSON-loadable
CacheConfig. Without Spring, the manager is a plain registry + a
`@cached` decorator standing in for @Cacheable.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


_MISS = object()


@dataclass
class CacheConfig:
    """Per-cache policy (reference spring/cache/CacheConfig.java)."""

    ttl_s: Optional[float] = None       # 0/None = eternal
    max_idle_s: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CacheConfig":
        return cls(ttl_s=d.get("ttl_s"), max_idle_s=d.get("max_idle_s"))


class Cache:
    """One named cache over RMapCache (or RMap when no policy is set)."""

    def __init__(self, name: str, backing, config: CacheConfig):
        self.name = name
        self._map = backing
        self._config = config

    def get(self, key: Any, default: Any = None) -> Any:
        v = self._map.get(key)
        if v is None and not self._map.contains_key(key):
            return default  # absent, vs a legitimately cached None
        return v

    def put(self, key: Any, value: Any) -> None:
        if self._config.ttl_s or self._config.max_idle_s:
            self._map.put(key, value, ttl_s=self._config.ttl_s,
                          max_idle_s=self._config.max_idle_s)
        else:
            self._map.put(key, value)

    def put_if_absent(self, key: Any, value: Any) -> Any:
        if self._config.ttl_s or self._config.max_idle_s:
            return self._map.put_if_absent(
                key, value, ttl_s=self._config.ttl_s,
                max_idle_s=self._config.max_idle_s)
        return self._map.put_if_absent(key, value)

    def evict(self, key: Any) -> None:
        self._map.remove(key)

    def clear(self) -> None:
        self._map.clear()

    def size(self) -> int:
        return self._map.size()


class CacheManager:
    """Registry of named caches with per-name policies.

    configs: {"users": {"ttl_s": 60, "max_idle_s": 30}, ...} — the same
    shape the reference loads from JSON/YAML (CacheConfigSupport).
    """

    def __init__(self, client, configs: Optional[Dict[str, Dict]] = None):
        self._client = client
        self._configs: Dict[str, CacheConfig] = {
            name: CacheConfig.from_dict(c) for name, c in (configs or {}).items()
        }
        self._caches: Dict[str, Cache] = {}

    @classmethod
    def from_json(cls, client, text: str) -> "CacheManager":
        return cls(client, json.loads(text))

    def set_config(self, name: str, config: CacheConfig) -> None:
        self._configs[name] = config

    def get_cache(self, name: str) -> Cache:
        cache = self._caches.get(name)
        if cache is None:
            cfg = self._configs.get(name, CacheConfig())
            # Policy'd caches need the eviction-capable map; plain caches
            # use the cheaper RMap (reference picks RMapCache vs RMap the
            # same way, spring/cache/RedissonSpringCacheManager.java).
            if cfg.ttl_s or cfg.max_idle_s:
                backing = self._client.get_map_cache(f"cache:{name}")
            else:
                backing = self._client.get_map(f"cache:{name}")
            cache = self._caches[name] = Cache(name, backing, cfg)
        return cache

    def cache_names(self):
        return sorted(set(self._configs) | set(self._caches))

    def cached(self, cache_name: str,
               key_fn: Optional[Callable[..., Any]] = None):
        """@Cacheable analogue: memoize a function through a named cache."""

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                cache = self.get_cache(cache_name)
                key = (key_fn(*args, **kwargs) if key_fn
                       else repr((args, tuple(sorted(kwargs.items())))))
                hit = cache.get(key, _MISS)
                if hit is not _MISS:
                    return hit
                value = fn(*args, **kwargs)
                cache.put(key, value)
                return value

            return wrapper

        return deco
