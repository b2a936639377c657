"""RSetMultimap / RListMultimap (reference: `RedissonSetMultimap.java`,
`RedissonListMultimap.java`, `RedissonListMultimapValues.java` 714 LoC —
key -> sub-collection of values)."""

from __future__ import annotations

from typing import Any, Iterable, List, Tuple

from redisson_tpu_torch.models.expirable import RExpirable


class _RMultimap(RExpirable):
    _IS_LIST = False

    def _p(self, **kw) -> dict:
        kw["list"] = self._IS_LIST
        return kw

    def _ek(self, k: Any) -> bytes:
        return self._codec.encode(k)

    def _ev(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    def put(self, key: Any, value: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "mm_put", self._p(key=self._ek(key), value=self._ev(value))
        )

    def put_all(self, key: Any, values: Iterable[Any]) -> bool:
        changed = False
        for v in values:
            changed |= self.put(key, v)
        return changed

    def get_all(self, key: Any) -> List[Any]:
        raw = self._executor.execute_sync(self.name, "mm_get_all", self._p(key=self._ek(key)))
        return [self._d(v) for v in raw]

    def remove(self, key: Any, value: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "mm_remove", self._p(key=self._ek(key), value=self._ev(value))
        )

    def remove_all(self, key: Any) -> List[Any]:
        raw = self._executor.execute_sync(self.name, "mm_remove_all", self._p(key=self._ek(key)))
        return [self._d(v) for v in raw]

    def key_set(self) -> List[Any]:
        return [self._d(k) for k in self._executor.execute_sync(self.name, "mm_keys", self._p())]

    def key_size(self) -> int:
        return self._executor.execute_sync(self.name, "mm_key_size", self._p())

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "mm_size", self._p())

    def contains_key(self, key: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "mm_contains_key", self._p(key=self._ek(key))
        )

    def contains_value(self, value: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "mm_contains_value", self._p(value=self._ev(value))
        )

    def contains_entry(self, key: Any, value: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "mm_contains_entry", self._p(key=self._ek(key), value=self._ev(value))
        )

    def entries(self) -> List[Tuple[Any, Any]]:
        raw = self._executor.execute_sync(self.name, "mm_entries", self._p())
        return [(self._d(k), self._d(v)) for k, v in raw]

    def delete(self) -> bool:
        """Delete the multimap including its sub-collections and TTL state
        (the reference's multimap deleteAsync Lua — a bare DEL of the index
        would orphan subkeys and the timeout zset in redis mode)."""
        return self._executor.execute_sync(self.name, "mm_delete", self._p())

    # -- reference RMultimap surface completers -----------------------------

    def get(self, key: Any) -> List[Any]:
        """Reference get(): the values of one key (the java live-view
        semantics collapse to a read here; mutate via put/remove)."""
        return self.get_all(key)

    def is_empty(self) -> bool:
        return self.key_size() == 0

    def clear(self) -> bool:
        """Remove every entry (reference clear(): the Map contract's wipe)."""
        return self.delete()

    def values(self) -> List[Any]:
        """Every value across all keys (reference values() view, read
        form)."""
        return [v for _, v in self.entries()]

    def fast_remove(self, *keys: Any) -> int:
        """Remove whole keys; returns how many existed (reference
        fastRemove)."""
        n = 0
        for k in keys:
            if self.contains_key(k):
                self.remove_all(k)
                n += 1
        return n

    def replace_values(self, key: Any, values: Iterable[Any]) -> List[Any]:
        """Swap a key's collection; returns the previous values (reference
        replaceValues)."""
        old = self.remove_all(key)
        self.put_all(key, values)
        return old


class RSetMultimap(_RMultimap):
    """Values per key form a set (duplicate entries collapse)."""

    _IS_LIST = False

    def get_all(self, key: Any):  # set semantics on read
        return set(super().get_all(key))


class RListMultimap(_RMultimap):
    """Values per key form a list (duplicates and order preserved)."""

    _IS_LIST = True


class _RMultimapCache(_RMultimap):
    """Multimap with per-key TTL (reference `RedissonSetMultimapCache.java`
    / `RedissonListMultimapCache.java` over `RedissonMultimapCache.java`'s
    timeout zset; here: engine mm_expiry / redis `{name}:mmttl` zset).

    The cache flag in every payload tells the redis tier to run its lazy
    TTL purge — plain multimaps never pay that round trip."""

    def _p(self, **kw) -> dict:
        kw = super()._p(**kw)
        kw["cache"] = True
        return kw

    def expire_key(self, key: Any, ttl_s: float) -> bool:
        """Per-key TTL; True only when the key currently exists. ttl <= 0
        clears a previously set TTL (expireKeyAsync contract). A strictly
        positive sub-millisecond ttl rounds up to 1 ms — truncating to 0
        would silently flip "expire almost now" into "never expire"."""
        ttl_ms = int(ttl_s * 1000)
        if ttl_s > 0 and ttl_ms == 0:
            ttl_ms = 1
        return self._executor.execute_sync(
            self.name, "mm_expire_key", self._p(key=self._ek(key), ttl_ms=ttl_ms),
        )


class RSetMultimapCache(_RMultimapCache, RSetMultimap):
    _IS_LIST = False


class RListMultimapCache(_RMultimapCache, RListMultimap):
    _IS_LIST = True
