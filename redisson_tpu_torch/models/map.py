"""RMap — distributed hash (reference: `RedissonMap.java`, 570 LoC; hash
commands + Lua for the compound ops; iteration via HSCAN cursor,
`RedissonBaseIterator.java`)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from redisson_tpu_torch.models.expirable import RExpirable
from redisson_tpu_torch.models.object import map_future


class RMap(RExpirable):
    """dict-like distributed map; keys and values go through the codec."""

    def _ek(self, key: Any) -> bytes:
        return self._codec.encode(key)

    def _ev(self, value: Any) -> bytes:
        return self._codec.encode(value)

    def _dk(self, raw: bytes) -> Any:
        return self._codec.decode(raw)

    def _dv(self, raw: Optional[bytes]) -> Any:
        return None if raw is None else self._codec.decode(raw)

    # -- core ---------------------------------------------------------------

    def put(self, key: Any, value: Any) -> Any:
        """Set and return the previous value (HGET+HSET as one atomic op)."""
        return self.put_async(key, value).result()

    def put_async(self, key: Any, value: Any):
        f = self._executor.execute_async(
            self.name, "hput", {"field": self._ek(key), "value": self._ev(value)}
        )
        return map_future(f, self._dv)

    def fast_put(self, key: Any, value: Any) -> bool:
        """HSET reply: True if the field is new (no old-value round trip)."""
        old = self._executor.execute_sync(
            self.name, "hput", {"field": self._ek(key), "value": self._ev(value)}
        )
        return old is None

    def put_if_absent(self, key: Any, value: Any) -> Any:
        return self._dv(
            self._executor.execute_sync(
                self.name, "hput_if_absent", {"field": self._ek(key), "value": self._ev(value)}
            )
        )

    def put_all(self, mapping: Dict[Any, Any]) -> None:
        pairs = {self._ek(k): self._ev(v) for k, v in mapping.items()}
        self._executor.execute_sync(self.name, "hputall", {"pairs": pairs})

    def get(self, key: Any) -> Any:
        return self.get_async(key).result()

    def get_async(self, key: Any):
        f = self._executor.execute_async(self.name, "hget", {"field": self._ek(key)})
        return map_future(f, self._dv)

    def get_all(self, keys: Iterable[Any]) -> Dict[Any, Any]:
        fields = [self._ek(k) for k in keys]
        raw = self._executor.execute_sync(self.name, "hmget", {"fields": fields})
        return {self._dk(f): self._dv(v) for f, v in raw.items()}

    def read_all_map(self) -> Dict[Any, Any]:
        raw = self._executor.execute_sync(self.name, "hgetall", None)
        return {self._dk(f): self._dv(v) for f, v in raw.items()}

    def remove(self, key: Any, value: Any = None) -> Any:
        """remove(k) -> old value; remove(k, v) -> bool (java Map contract)."""
        if value is None:
            return self._dv(
                self._executor.execute_sync(self.name, "hremove", {"field": self._ek(key)})
            )
        return self._executor.execute_sync(
            self.name, "hremove_if", {"field": self._ek(key), "value": self._ev(value)}
        )

    def fast_remove(self, *keys: Any) -> int:
        return self._executor.execute_sync(
            self.name, "hdel", {"fields": [self._ek(k) for k in keys]}
        )

    def replace(self, key: Any, *args: Any) -> Any:
        """replace(k, v) -> old; replace(k, old, new) -> bool."""
        if len(args) == 1:
            return self._dv(
                self._executor.execute_sync(
                    self.name, "hreplace", {"field": self._ek(key), "value": self._ev(args[0])}
                )
            )
        old, new = args
        return self._executor.execute_sync(
            self.name,
            "hreplace_if",
            {"field": self._ek(key), "old": self._ev(old), "new": self._ev(new)},
        )

    def contains_key(self, key: Any) -> bool:
        return self._executor.execute_sync(self.name, "hcontains_key", {"field": self._ek(key)})

    def contains_value(self, value: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "hcontains_value", {"value": self._ev(value)}
        )

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "hlen", None)

    def clear(self) -> bool:
        """java.util.Map.clear — drop every entry (DEL of the hash)."""
        return self.delete()

    def key_set(self) -> List[Any]:
        return [self._dk(f) for f in self._executor.execute_sync(self.name, "hkeys", None)]

    def values(self) -> List[Any]:
        return [self._dv(v) for v in self._executor.execute_sync(self.name, "hvals", None)]

    def entry_set(self) -> List[Tuple[Any, Any]]:
        raw = self._executor.execute_sync(self.name, "hgetall", None)
        return [(self._dk(f), self._dv(v)) for f, v in raw.items()]

    def add_and_get(self, key: Any, delta) -> Any:
        """Numeric field increment (HINCRBY/HINCRBYFLOAT)."""
        as_float = isinstance(delta, float)
        val = self._executor.execute_sync(
            self.name,
            "hincr",
            {"field": self._ek(key), "by": delta, "float": as_float},
        )
        return val

    def fast_put_if_absent(self, key: Any, value: Any) -> bool:
        """HSETNX reply only (reference fastPutIfAbsent: True when the
        field was absent and got set). Checks the RAW reply — a stored
        null/None value must read as "present" (same rule fast_put
        follows)."""
        raw = self._executor.execute_sync(
            self.name, "hput_if_absent",
            {"field": self._ek(key), "value": self._ev(value)})
        return raw is None

    # -- bulk reads (reference readAllKeySet/readAllValues/readAllEntrySet) --

    def read_all_key_set(self) -> set:
        return set(self.key_set())

    def read_all_values(self) -> List[Any]:
        return self.values()

    def read_all_entry_set(self) -> List[Tuple[Any, Any]]:
        return self.entry_set()

    # -- predicate filters (reference filterKeys/filterValues/filterEntries,
    # core/Predicate.java): the reference serializes the predicate and runs
    # it server-side; pythonic form takes a callable and streams the HSCAN
    # cursor through it client-side (same result set, no code shipping) ----

    def filter_keys(self, predicate) -> Dict[Any, Any]:
        return {k: v for k, v in self.iter_entries() if predicate(k)}

    def filter_values(self, predicate) -> Dict[Any, Any]:
        return {k: v for k, v in self.iter_entries() if predicate(v)}

    def filter_entries(self, predicate) -> Dict[Any, Any]:
        return {k: v for k, v in self.iter_entries() if predicate(k, v)}

    # -- iteration (HSCAN cursor protocol) ----------------------------------

    def iter_entries(self, count: int = 10) -> Iterator[Tuple[Any, Any]]:
        cursor = 0
        while True:
            cursor, chunk = self._executor.execute_sync(
                self.name, "hscan", {"cursor": cursor, "count": count}
            )
            for f, v in chunk:
                yield self._dk(f), self._dv(v)
            if cursor == 0:
                return

    # reference entryIterator/keyIterator/valueIterator
    def entry_iterator(self, count: int = 10) -> Iterator[Tuple[Any, Any]]:
        return self.iter_entries(count)

    def key_iterator(self, count: int = 10) -> Iterator[Any]:
        return (k for k, _ in self.iter_entries(count))

    def value_iterator(self, count: int = 10) -> Iterator[Any]:
        return (v for _, v in self.iter_entries(count))

    # -- dict sugar ---------------------------------------------------------

    def __getitem__(self, key: Any) -> Any:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __setitem__(self, key: Any, value: Any) -> None:
        self.fast_put(key, value)

    def __delitem__(self, key: Any) -> None:
        if self.fast_remove(key) == 0:
            raise KeyError(key)

    def __contains__(self, key: Any) -> bool:
        return self.contains_key(key)

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Any]:
        return iter(self.key_set())
