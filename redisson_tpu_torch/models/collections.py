"""RSet and RList (reference: `RedissonSet.java`, `RedissonList.java` 595
LoC; set algebra rides server-side SINTER/SUNION/SDIFF + *STORE — the
reference's ×100 path, `CHANGELOG.md:53`)."""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List

from redisson_tpu_torch.models.expirable import RExpirable
from redisson_tpu_torch.models.object import map_future


class RSet(RExpirable):
    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes) -> Any:
        return self._codec.decode(raw)

    def add(self, value: Any) -> bool:
        return self.add_async(value).result()

    def add_async(self, value: Any):
        f = self._executor.execute_async(self.name, "sadd", {"members": [self._e(value)]})
        return map_future(f, lambda n: n > 0)

    def add_all(self, values: Iterable[Any]) -> bool:
        members = [self._e(v) for v in values]
        if not members:
            return False
        return self._executor.execute_sync(self.name, "sadd", {"members": members}) > 0

    def remove(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "srem", {"members": [self._e(value)]}) > 0

    def remove_all(self, values: Iterable[Any]) -> bool:
        members = [self._e(v) for v in values]
        if not members:
            return False
        return self._executor.execute_sync(self.name, "srem", {"members": members}) > 0

    def retain_all(self, values: Iterable[Any]) -> bool:
        members = [self._e(v) for v in values]
        return self._executor.execute_sync(self.name, "sretain", {"members": members})

    def contains(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "sismember", {"member": self._e(value)})

    def contains_all(self, values: Iterable[Any]) -> bool:
        mine = self._executor.execute_sync(self.name, "smembers", None)
        return all(self._e(v) in mine for v in values)

    def read_all(self) -> set:
        return {self._d(m) for m in self._executor.execute_sync(self.name, "smembers", None)}

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "scard", None)

    def random(self, count: int = 1) -> List[Any]:
        return [
            self._d(m)
            for m in self._executor.execute_sync(self.name, "srandmember", {"count": count})
        ]

    def remove_random(self, count: int = None):
        """removeRandom() -> one element or None (SPOP single,
        RedissonSet.java:138-145); removeRandom(count) -> list."""
        out = [self._d(m) for m in self._executor.execute_sync(
            self.name, "spop", {"count": 1 if count is None else count})]
        if count is None:
            return out[0] if out else None
        return out

    def move(self, destination: str, member: Any) -> bool:
        return self._executor.execute_sync(
            self.name, "smove", {"dst": destination, "member": self._e(member)}
        )

    # set algebra against other named sets (server-side in the reference)

    def read_intersection(self, *names: str) -> set:
        return {
            self._d(m)
            for m in self._executor.execute_sync(self.name, "sinter", {"names": list(names)})
        }

    def read_union(self, *names: str) -> set:
        return {
            self._d(m)
            for m in self._executor.execute_sync(self.name, "sunion", {"names": list(names)})
        }

    def read_diff(self, *names: str) -> set:
        return {
            self._d(m)
            for m in self._executor.execute_sync(self.name, "sdiff", {"names": list(names)})
        }

    def intersection(self, *names: str) -> int:
        """SINTERSTORE this <- inter(names): the destination is OVERWRITTEN
        with the named sets' result, not included as a source
        (RedissonSet.java:296-303; conformance vs
        RedissonSetTest.java:363-379 pinned this — the old behavior mixed
        this set's own members in)."""
        return self._executor.execute_sync(
            self.name, "sstore", {"op": "inter", "names": self._store_names(names)}
        )

    @staticmethod
    def _store_names(names) -> list:
        """The store ops need >=1 source (redis arity); with zero names the
        engine tier would compute an empty result and WIPE the destination
        while the redis tier errors — fail loudly and identically instead."""
        if not names:
            raise ValueError("at least one source set name is required")
        return list(names)

    def union(self, *names: str) -> int:
        """SUNIONSTORE this <- union(names) (RedissonSet.java:244-251)."""
        return self._executor.execute_sync(
            self.name, "sstore", {"op": "union", "names": self._store_names(names)}
        )

    def diff(self, *names: str) -> int:
        """SDIFFSTORE this <- diff(names) (RedissonSet.java:270-277)."""
        return self._executor.execute_sync(
            self.name, "sstore", {"op": "diff", "names": self._store_names(names)}
        )

    def iterator(self, count: int = 10) -> Iterator[Any]:
        cursor = 0
        while True:
            cursor, chunk = self._executor.execute_sync(
                self.name, "sscan", {"cursor": cursor, "count": count}
            )
            for m in chunk:
                yield self._d(m)
            if cursor == 0:
                return

    def __contains__(self, value: Any) -> bool:
        return self.contains(value)

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Any]:
        return self.iterator()


class RList(RExpirable):
    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    def add(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "rpush", {"values": [self._e(value)]}) > 0

    def add_async(self, value: Any):
        f = self._executor.execute_async(self.name, "rpush", {"values": [self._e(value)]})
        return map_future(f, lambda n: n > 0)

    def add_all(self, values: Iterable[Any]) -> bool:
        vals = [self._e(v) for v in values]
        if not vals:
            return False
        return self._executor.execute_sync(self.name, "rpush", {"values": vals}) > 0

    def insert(self, index: int, value: Any) -> None:
        self._executor.execute_sync(
            self.name, "linsert_at", {"index": index, "value": self._e(value)}
        )

    def get(self, index: int) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": index}))

    def set(self, index: int, value: Any) -> Any:
        """Set and return the previous element (LSET via one atomic op)."""
        return self._d(
            self._executor.execute_sync(
                self.name, "lset", {"index": index, "value": self._e(value)}
            )
        )

    def remove(self, value: Any, count: int = 1) -> bool:
        return (
            self._executor.execute_sync(
                self.name, "lrem", {"value": self._e(value), "count": count}
            )
            > 0
        )

    def remove_at(self, index: int) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lrem_index", {"index": index}))

    def index_of(self, value: Any) -> int:
        return self._executor.execute_sync(self.name, "lindexof", {"value": self._e(value)})

    def last_index_of(self, value: Any) -> int:
        return self._executor.execute_sync(
            self.name, "lindexof", {"value": self._e(value), "last": True}
        )

    def contains(self, value: Any) -> bool:
        return self.index_of(value) >= 0

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "llen", None)

    def read_all(self) -> List[Any]:
        return self.range(0, -1)

    def range(self, start: int, stop: int) -> List[Any]:
        raw = self._executor.execute_sync(self.name, "lrange", {"start": start, "stop": stop})
        return [self._d(v) for v in raw]

    def trim(self, start: int, stop: int) -> None:
        self._executor.execute_sync(self.name, "ltrim", {"start": start, "stop": stop})

    def fast_set(self, index: int, value: Any) -> None:
        self._executor.execute_sync(self.name, "lset", {"index": index, "value": self._e(value)})

    def add_after(self, element: Any, value: Any) -> int:
        """LINSERT AFTER pivot (reference addAfter); new length, -1 if the
        pivot is absent."""
        return self._executor.execute_sync(
            self.name, "linsert",
            {"pivot": self._e(element), "value": self._e(value),
             "before": False})

    def add_before(self, element: Any, value: Any) -> int:
        """LINSERT BEFORE pivot (reference addBefore)."""
        return self._executor.execute_sync(
            self.name, "linsert",
            {"pivot": self._e(element), "value": self._e(value),
             "before": True})

    def sub_list(self, from_index: int, to_index: int) -> List[Any]:
        """Reference subList(from, to) — a read of the half-open index
        window (the java live-view semantics collapse to a read here)."""
        if to_index <= from_index:
            return []
        return self.range(from_index, to_index - 1)

    def remove_all(self, values: Iterable[Any]) -> bool:
        """Reference List.removeAll (RedissonList.java over LREM): remove
        every occurrence of each value; True iff the list changed."""
        removed = 0
        for v in dict.fromkeys(self._e(x) for x in values):
            removed += self._executor.execute_sync(
                self.name, "lrem", {"value": v, "count": 0})
        return removed > 0

    def retain_all(self, values: Iterable[Any]) -> bool:
        """Reference List.retainAll: keep only listed values (order and
        duplicates of the kept elements preserved); True iff changed. One
        atomic server/engine-side op — expiry preserved."""
        return self._executor.execute_sync(
            self.name, "lretain", {"members": [self._e(x) for x in values]})

    def add_all_at(self, index: int, values: Iterable[Any]) -> bool:
        """Reference addAll(index, values): one atomic splice at `index`
        (lsplice, mirroring lretain — the old linsert_at loop let other
        writers interleave mid-splice); errors when index exceeds the
        current size (RedissonListTest.java:715-719 expects an error on
        an empty list at index 2)."""
        vals = [self._e(v) for v in values]
        if not vals:
            return False
        return self._executor.execute_sync(
            self.name, "lsplice", {"index": index, "values": vals})

    def is_empty(self) -> bool:
        return self.size() == 0

    def fast_remove(self, *indexes: int) -> None:
        """Remove elements by index without returning them (reference
        fastRemove). Descending order keeps lower indexes stable."""
        for i in sorted(indexes, reverse=True):
            self._executor.execute_sync(self.name, "lrem_index", {"index": i})

    def __getitem__(self, index: int) -> Any:
        v = self.get(index)
        if v is None:
            raise IndexError(index)
        return v

    def __setitem__(self, index: int, value: Any) -> None:
        self.fast_set(index, value)

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Any]:
        return iter(self.read_all())
