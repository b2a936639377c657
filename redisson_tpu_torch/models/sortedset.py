"""RSortedSet — comparator-ordered set over the list type.

Reference: `RedissonSortedSet.java` (485 LoC) keeps values in a Redis list
in sorted order, doing a client-driven binary search and a Lua insert at the
found index. Same design here: binary search via `lindex` reads, insert via
the atomic `linsert_at` op. The comparator is client-side (a python key
function), exactly as the reference's java Comparator is.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from redisson_tpu_torch.models.expirable import RExpirable


class RSortedSet(RExpirable):
    def __init__(
        self,
        name,
        executor,
        codec,
        key_width_buckets=(16, 32, 64, 128, 256),
        key: Optional[Callable] = None,
        guard_lock=None,
    ):
        super().__init__(name, executor, codec, key_width_buckets)
        self._key = key if key is not None else lambda v: v
        # The bisect+insert sequence spans multiple ops; the reference keeps
        # the same invariant with a lock around its comparator insert
        # (RedissonSortedSet.java "lock" field). guard_lock is that lock.
        self._guard = guard_lock

    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    def _bisect(self, value: Any) -> tuple:
        """Binary search over remote lindex reads -> (index, found)."""
        k = self._key(value)
        lo, hi = 0, self.size()
        found = False
        while lo < hi:
            mid = (lo + hi) // 2
            mv = self._d(self._executor.execute_sync(self.name, "lindex", {"index": mid}))
            mk = self._key(mv)
            if mk < k:
                lo = mid + 1
            else:
                if mk == k and mv == value:
                    found = True
                hi = mid
        return lo, found

    def add(self, value: Any) -> bool:
        if self._guard is None:
            return self._add_unlocked(value)
        with self._guard:
            return self._add_unlocked(value)

    def _add_unlocked(self, value: Any) -> bool:
        idx, found = self._bisect(value)
        if found:
            return False
        # Scan forward over the equal-key run to confirm absence (duplicate
        # values with equal keys sit adjacent).
        k = self._key(value)
        i = idx
        while True:
            mv = self._d(self._executor.execute_sync(self.name, "lindex", {"index": i}))
            if mv is None or self._key(mv) != k:
                break
            if mv == value:
                return False
            i += 1
        self._executor.execute_sync(
            self.name, "linsert_at", {"index": idx, "value": self._e(value)}
        )
        return True

    def add_all(self, values) -> bool:
        changed = False
        for v in values:
            changed |= self.add(v)
        return changed

    def remove(self, value: Any) -> bool:
        return (
            self._executor.execute_sync(self.name, "lrem", {"value": self._e(value), "count": 1})
            > 0
        )

    def contains(self, value: Any) -> bool:
        idx, found = self._bisect(value)
        if found:
            return True
        # adjacency scan over the equal-key run, as in add()
        k = self._key(value)
        while True:
            mv = self._d(self._executor.execute_sync(self.name, "lindex", {"index": idx}))
            if mv is None or self._key(mv) != k:
                return False
            if mv == value:
                return True
            idx += 1

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "llen", None)

    def try_set_comparator(self, key) -> bool:
        """Reference trySetComparator: install a new ordering (a python
        sort key, the comparator's pythonic form); succeeds only while the
        set is empty — re-sorting existing members is what the reference
        also refuses."""
        if self.size() > 0:
            return False
        self._key = key if key is not None else (lambda v: v)
        return True

    def first(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": 0}))

    def last(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": -1}))

    def read_all(self) -> List[Any]:
        raw = self._executor.execute_sync(self.name, "lrange", {"start": 0, "stop": -1})
        return [self._d(v) for v in raw]

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Any]:
        return iter(self.read_all())

    def __contains__(self, value: Any) -> bool:
        return self.contains(value)
