"""RScoredSortedSet / RLexSortedSet (reference: `RedissonScoredSortedSet.java`
500 LoC over ZADD/ZSCORE/ZRANGE/ZRANGEBYSCORE...; `RedissonLexSortedSet`
over the ZLEX family on an all-equal-scores zset)."""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Tuple

from redisson_tpu_torch.models.expirable import RExpirable
from redisson_tpu_torch.models.object import map_future


class RScoredSortedSet(RExpirable):
    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    # -- write --------------------------------------------------------------

    def add(self, score: float, member: Any) -> bool:
        return self.add_async(score, member).result()

    def add_async(self, score: float, member: Any):
        f = self._executor.execute_async(
            self.name, "zadd", {"pairs": [(self._e(member), float(score))]}
        )
        return map_future(f, lambda n: n > 0)

    def add_all(self, scored: Iterable[Tuple[float, Any]]) -> int:
        pairs = [(self._e(m), float(s)) for s, m in scored]
        return self._executor.execute_sync(self.name, "zadd", {"pairs": pairs})

    def try_add(self, score: float, member: Any) -> bool:
        """ZADD NX."""
        return (
            self._executor.execute_sync(
                self.name, "zadd", {"pairs": [(self._e(member), float(score))], "nx": True}
            )
            > 0
        )

    def add_score(self, member: Any, delta: float) -> float:
        return self._executor.execute_sync(
            self.name, "zincrby", {"member": self._e(member), "by": float(delta)}
        )

    def remove(self, member: Any) -> bool:
        return (
            self._executor.execute_sync(self.name, "zrem", {"members": [self._e(member)]}) > 0
        )

    def remove_all(self, members: Iterable[Any]) -> bool:
        ms = [self._e(m) for m in members]
        return bool(ms) and self._executor.execute_sync(self.name, "zrem", {"members": ms}) > 0

    def poll_first(self) -> Any:
        res = self._executor.execute_sync(self.name, "zpop", {})
        return None if res is None else self._d(res[0])

    def poll_last(self) -> Any:
        res = self._executor.execute_sync(self.name, "zpop", {"last": True})
        return None if res is None else self._d(res[0])

    def remove_range_by_score(
        self, min: Optional[float], min_inc: bool, max: Optional[float], max_inc: bool
    ) -> int:
        return self._executor.execute_sync(
            self.name,
            "zremrangebyscore",
            {"min": min, "max": max, "min_inc": min_inc, "max_inc": max_inc},
        )

    def remove_range_by_rank(self, start: int, stop: int) -> int:
        return self._executor.execute_sync(
            self.name, "zremrangebyrank", {"start": start, "stop": stop}
        )

    # -- read ---------------------------------------------------------------

    def get_score(self, member: Any) -> Optional[float]:
        return self._executor.execute_sync(self.name, "zscore", {"member": self._e(member)})

    def contains(self, member: Any) -> bool:
        return self.get_score(member) is not None

    def rank(self, member: Any) -> Optional[int]:
        return self._executor.execute_sync(self.name, "zrank", {"member": self._e(member)})

    def rev_rank(self, member: Any) -> Optional[int]:
        return self._executor.execute_sync(
            self.name, "zrank", {"member": self._e(member), "rev": True}
        )

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "zcard", None)

    def count(
        self,
        min: Optional[float] = None,
        min_inc: bool = True,
        max: Optional[float] = None,
        max_inc: bool = True,
    ) -> int:
        return self._executor.execute_sync(
            self.name, "zcount", {"min": min, "max": max, "min_inc": min_inc, "max_inc": max_inc}
        )

    def value_range(self, start: int, stop: int, reversed: bool = False) -> List[Any]:
        raw = self._executor.execute_sync(
            self.name, "zrange", {"start": start, "stop": stop, "rev": reversed}
        )
        return [self._d(m) for m in raw]

    def entry_range(self, start: int, stop: int, reversed: bool = False) -> List[Tuple[Any, float]]:
        raw = self._executor.execute_sync(
            self.name,
            "zrange",
            {"start": start, "stop": stop, "rev": reversed, "withscores": True},
        )
        return [(self._d(m), s) for m, s in raw]

    def value_range_by_score(
        self,
        min: Optional[float],
        min_inc: bool,
        max: Optional[float],
        max_inc: bool,
        offset: int = 0,
        count: Optional[int] = None,
        reversed: bool = False,
    ) -> List[Any]:
        raw = self._executor.execute_sync(
            self.name,
            "zrangebyscore",
            {
                "min": min,
                "max": max,
                "min_inc": min_inc,
                "max_inc": max_inc,
                "offset": offset,
                "count": count,
                "rev": reversed,
            },
        )
        return [self._d(m) for m in raw]

    def read_all(self) -> List[Any]:
        return self.value_range(0, -1)

    def first(self) -> Any:
        vals = self.value_range(0, 0)
        return vals[0] if vals else None

    def last(self) -> Any:
        vals = self.value_range(-1, -1)
        return vals[0] if vals else None

    # -- reference surface completers (RScoredSortedSet.java) ---------------

    def is_empty(self) -> bool:
        return self.size() == 0

    def to_array(self) -> List[Any]:
        return self.read_all()

    def contains_all(self, members: Iterable[Any]) -> bool:
        ms = [self._e(m) for m in members]
        if not ms:
            return True
        scores = self._executor.execute_sync(
            self.name, "zmscore", {"members": ms})
        return all(s is not None for s in scores)

    def retain_all(self, members: Iterable[Any]) -> bool:
        """Keep only `members`; True if anything was removed (reference
        retainAll)."""
        keep = {self._e(m) for m in members}
        drop = [m for m in self.read_all() if self._e(m) not in keep]
        if not drop:
            return False
        self.remove_all(drop)
        return True

    def clear(self) -> bool:
        """Remove every member (java Collection clear)."""
        return self.remove_range_by_rank(0, -1) > 0

    def value_range_reversed(self, start: int, stop: int) -> List[Any]:
        """Reference valueRangeReversed (ZREVRANGE by index)."""
        return self.value_range(start, stop, reversed=True)

    def entry_range_reversed(self, start: int, stop: int) -> List[Tuple[Any, float]]:
        return self.entry_range(start, stop, reversed=True)

    # -- multi-set ops (ZUNIONSTORE/ZINTERSTORE) ----------------------------

    def union(self, *names: str) -> int:
        return self._executor.execute_sync(
            self.name, "zstore", {"op": "union", "names": [self.name, *names]}
        )

    def intersection(self, *names: str) -> int:
        return self._executor.execute_sync(
            self.name, "zstore", {"op": "inter", "names": [self.name, *names]}
        )

    def iterator(self, count: int = 10) -> Iterator[Any]:
        cursor = 0
        while True:
            cursor, chunk = self._executor.execute_sync(
                self.name, "zscan", {"cursor": cursor, "count": count}
            )
            for m, _ in chunk:
                yield self._d(m)
            if cursor == 0:
                return

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Any]:
        return self.iterator()

    def __contains__(self, member: Any) -> bool:
        return self.contains(member)


class RLexSortedSet(RExpirable):
    """Lexicographic string set: a zset with all scores 0 (ZLEX family).

    Values are raw strings (reference uses StringCodec for lex sets).
    """

    @staticmethod
    def _e(v) -> bytes:
        return v.encode() if isinstance(v, str) else bytes(v)

    @staticmethod
    def _d(raw: bytes) -> str:
        return raw.decode()

    def add(self, value) -> bool:
        return (
            self._executor.execute_sync(self.name, "zadd", {"pairs": [(self._e(value), 0.0)]})
            > 0
        )

    def add_all(self, values: Iterable) -> int:
        pairs = [(self._e(v), 0.0) for v in values]
        return self._executor.execute_sync(self.name, "zadd", {"pairs": pairs})

    def remove(self, value) -> bool:
        return self._executor.execute_sync(self.name, "zrem", {"members": [self._e(value)]}) > 0

    def contains(self, value) -> bool:
        return (
            self._executor.execute_sync(self.name, "zscore", {"member": self._e(value)})
            is not None
        )

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "zcard", None)

    def lex_range(
        self,
        from_element=None,
        from_inclusive: bool = True,
        to_element=None,
        to_inclusive: bool = True,
        offset: int = 0,
        count: Optional[int] = None,
    ) -> List[str]:
        raw = self._executor.execute_sync(
            self.name,
            "zrangebylex",
            {
                "min": None if from_element is None else self._e(from_element),
                "max": None if to_element is None else self._e(to_element),
                "min_inc": from_inclusive,
                "max_inc": to_inclusive,
                "offset": offset,
                "count": count,
            },
        )
        return [self._d(m) for m in raw]

    def lex_range_head(self, to_element, inclusive: bool = True) -> List[str]:
        return self.lex_range(to_element=to_element, to_inclusive=inclusive)

    def lex_range_tail(self, from_element, inclusive: bool = True) -> List[str]:
        return self.lex_range(from_element=from_element, from_inclusive=inclusive)

    def lex_count(
        self,
        from_element=None,
        from_inclusive: bool = True,
        to_element=None,
        to_inclusive: bool = True,
    ) -> int:
        return len(self.lex_range(from_element, from_inclusive, to_element, to_inclusive))

    def remove_range(
        self,
        from_element=None,
        from_inclusive: bool = True,
        to_element=None,
        to_inclusive: bool = True,
    ) -> int:
        return self._executor.execute_sync(
            self.name,
            "zremrangebylex",
            {
                "min": None if from_element is None else self._e(from_element),
                "max": None if to_element is None else self._e(to_element),
                "min_inc": from_inclusive,
                "max_inc": to_inclusive,
            },
        )

    def read_all(self) -> List[str]:
        return self.lex_range()

    # -- reference RLexSortedSet.java surface completers --------------------
    # (extends SortedSet<String> + the ZLEX families; `range`/`valueRange`
    # are BY-INDEX reads there, head/tail are the open-ended lex windows.)

    def rank(self, value) -> Optional[int]:
        return self._executor.execute_sync(
            self.name, "zrank", {"member": self._e(value)})

    def rev_rank(self, value) -> Optional[int]:
        return self._executor.execute_sync(
            self.name, "zrank", {"member": self._e(value), "rev": True})

    def first(self) -> Optional[str]:
        vals = self.value_range(0, 0)
        return vals[0] if vals else None

    def last(self) -> Optional[str]:
        vals = self.value_range(-1, -1)
        return vals[0] if vals else None

    def poll_first(self) -> Optional[str]:
        raw = self._executor.execute_sync(self.name, "zpop", {})
        return None if raw is None else self._d(raw[0])

    def poll_last(self) -> Optional[str]:
        raw = self._executor.execute_sync(self.name, "zpop", {"last": True})
        return None if raw is None else self._d(raw[0])

    def value_range(self, start: int, stop: int) -> List[str]:
        """BY-INDEX window (reference valueRange/range: ZRANGE on the
        all-zero-score set = lex order)."""
        raw = self._executor.execute_sync(
            self.name, "zrange", {"start": start, "stop": stop})
        return [self._d(m) for m in raw]

    def range(self, start: int, stop: int) -> List[str]:
        return self.value_range(start, stop)

    def range_head(self, to_element, inclusive: bool = True) -> List[str]:
        return self.lex_range_head(to_element, inclusive)

    def range_tail(self, from_element, inclusive: bool = True) -> List[str]:
        return self.lex_range_tail(from_element, inclusive)

    def count(self, from_element=None, from_inclusive: bool = True,
              to_element=None, to_inclusive: bool = True) -> int:
        return self.lex_count(from_element, from_inclusive,
                              to_element, to_inclusive)

    def count_head(self, to_element, inclusive: bool = True) -> int:
        return self.lex_count(to_element=to_element, to_inclusive=inclusive)

    def count_tail(self, from_element, inclusive: bool = True) -> int:
        return self.lex_count(from_element=from_element,
                              from_inclusive=inclusive)

    def lex_count_head(self, to_element, inclusive: bool = True) -> int:
        return self.count_head(to_element, inclusive)

    def lex_count_tail(self, from_element, inclusive: bool = True) -> int:
        return self.count_tail(from_element, inclusive)

    def remove_range_by_lex(self, from_element=None,
                            from_inclusive: bool = True, to_element=None,
                            to_inclusive: bool = True) -> int:
        return self.remove_range(from_element, from_inclusive,
                                 to_element, to_inclusive)

    def remove_range_head(self, to_element, inclusive: bool = True) -> int:
        return self.remove_range(to_element=to_element,
                                 to_inclusive=inclusive)

    def remove_range_head_by_lex(self, to_element,
                                 inclusive: bool = True) -> int:
        return self.remove_range_head(to_element, inclusive)

    def remove_range_tail(self, from_element, inclusive: bool = True) -> int:
        return self.remove_range(from_element=from_element,
                                 from_inclusive=inclusive)

    def remove_range_tail_by_lex(self, from_element,
                                 inclusive: bool = True) -> int:
        return self.remove_range_tail(from_element, inclusive)

    def __len__(self) -> int:
        return self.size()

    def __contains__(self, value) -> bool:
        return self.contains(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self.read_all())
