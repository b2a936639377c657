"""RBucket / RBuckets / RAtomicLong / RAtomicDouble.

Reference: `RedissonBucket.java` (GET/SET/GETSET/SETNX/SETEX object holder),
`RedissonBuckets` multi-get via MGET (`Redisson.java` loadBucketValues),
`RedissonAtomicLong.java` (INCRBY/DECRBY/GETSET/CAS via WAIT-free commands),
`RedissonAtomicDouble.java` (INCRBYFLOAT).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from redisson_tpu_torch.models.expirable import RExpirable
from redisson_tpu_torch.models.object import map_future as _map_future


class RBucket(RExpirable):
    """Typed value holder (codec-encoded bytes under one key)."""

    def get(self) -> Any:
        return self.get_async().result()

    def get_async(self):
        f = self._executor.execute_async(self.name, "get", None)
        return _map_future(f, lambda raw: None if raw is None else self._codec.decode(raw))

    def set(self, value: Any, ttl_s: Optional[float] = None) -> None:
        self.set_async(value, ttl_s).result()

    def set_async(self, value: Any, ttl_s: Optional[float] = None):
        if value is None:
            # None == absent across the whole bucket surface (the
            # reference's setAsync(null) issues DEL, and
            # get_and_set/compare_and_set follow it — set must agree).
            return self._executor.execute_async(self.name, "delete", None)
        payload = {"value": self._codec.encode(value)}
        if ttl_s:
            payload["ttl_ms"] = int(ttl_s * 1000)
        return self._executor.execute_async(self.name, "set", payload)

    def get_and_set(self, value: Any) -> Any:
        """getAndSet; a None value DELETES the key (None == absent, the
        reference contract — RedissonBucketTest.java:33-43)."""
        raw = self._executor.execute_sync(
            self.name, "getset",
            {"value": None if value is None else self._codec.encode(value)})
        return None if raw is None else self._codec.decode(raw)

    def try_set(self, value: Any, ttl_s: Optional[float] = None) -> bool:
        if value is None:
            # trySet(null): succeed iff absent, writing nothing (None ==
            # absent, same contract as set/compare_and_set).
            return not self.is_exists()
        payload = {"value": self._codec.encode(value)}
        if ttl_s:
            payload["ttl_ms"] = int(ttl_s * 1000)
        return self._executor.execute_sync(self.name, "setnx", payload)

    def compare_and_set(self, expect: Any, update: Any) -> bool:
        """compareAndSet; None on either side means ABSENT — expect=None
        requires a missing key, update=None deletes on match
        (RedissonBucketTest.java:16-31)."""
        return self._executor.execute_sync(
            self.name,
            "compare_and_set",
            {
                "expect": None if expect is None else self._codec.encode(expect),
                "update": None if update is None else self._codec.encode(update),
            },
        )

    def size(self) -> int:
        return self._executor.execute_sync(self.name, "strlen", None)


class RBuckets:
    """Multi-bucket facade (reference `RBuckets`: MGET/MSET/MSETNX)."""

    def __init__(self, executor, codec):
        self._executor = executor
        self._codec = codec

    def get(self, *names: str) -> Dict[str, Any]:
        raw = self._executor.execute_sync("", "mget", {"names": list(names)})
        return {k: self._codec.decode(v) for k, v in raw.items()}

    def set(self, values: Dict[str, Any]) -> None:
        pairs = {k: self._codec.encode(v) for k, v in values.items()}
        self._executor.execute_sync("", "mset", {"pairs": pairs})

    def find(self, pattern: str) -> List["RBucket"]:
        """Reference find(pattern): buckets whose names match the glob."""
        names = self._executor.execute_sync("", "keys", {"pattern": pattern})
        return [RBucket(n, self._executor, self._codec) for n in names]

    def try_set(self, values: Dict[str, Any]) -> bool:
        pairs = {k: self._codec.encode(v) for k, v in values.items()}
        return self._executor.execute_sync("", "msetnx", {"pairs": pairs})


class RAtomicLong(RExpirable):
    """Reference: `RedissonAtomicLong.java` (+ `core/RAtomicLongAsync`)."""

    def get(self) -> int:
        return self.get_async().result()

    def get_async(self):
        f = self._executor.execute_async(self.name, "num_get", {})
        return _map_future(f, int)

    def set(self, value: int) -> None:
        self.set_async(value).result()

    def set_async(self, value: int):
        return self._executor.execute_async(
            self.name, "set", {"value": str(int(value)).encode()}
        )

    def increment_and_get(self) -> int:
        return self.add_and_get(1)

    def increment_and_get_async(self):
        return self.add_and_get_async(1)

    def decrement_and_get(self) -> int:
        return self.add_and_get(-1)

    def decrement_and_get_async(self):
        return self.add_and_get_async(-1)

    def add_and_get(self, delta: int) -> int:
        return self.add_and_get_async(delta).result()

    def add_and_get_async(self, delta: int):
        f = self._executor.execute_async(self.name, "incr", {"by": int(delta)})
        return _map_future(f, int)

    def get_and_increment(self) -> int:
        return self.add_and_get(1) - 1

    def get_and_increment_async(self):
        return _map_future(self.add_and_get_async(1), lambda v: v - 1)

    def get_and_decrement(self) -> int:
        return self.add_and_get(-1) + 1

    def get_and_decrement_async(self):
        return _map_future(self.add_and_get_async(-1), lambda v: v + 1)

    def get_and_add(self, delta: int) -> int:
        return self.add_and_get(delta) - int(delta)

    def get_and_add_async(self, delta: int):
        return _map_future(self.add_and_get_async(delta), lambda v: v - int(delta))

    def get_and_set(self, value: int) -> int:
        return self.get_and_set_async(value).result()

    def get_and_set_async(self, value: int):
        f = self._executor.execute_async(self.name, "num_getandset", {"value": int(value)})
        return _map_future(f, int)

    def compare_and_set(self, expect: int, update: int) -> bool:
        return self.compare_and_set_async(expect, update).result()

    def compare_and_set_async(self, expect: int, update: int):
        return self._executor.execute_async(
            self.name, "num_cas", {"expect": int(expect), "update": int(update)}
        )


class RAtomicDouble(RExpirable):
    """Reference: `RedissonAtomicDouble.java` (INCRBYFLOAT semantics)."""

    def get(self) -> float:
        return self.get_async().result()

    def get_async(self):
        f = self._executor.execute_async(self.name, "num_get", {"float": True})
        return _map_future(f, float)

    def set(self, value: float) -> None:
        self.set_async(value).result()

    def set_async(self, value: float):
        return self._executor.execute_async(
            self.name, "set", {"value": repr(float(value)).encode()}
        )

    def add_and_get(self, delta: float) -> float:
        return self.add_and_get_async(delta).result()

    def add_and_get_async(self, delta: float):
        f = self._executor.execute_async(
            self.name, "incr", {"by": float(delta), "float": True}
        )
        return _map_future(f, float)

    def increment_and_get(self) -> float:
        return self.add_and_get(1.0)

    def increment_and_get_async(self):
        return self.add_and_get_async(1.0)

    def decrement_and_get(self) -> float:
        return self.add_and_get(-1.0)

    def decrement_and_get_async(self):
        return self.add_and_get_async(-1.0)

    def get_and_increment(self) -> float:
        return self.add_and_get(1.0) - 1.0

    def get_and_increment_async(self):
        return _map_future(self.add_and_get_async(1.0), lambda v: v - 1.0)

    def get_and_decrement(self) -> float:
        return self.add_and_get(-1.0) + 1.0

    def get_and_decrement_async(self):
        return _map_future(self.add_and_get_async(-1.0), lambda v: v + 1.0)

    def get_and_add(self, delta: float) -> float:
        return self.add_and_get(delta) - float(delta)

    def get_and_add_async(self, delta: float):
        return _map_future(self.add_and_get_async(delta), lambda v: v - float(delta))

    def get_and_set(self, value: float) -> float:
        return self.get_and_set_async(value).result()

    def get_and_set_async(self, value: float):
        f = self._executor.execute_async(
            self.name, "num_getandset", {"value": float(value), "float": True}
        )
        return _map_future(f, float)

    def compare_and_set(self, expect: float, update: float) -> bool:
        return self.compare_and_set_async(expect, update).result()

    def compare_and_set_async(self, expect: float, update: float):
        return self._executor.execute_async(
            self.name,
            "num_cas",
            {"expect": float(expect), "update": float(update), "float": True},
        )


