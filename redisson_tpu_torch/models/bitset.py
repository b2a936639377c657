"""RBitSet: the reference's `core/RBitSet.java` surface (get/set/clear,
cardinality/length/size, and/or/xor/not, set-range, asBitSet) with batched
index variants (a copy of `redisson_tpu.models.bitset` on the port's
RObject).

Where the reference issues one SETBIT per bit in a range batch
(`RedissonBitSet.java:203-228`), every method here is one device call per
chunk of indexes.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from redisson_tpu_torch.models.object import RObject


def _idx(indexes) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(indexes, np.int64))
    if arr.size and arr.min() < 0:
        raise IndexError("negative bit index")
    return arr.astype(np.int64)


def _mutate_payload(arr: np.ndarray) -> dict:
    """Payload for set/clear: `max_idx` is precomputed host-side so the
    backend's grow path never has to reduce a (possibly device-resident)
    index array at dispatch time."""
    return {"idx": arr, "max_idx": int(arr.max()) if arr.size else -1}


class RBitSet(RObject):
    # -- single-bit / batched ------------------------------------------------

    def get(self, index: int) -> bool:
        return bool(self.get_bits([index])[0])

    def get_bits(self, indexes: Iterable[int]) -> np.ndarray:
        return self.get_bits_async(indexes).result()

    def get_bits_async(self, indexes):
        arr = _idx(indexes)
        return self._executor.execute_async(
            self.name, "bitset_get", {"idx": arr}, nkeys=arr.shape[0]
        )

    def set(self, index: int, value: bool = True) -> bool:
        """Returns the previous bit value (reference setAsync contract)."""
        if value:
            return bool(self.set_bits([index])[0])
        return bool(self.clear_bits([index])[0])

    def set_bits(self, indexes: Iterable[int]) -> np.ndarray:
        return self.set_bits_async(indexes).result()

    def set_bits_async(self, indexes):
        arr = _idx(indexes)
        return self._executor.execute_async(
            self.name, "bitset_set", _mutate_payload(arr), nkeys=arr.shape[0]
        )

    def clear_bits(self, indexes: Iterable[int]) -> np.ndarray:
        return self.clear_bits_async(indexes).result()

    def clear_bits_async(self, indexes):
        arr = _idx(indexes)
        return self._executor.execute_async(
            self.name, "bitset_clear", _mutate_payload(arr), nkeys=arr.shape[0]
        )

    def set_range(self, start: int, end: int, value: bool = True) -> None:
        """Set [start, end) — reference set(from, to) semantics."""
        self._executor.execute_sync(
            self.name,
            "bitset_set_range",
            {"start": int(start), "end": int(end), "value": bool(value)},
        )

    def clear(self, start: int = None, end: int = None) -> None:
        """clear() -> drop all; clear(i) -> one bit; clear(a, b) -> range
        (the three reference clear overloads)."""
        if start is None:
            self.delete()
        elif end is None:
            self.clear_bits([start])
        else:
            self.set_range(start, end, False)

    # -- aggregates ----------------------------------------------------------

    def cardinality(self) -> int:
        return self._executor.execute_sync(self.name, "bitset_cardinality", None)

    def length(self) -> int:
        """Highest set bit + 1 (reference lengthAsync via Lua scan)."""
        return self._executor.execute_sync(self.name, "bitset_length", None)

    def size(self) -> int:
        """Allocated capacity in bits (reference sizeAsync = STRLEN*8)."""
        return self._executor.execute_sync(self.name, "bitset_size", None)

    # -- multi-key ops (BITOP) ----------------------------------------------

    def and_(self, *names: str) -> None:
        self._executor.execute_sync(self.name, "bitset_op", {"op": "and", "names": list(names)})

    def or_(self, *names: str) -> None:
        self._executor.execute_sync(self.name, "bitset_op", {"op": "or", "names": list(names)})

    def xor(self, *names: str) -> None:
        self._executor.execute_sync(self.name, "bitset_op", {"op": "xor", "names": list(names)})

    def not_(self) -> None:
        self._executor.execute_sync(self.name, "bitset_op", {"op": "not", "names": []})

    # -- export --------------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Snapshot as a bool array (reference asBitSet analogue)."""
        n = self.length()
        if n == 0:
            return np.zeros((0,), bool)
        return self.get_bits(np.arange(n))

    def as_bit_set(self) -> set:
        """Reference asBitSet() -> java.util.BitSet; pythonic form: the set
        of set-bit indexes."""
        arr = self.to_numpy()
        return set(np.nonzero(arr)[0].tolist())

    def to_byte_array(self) -> bytes:
        """Reference toByteArray(): the packed big-endian bitmap (the exact
        bytes a Redis GET of the key returns)."""
        arr = self.to_numpy()
        if arr.size == 0:
            return b""
        return np.packbits(arr.astype(np.uint8)).tobytes()
