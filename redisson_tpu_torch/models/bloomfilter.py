"""RBloomFilter: the reference's `core/RBloomFilter.java` surface
(`RedissonBloomFilter.java`: tryInit, add, contains, count, getSize,
getHashIterations, getExpectedInsertions, getFalseProbability) with batched
add_all/contains_all (a copy of `redisson_tpu.models.bloomfilter` on the
port's RObject).

The reference guards every op with a Lua config check and retries on
concurrent re-init (`RedissonBloomFilter.java:80-114`); here config is
immutable store metadata created once by tryInit, and ops fail loudly if the
filter was never initialized.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from redisson_tpu_torch.models.object import RObject, pack_u64
from redisson_tpu_torch.ops import bloom_math


class RBloomFilter(RObject):
    def try_init(self, expected_insertions: int, false_probability: float,
                 blocked: bool = False) -> bool:
        """Size + create; False if the filter already exists
        (reference tryInit contract).

        blocked=True lays all k bits of a key inside one 512-bit block
        (ops/bloom.py BLOCK_BITS), one cache-local region per key, for a
        slightly higher effective FPR at the same sizing.
        """
        if not 0 < false_probability < 1:
            raise ValueError("false_probability must be in (0, 1)")
        if int(expected_insertions) <= 0:
            raise ValueError("expected_insertions must be positive")
        # Enforce the device index math's precondition (ops/bloom.py
        # _mod_u64 needs m <= 2^31 or m a power of two) here, synchronously,
        # with the derived geometry in the message, not as a deferred
        # backend error. Backends declare it with BLOOM_STRICT_MOD.
        m = bloom_math.optimal_num_of_bits(
            int(expected_insertions), float(false_probability))
        if blocked:
            m = ((m + 511) // 512) * 512  # ops/bloom.BLOCK_BITS rounding
        strict = bool(getattr(
            getattr(self._executor, "backend", None), "BLOOM_STRICT_MOD", False))
        if strict and m > (1 << 31) and (m & (m - 1)) != 0:
            raise ValueError(
                f"derived bloom size m={m} bits (from expected_insertions="
                f"{int(expected_insertions)}, false_probability="
                f"{false_probability}) exceeds 2^31 and is not a power of "
                "two — the device index math (ops/bloom._mod_u64) is only "
                "exact for m <= 2^31 or power-of-two m up to 2^32. Lower "
                "expected_insertions, raise false_probability, or pick "
                "parameters whose derived m is a power of two."
            )
        if m > bloom_math.MAX_SIZE:
            raise ValueError(
                f"derived bloom size m={m} exceeds the 2^32-bit cap; lower "
                "expected_insertions or raise false_probability"
            )
        return self._executor.execute_sync(
            self.name,
            "bloom_init",
            {
                "expected_insertions": int(expected_insertions),
                "false_probability": float(false_probability),
                "blocked": bool(blocked),
            },
        )

    def is_blocked(self) -> bool:
        """Whether this filter uses the blocked (cache-line) layout.
        Filters from checkpoints that predate the layout flag are classic."""
        obj = self._executor.execute_sync(self.name, "bloom_meta", None)
        return bool(obj.get("blocked"))

    # -- mutation -----------------------------------------------------------

    def add(self, value) -> bool:
        return bool(self.add_all([value])[0])

    def add_all(self, values: Iterable) -> np.ndarray:
        return self.add_all_async(values).result()

    def add_all_async(self, values: Iterable):
        data, lengths = self._encode_batch(values)
        return self._executor.execute_async(
            self.name,
            "bloom_add",
            {"data": data, "lengths": lengths},
            nkeys=data.shape[0],
        )

    def add_ints(self, values: np.ndarray) -> np.ndarray:
        """Bulk path: uint64 keys hashed as their 8-byte LE encodings on
        the device, the same membership as add_all() of the same .tobytes()
        keys, with no per-key host encoding (pack_u64 borrow contract
        applies)."""
        return self.add_ints_async(values).result()

    def add_ints_async(self, values: np.ndarray):
        packed = pack_u64(values)
        return self._executor.execute_async(
            self.name, "bloom_add", {"packed": packed}, nkeys=packed.shape[0]
        )

    # -- membership ---------------------------------------------------------

    def contains_ints(self, values: np.ndarray) -> np.ndarray:
        return self.contains_ints_async(values).result()

    def contains_ints_async(self, values: np.ndarray):
        packed = pack_u64(values)
        return self._executor.execute_async(
            self.name, "bloom_contains", {"packed": packed},
            nkeys=packed.shape[0]
        )

    def contains_count_ints(self, values: np.ndarray) -> int:
        """Membership COUNT of a uint64 key batch: only a scalar returns
        (what an FPR probe wants)."""
        return self.contains_count_ints_async(values).result()

    def contains_count_ints_async(self, values: np.ndarray):
        packed = pack_u64(values)
        return self._executor.execute_async(
            self.name, "bloom_contains_count", {"packed": packed},
            nkeys=packed.shape[0]
        )

    def contains_count_device_async(self, keys):
        """Same, for keys already on the device: an int64 [n] tensor on the
        backend's device holding the uint64 keys' bits (where the JAX
        package takes a uint32 [n, 2] device array). No host key traffic."""
        return self._executor.execute_async(
            self.name, "bloom_contains_count", {"device_packed": keys},
            nkeys=int(keys.shape[0])
        )

    def contains(self, value) -> bool:
        return bool(self.contains_all([value])[0])

    def contains_all(self, values: Iterable) -> np.ndarray:
        return self.contains_all_async(values).result()

    def contains_all_async(self, values: Iterable):
        data, lengths = self._encode_batch(values)
        return self._executor.execute_async(
            self.name,
            "bloom_contains",
            {"data": data, "lengths": lengths},
            nkeys=data.shape[0],
        )

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        """Estimated element count from BITCOUNT
        (RedissonBloomFilter.java:188-199)."""
        return self._executor.execute_sync(self.name, "bloom_count", None)

    def _meta(self, key):
        obj = self._executor.execute_sync(self.name, "bloom_meta", None)
        return obj[key]

    def get_size(self) -> int:
        return self._meta("size")

    def get_hash_iterations(self) -> int:
        return self._meta("hash_iterations")

    def get_expected_insertions(self) -> int:
        return self._meta("expected_insertions")

    def get_false_probability(self) -> float:
        return self._meta("false_probability")
