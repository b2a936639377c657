"""Pure-math Bloom filter formulas (a copy of `redisson_tpu.ops.bloom_math`,
which imports no JAX; the port keeps its own copy).

Sizing follows the reference exactly (`RedissonBloomFilter.java:69-78`,
Guava-style); count_estimate is its BITCOUNT cardinality formula
(`:188-199`).
"""

from __future__ import annotations

import math

MAX_SIZE = 1 << 32  # reference cap (RedissonBloomFilter.java:52)


def optimal_num_of_bits(n: int, p: float) -> int:
    """m = -n ln p / ln^2 2 (reference optimalNumOfBits)."""
    if p == 0.0:
        p = 5e-324  # Double.MIN_VALUE, as in the reference
    return int(-n * math.log(p) / (math.log(2.0) ** 2))


def optimal_num_of_hash_functions(n: int, m: int) -> int:
    """k = max(1, round(m/n * ln 2)) (reference optimalNumOfHashFunctions)."""
    return max(1, round(m / n * math.log(2.0)))


def check_cap(m: int) -> None:
    """The layout-independent bound: 0 < m <= 2^32. (The device path
    additionally requires power-of-two sizes above 2^31: ops/bloom.py
    check_size.)"""
    if m <= 0:
        raise ValueError("bloom size must be positive")
    if m > MAX_SIZE:
        raise ValueError(f"bloom size {m} exceeds cap {MAX_SIZE}")


def count_estimate(bit_count: int, m: int, k: int) -> float:
    """Cardinality from the number of set bits: -m/k * ln(1 - bc/m)."""
    if bit_count >= m:
        return float(m)
    return -(m / k) * math.log1p(-bit_count / m)
