"""Bloom filter index math and membership (counterpart of
`redisson_tpu.ops.bloom`), bit-identical to it.

Sizing follows the reference (`RedissonBloomFilter.java:69-78`); h1/h2 are
the two MurmurHash3 x64 128 halves, and the k indexes are the classic
double-hashing walk index_i = ((h1 + i*h2) mod 2^64) mod m.

64-bit values are int64 tensors holding the unsigned bits (`ops.u64`), so
a hash >= 2^63 is negative here and torch's `%` (a signed floor-mod) cannot
reduce it directly. `_mod_u64` splits the value into 32-bit halves and
reduces `((hi mod m) << 32 | lo) mod m`, which stays below 2^63 for
m <= 2^31; a power-of-two m up to 2^32 is a mask of the low bits. The JAX
package walks the k indexes with reduced adds and a carry correction,
because the TPU has no 64-bit division; here each wrapped 64-bit sum
h1 + i*h2 is formed in int64 (it wraps mod 2^64 like uint64) and reduced
directly. Both give the same residue, so the indexes match to the bit.
The cap (m <= 2^31, or a power of two up to 2^32) is kept as JAX has it.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import u64 as u
from redisson_tpu_torch.ops.bloom_math import (  # noqa: F401
    MAX_SIZE, optimal_num_of_bits, optimal_num_of_hash_functions)

_LO32 = (1 << 32) - 1


def check_size(m: int) -> None:
    if m <= 0:
        raise ValueError("bloom size must be positive")
    if m > MAX_SIZE:
        raise ValueError(f"bloom size {m} exceeds cap {MAX_SIZE}")
    if m > (1 << 31) and (m & (m - 1)) != 0:
        raise ValueError(
            f"bloom size m={m} is above 2^31 and not a power of two — the "
            "device index math (_mod_u64) requires m <= 2^31 or "
            "power-of-two m up to 2^32")


def _mod_u64(x: torch.Tensor, m: int) -> torch.Tensor:
    """Exact (x as uint64) mod m, as int64. Requires m <= 2^31 or m a
    power of two <= 2^32."""
    if (m & (m - 1)) == 0:
        return x & (m - 1)
    hi = u.shr(x, 32)          # in [0, 2^32)
    lo = x & _LO32
    # (hi mod m) < 2^31, so the shifted value plus lo stays below 2^63.
    return (((hi % m) << 32) | lo) % m


def indexes(h1: torch.Tensor, h2: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """[N] hash pairs (int64) -> [N, k] int64 bit indexes."""
    check_size(m)
    i = torch.arange(k, dtype=torch.int64, device=h1.device)
    # All k sums in one [N, k] tensor; int64 wraps mod 2^64 like uint64.
    return _mod_u64(h1[:, None] + i * h2[:, None], m)


def add(bits: torch.Tensor, idx: torch.Tensor):
    """Set all [N, k] indexes -> (new_bits, added_mask[N]); `added` is True
    where some bit of the key was unset at batch start."""
    flat = idx.reshape(-1)
    old = bits[flat].reshape(idx.shape)
    new = bits.clone()
    new[flat] = 1
    return new, (old == 0).any(dim=-1)


def contains(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, k] indexes -> [N] bool membership."""
    return (bits[idx.reshape(-1)].reshape(idx.shape) == 1).all(dim=-1)


# ---------------------------------------------------------------------------
# Blocked layout: all k bits of a key inside one 512-bit block (Putze et
# al., "Cache-, Hash- and Space-Efficient Bloom Filters"), as in JAX.
# ---------------------------------------------------------------------------

BLOCK_BITS = 512


def blocked_geometry(m: int) -> int:
    """Round a sizing-formula bit count up to whole blocks."""
    return ((m + BLOCK_BITS - 1) // BLOCK_BITS) * BLOCK_BITS


def blocked_indexes(h1: torch.Tensor, h2: torch.Tensor, k: int, m: int):
    """[N] hash pairs -> (block [N] int64, pos [N, k] int64).

    block = h1 mod nblocks; pos_i = (lo32(h2) + i*step) mod 512 with the odd
    step hi32(h1) | 1 (the uint32 sum's low 9 bits equal the int64 sum's)."""
    nblocks = m // BLOCK_BITS
    if nblocks < 1 or m % BLOCK_BITS:
        raise ValueError(f"blocked filter size must be a multiple of {BLOCK_BITS}")
    block = _mod_u64(h1, nblocks)
    step = u.shr(h1, 32) | 1
    i = torch.arange(k, dtype=torch.int64, device=h1.device)
    pos = ((h2 & _LO32)[..., None] + i * step[..., None]) & (BLOCK_BITS - 1)
    return block, pos


def blocked_absolute(block: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(block, in-block positions) -> absolute [N, k] int64 bit indexes."""
    return block[..., None] * BLOCK_BITS + pos


def blocked_contains(bits: torch.Tensor, block: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """[m] cells + per-key (block, pos) -> [N] membership. JAX gathers each
    key's 512-cell row and one-hot selects in it (what the TPU vectorises);
    here the k cells are gathered directly, which reads the same values."""
    got = bits[blocked_absolute(block, pos)]
    return (got > 0).all(dim=-1)
