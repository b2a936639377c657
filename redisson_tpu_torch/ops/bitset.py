"""BitSet primitives with Redis bit semantics (counterpart of
`redisson_tpu.ops.bitset`).

Layout, as in the JAX package: bits are stored unpacked, one uint8 cell per
bit (value 0/1), so set/test are scatter / gather and BITCOUNT / BITOP are
vector reductions. Redis-compatible packed bytes (bit 0 is the MSB of byte
0) exist only at the serialization boundary (`pack` / `unpack`).

Bit indexes are int64 tensors where JAX used uint32: positions range over
the full 2^32 capacity and torch has no uint32 arithmetic for most ops.
These functions are functional like their JAX counterparts (they return
fresh tensors); the engine's SETBIT path updates in place instead.
"""

from __future__ import annotations

import numpy as np
import torch


def make(nbits: int, device=None) -> torch.Tensor:
    return torch.zeros((nbits,), dtype=torch.uint8, device=device)


def get_bits(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """GETBIT batch: [K] int64 indexes -> [K] uint8 in {0, 1}."""
    return bits[idx]


def set_bits(bits: torch.Tensor, idx: torch.Tensor):
    """SETBIT batch (value 1) -> (new_bits, old_values)."""
    old = bits[idx]
    new = bits.clone()
    new[idx] = 1
    return new, old


def clear_bits(bits: torch.Tensor, idx: torch.Tensor):
    """SETBIT batch (value 0) -> (new_bits, old_values)."""
    old = bits[idx]
    new = bits.clone()
    new[idx] = 0
    return new, old


def flip_bits(bits: torch.Tensor, idx: torch.Tensor):
    """Flip each indexed bit -> (new_bits, old_values). `old` is gathered
    before the scatter, so duplicate indexes in one batch all write the same
    flipped value: one flip per unique index."""
    old = bits[idx]
    new = bits.clone()
    new[idx] = 1 - old
    return new, old


def set_range(bits: torch.Tensor, start: int, end: int, value: bool) -> torch.Tensor:
    """Set [start, end) to `value` in one select (not one op per bit)."""
    pos = torch.arange(bits.shape[0], dtype=torch.int64, device=bits.device)
    in_range = (pos >= int(start)) & (pos < int(end))
    return torch.where(in_range, torch.ones_like(bits) if value
                       else torch.zeros_like(bits), bits)


_CARD_CHUNK = 1 << 20


def _chunks(bits: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """[n] cells -> [G, 2^20], the ragged tail padded with `fill`."""
    pad = (-bits.shape[0]) % _CARD_CHUNK
    if pad:
        bits = torch.cat([bits, bits.new_full((pad,), fill)])
    return bits.reshape(-1, _CARD_CHUNK)


def cardinality_partials(bits: torch.Tensor) -> torch.Tensor:
    """Per-chunk int32 popcount partials (each <= 2^20, overflow-proof);
    the total is combined on the host (`combine_partials`)."""
    return _chunks(bits).sum(dim=1, dtype=torch.int32)


def combine_partials(partials) -> int:
    """64-bit exact host combine of int32 popcount partials."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    return int(np.asarray(partials, dtype=np.int64).sum())


def cardinality(bits: torch.Tensor) -> int:
    return combine_partials(cardinality_partials(bits))


def length_partials(bits: torch.Tensor) -> torch.Tensor:
    """Per-chunk 'highest set bit + 1' as int32 local offsets; absolute
    positions exist only on the host (`combine_length`)."""
    chunks = _chunks(bits)
    pos = torch.arange(1, _CARD_CHUNK + 1, dtype=torch.int32, device=bits.device)
    return torch.where(chunks != 0, pos[None, :], 0).amax(dim=1)


def combine_length(partials) -> int:
    """64-bit exact host combine: the last chunk with a set bit wins."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    p = np.asarray(partials)
    nz = np.flatnonzero(p)
    if nz.size == 0:
        return 0
    g = int(nz[-1])
    return g * _CARD_CHUNK + int(p[g])


def length(bits: torch.Tensor) -> int:
    """Index of the highest set bit + 1 (0 if empty)."""
    return combine_length(length_partials(bits))


def bitpos_partials(bits: torch.Tensor, value: int) -> torch.Tensor:
    """Per-chunk first index holding `value` as int32 local offsets; -1
    where the chunk has no match. Pad cells hold the complement of `value`,
    so the pad never gives a false hit (scanning for 0)."""
    match = _chunks(bits, fill=0 if value else 1) == (1 if value else 0)
    idx = match.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(match.any(dim=1), idx, -1)


def combine_bitpos(partials) -> int:
    """64-bit exact host combine: the first chunk with a hit wins."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    p = np.asarray(partials)
    hit = np.flatnonzero(p >= 0)
    if hit.size == 0:
        return -1
    g = int(hit[0])
    return g * _CARD_CHUNK + int(p[g])


def bitpos(bits: torch.Tensor, value: int) -> int:
    """First index holding `value` (0/1), -1 if none (Redis BITPOS); a
    python int, exact past 2^31."""
    return combine_bitpos(bitpos_partials(bits, value))


def bitop_and(a, b):
    return a & b


def bitop_or(a, b):
    return a | b


def bitop_xor(a, b):
    return a ^ b


_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Unpacked cells -> Redis byte layout (bit 0 is the MSB of byte 0)."""
    n = bits.shape[0]
    pad = (-n) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,))])
    w = torch.tensor(_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (bits.reshape(-1, 8).to(torch.int32) * w).sum(dim=1).to(torch.uint8)


def unpack(data: torch.Tensor, nbits: int) -> torch.Tensor:
    """Redis bytes -> unpacked cells of length `nbits`."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=data.device)
    cells = (data.to(torch.int32)[:, None] >> shifts[None, :]) & 1
    return cells.to(torch.uint8).reshape(-1)[:nbits]
