"""Sharded bit arrays: ONE logical bit array spanning the mesh (counterpart
of `redisson_tpu.parallel.sharded_bits`).

The semantics are JAX's (its header): bits live unpacked, one uint8 cell
per bit, as a `mesh.Sharded` of [n] cells whose block i, n/D contiguous
cells, is a tensor of its own on entry i's device (JAX's `P("shards")`),
so each entry owns one bit range;

  * SETBIT / GETBIT batches go to every block's card (peer copies from
    home); each block masks the indexes landing in its range and scatters
    or gathers over its own cells, and the old values, peer-copied back to
    home, combine by a sum (each bit has exactly one owner, so the sum is
    a select: JAX's `lax.psum`);
  * BITOP AND / OR / XOR between same-sharded arrays is local to each
    block (the `bitop_cells` kernel on its card over the operands' blocks
    of that entry); BITCOUNT is a per-block `popcount_partials` launch on
    its card and an int64 combine on the host, exact past 2^31 set bits
    (an int32 total would wrap);
  * Bloom add / contains hash the batch once on home and peer-copy the
    hashes to every block's card, where the [N, k] indexes are computed
    and the masked bodies run: an add runs the segment-OR kernel
    (`bits_insert_segmented`) per block with block-local codes, or the
    plain `scatter_` where a block holds 2^31 cells or more (the
    segment-OR's int32 codes cannot hold its one-past-the-end sentinel
    there). That rule is decided by size before any launch, as the
    single-card planner decides it. `added` and `got` sum on home.

Indexes are int64 (an index up to 2^32 - 1 is valid). The physical length
is padded to a multiple of the mesh size times ALLOC_GRAIN; callers track
the logical bit count and bound NOT and set_range by it, so padding cells
stay 0 and never reach BITCOUNT or length. Where JAX donates the array,
the port writes it in place and returns it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ops import bloom, hashing
from redisson_tpu_torch.ops import kernels as pk
from redisson_tpu_torch.parallel.mesh import (
    SHARD_AXIS, Mesh, Sharded, Sharding, on_home, replicate)

ALLOC_GRAIN = 1024  # per-shard allocation granularity (bits)


def bits_sharding(mesh: Mesh) -> Sharding:
    """[n] cells: contiguous ranges split across the entries."""
    return Sharding(mesh, SHARD_AXIS)


def physical_size(nbits: int, mesh: Mesh) -> int:
    """Smallest mesh-divisible physical length >= nbits."""
    grain = ALLOC_GRAIN * mesh.size
    return max(grain, (nbits + grain - 1) // grain * grain)


def make_bits(mesh: Mesh, nbits: int) -> Sharded:
    """Zero bit array of physical_size(nbits) cells: one zero block per
    entry, on its device."""
    return bits_sharding(mesh).zeros((physical_size(nbits, mesh),), torch.uint8)


def _sum_on_home(parts, mesh: Mesh) -> torch.Tensor:
    """The psum of per-block int32 partials: each peer-copied to home."""
    out = parts[0].to(mesh.home)
    for p in parts[1:]:
        out = out + p.to(mesh.home)
    return out


# -- scatter / gather bodies --------------------------------------------------


def _local(idx: torch.Tensor, valid: torch.Tensor, lo: int, hi: int):
    """(mine, safe local index) for the block owning cells [lo, hi)."""
    mine = valid & (idx >= lo) & (idx < hi)
    return mine, torch.where(mine, idx - lo, 0)


def _per_block(bits: Sharded, mesh: Mesh, *operands):
    """(lo, hi, block, the operands on its card) for every block: the
    operands (on home) replicated to the blocks' cards."""
    copies = zip(*(replicate(mesh, t) for t in operands))
    for (lo, hi), block, ops in zip(bits.ranges(), bits.blocks, copies):
        yield lo, hi, block, ops


def _scatter(bits: Sharded, idx, valid, mesh: Mesh, set_value: bool):
    idx = on_home(mesh, idx, torch.int64)
    valid = on_home(mesh, valid, torch.bool)
    old = []
    for lo, hi, block, (i, v) in _per_block(bits, mesh, idx, valid):
        mine, safe = _local(i, v, lo, hi)
        old.append(torch.where(mine, block[safe], 0).to(torch.int32))
        if set_value:
            block.scatter_reduce_(0, safe, mine.to(torch.uint8), reduce="amax")
        else:
            block.scatter_reduce_(0, safe, (~mine).to(torch.uint8), reduce="amin")
    return bits, _sum_on_home(old, mesh)


def set_bits(bits: Sharded, idx, valid, mesh: Mesh):
    """SETBIT batch, in place -> (bits, old_values[K] int32 on home)."""
    return _scatter(bits, idx, valid, mesh, True)


def clear_bits(bits: Sharded, idx, valid, mesh: Mesh):
    """SETBIT 0 batch, in place -> (bits, old_values[K] int32 on home)."""
    return _scatter(bits, idx, valid, mesh, False)


def get_bits(bits: Sharded, idx, valid, mesh: Mesh) -> torch.Tensor:
    """GETBIT batch -> [K] int32 values on home (0 where not valid)."""
    idx = on_home(mesh, idx, torch.int64)
    valid = on_home(mesh, valid, torch.bool)
    out = []
    for lo, hi, block, (i, v) in _per_block(bits, mesh, idx, valid):
        mine, safe = _local(i, v, lo, hi)
        out.append(torch.where(mine, block[safe], 0).to(torch.int32))
    return _sum_on_home(out, mesh)


# -- whole-array ops ----------------------------------------------------------


def cardinality_partials(bits: Sharded, mesh: Mesh) -> List[torch.Tensor]:
    """Per-block int32 popcount partials, each on its block's card (one
    `popcount_partials` launch per block; each partial is at most 2^18).
    The cross-block combine happens on the host in int64
    (`combine_partials`)."""
    return [pk.popcount_partials(block) for block in bits.blocks]


def combine_partials(partials) -> int:
    """64-bit exact host combine of the blocks' int32 partials."""
    if isinstance(partials, torch.Tensor):
        partials = [partials]
    return int(sum(np.asarray(p.cpu().numpy() if isinstance(p, torch.Tensor)
                              else p, dtype=np.int64).sum()
                   for p in partials))


def cardinality(bits: Sharded, mesh: Mesh) -> int:
    """BITCOUNT: per-block partials on the cards, 64-bit combine on the
    host."""
    return combine_partials(cardinality_partials(bits, mesh))


def _length_parts(bits: Sharded, mesh: Mesh):
    """(highest set INDEX as a Python int, any-set flag): the last block
    holding a set cell, its last ALLOC_GRAIN group holding one, and the
    last set cell in that group, each read on the block's card. The +1
    happens in Python ints."""
    for (lo, _), block in zip(reversed(bits.ranges()), reversed(bits.blocks)):
        groups = block.view(-1, ALLOC_GRAIN).amax(dim=1)
        hit = torch.nonzero(groups)
        if hit.numel():
            g = int(hit[-1, 0])
            cells = block[g * ALLOC_GRAIN: (g + 1) * ALLOC_GRAIN]
            j = int(torch.nonzero(cells)[-1, 0])
            return lo + g * ALLOC_GRAIN + j, True
    return 0, False


def length(bits: Sharded, mesh: Mesh) -> int:
    """Highest set bit + 1 (0 if empty): correct up to 2^32 cells."""
    idx, has = _length_parts(bits, mesh)
    return idx + 1 if has else 0


def set_range(bits: Sharded, start: int, last: int, value: bool,
              mesh: Mesh) -> Sharded:
    """Set cells [start, last] INCLUSIVE to `value`, in place (the
    exclusive end of a full 2^32-bit range does not fit uint32, hence the
    inclusive bound JAX keeps; callers guard empty ranges). Each block
    fills the slice of its range: no index mask over the array."""
    start, stop = int(start), int(last) + 1
    for (lo, hi), block in zip(bits.ranges(), bits.blocks):
        a, b = max(start, lo), min(stop, hi)
        if a < b:
            block[a - lo:b - lo].fill_(1 if value else 0)
    return bits


def bitop_not(bits: Sharded, last: int, mesh: Mesh) -> Sharded:
    """BITOP NOT over cells [0, last] inclusive, in place; padding cells
    stay 0."""
    stop = int(last) + 1
    for (lo, hi), block in zip(bits.ranges(), bits.blocks):
        b = min(stop, hi)
        if lo < b:
            block[:b - lo].bitwise_xor_(1)
    return bits


def bitop(operands, op: str, mesh: Mesh) -> Sharded:
    """BITOP AND | OR | XOR over K same-sharded operands (a sequence of
    `Sharded` of one length) -> a fresh `Sharded`: per entry, one
    `bitop_cells` launch on its card over the K operands' blocks."""
    if len({len(o) for o in operands}) != 1:
        raise ValueError("bitop operands differ in length")
    return Sharded(mesh, [pk.bitop_cells(torch.stack(blocks), op)
                          for blocks in zip(*(o.blocks for o in operands))])


# -- Bloom over the sharded array ---------------------------------------------


def bloom_indexes(h1, h2, valid, k: int, m: int, layout: str) -> torch.Tensor:
    """The replicated [N, k] cell indexes of a hashed batch (0 where not
    valid): the classic double-hash walk or the blocked layout."""
    if layout == "blocked":
        block, pos = bloom.blocked_indexes(h1, h2, k, m)
        idx = bloom.blocked_absolute(block, pos)
    else:
        idx = bloom.indexes(h1, h2, k, m)
    return torch.where(valid[:, None], idx, 0)


def uses_segment(cells: int) -> bool:
    """Whether a shard of `cells` cells takes the segment-OR kernel (its
    int32 codes need m < 2^31 for the one-past-the-end sentinel), else the
    plain scatter_."""
    return cells <= ingest_kernels.MAX_SEGMENT_CELLS


def _bloom_cells(bits: Sharded, mesh: Mesh, h1, h2, valid, k: int, m: int,
                 layout: str):
    """(lo, hi, block, flat indexes, flat valid) for every block: the
    hashes replicated to the blocks' cards and the indexes computed there,
    once per card."""
    per_card = {}
    for lo, hi, block, (a, b, v) in _per_block(bits, mesh, h1, h2, valid):
        if block.device not in per_card:
            idx = bloom_indexes(a, b, v, k, m, layout).reshape(-1)
            per_card[block.device] = (idx, v[:, None].expand(-1, k).reshape(-1))
        yield (lo, hi, block) + per_card[block.device]


def bloom_add_hashes(bits: Sharded, h1, h2, valid, k: int, m: int,
                     mesh: Mesh, layout: str = "classic"):
    """Set a hashed batch's bits, block by block, in place -> (bits, added
    [N] bool on home), `added` against the batch start (each block's old
    cells are gathered before its insert; no other block writes them).
    The hashes go to each block's card, which computes the indexes."""
    old = []
    for lo, hi, block, idx, vflat in _bloom_cells(bits, mesh, h1, h2, valid,
                                                  k, m, layout):
        mine, safe = _local(idx, vflat, lo, hi)
        old.append(torch.where(mine, block[safe], 0).to(torch.int32))
        if uses_segment(hi - lo):
            ingest_kernels.bits_insert_segmented(
                block, torch.where(mine, safe, hi - lo))
        else:
            block.scatter_reduce_(0, safe, mine.to(torch.uint8), reduce="amax")
    old = _sum_on_home(old, mesh).reshape(-1, k)
    added = (old == 0).any(dim=-1) & on_home(mesh, valid, torch.bool)
    return bits, added


def bloom_contains_hashes(bits: Sharded, h1, h2, valid, k: int, m: int,
                          mesh: Mesh, layout: str = "classic") -> torch.Tensor:
    """Membership of a hashed batch: each block gathers the cells it owns
    on its card, the flags sum on home -> [N] bool on home."""
    got = []
    for lo, hi, block, idx, vflat in _bloom_cells(bits, mesh, h1, h2, valid,
                                                  k, m, layout):
        mine, safe = _local(idx, vflat, lo, hi)
        got.append(torch.where(mine, block[safe], 0).to(torch.int32))
    got = _sum_on_home(got, mesh).reshape(-1, k)
    return (got == 1).all(dim=-1) & on_home(mesh, valid, torch.bool)


def _packed_hashes(keys, count: int, seed: int, mesh: Mesh):
    """(h1, h2, valid) on home of int64 keys (the [n, 2] uint32 layout's
    bits)."""
    keys = on_home(mesh, keys, torch.int64)
    valid = torch.arange(keys.shape[0], device=keys.device) < int(count)
    h1, h2 = hashing.murmur3_x64_128_u64(keys, seed)
    return h1, h2, valid


def _byte_hashes(data, lengths, valid, seed: int, mesh: Mesh):
    h1, h2 = hashing.murmur3_x64_128(on_home(mesh, data, torch.uint8),
                                     on_home(mesh, lengths, torch.int32), seed)
    return h1, h2, on_home(mesh, valid, torch.bool)


def bloom_add_packed(bits, keys, count: int, k: int, m: int, seed: int,
                     mesh: Mesh, layout: str = "classic"):
    h1, h2, valid = _packed_hashes(keys, count, seed, mesh)
    return bloom_add_hashes(bits, h1, h2, valid, k, m, mesh, layout)


def bloom_contains_packed(bits, keys, count: int, k: int, m: int, seed: int,
                          mesh: Mesh, layout: str = "classic"):
    h1, h2, valid = _packed_hashes(keys, count, seed, mesh)
    return bloom_contains_hashes(bits, h1, h2, valid, k, m, mesh, layout)


def bloom_contains_count_packed(bits, keys, count: int, k: int, m: int,
                                seed: int, mesh: Mesh,
                                layout: str = "classic") -> torch.Tensor:
    """Membership COUNT of an int64 key batch as one int64 device scalar."""
    return bloom_contains_packed(bits, keys, count, k, m, seed, mesh,
                                 layout).sum(dtype=torch.int64)


def bloom_add_bytes(bits, data, lengths, valid, k: int, m: int, seed: int,
                    mesh: Mesh, layout: str = "classic"):
    h1, h2, valid = _byte_hashes(data, lengths, valid, seed, mesh)
    return bloom_add_hashes(bits, h1, h2, valid, k, m, mesh, layout)


def bloom_contains_bytes(bits, data, lengths, valid, k: int, m: int,
                         seed: int, mesh: Mesh, layout: str = "classic"):
    h1, h2, valid = _byte_hashes(data, lengths, valid, seed, mesh)
    return bloom_contains_hashes(bits, h1, h2, valid, k, m, mesh, layout)


# -- lifecycle ----------------------------------------------------------------


def grow_bits(bits: Sharded, new_nbits: int, mesh: Mesh) -> Sharded:
    """Enlarge to physical_size(new_nbits), keeping bit positions (the
    SETBIT auto-grow). As in JAX the cell ranges follow the new size, so
    cells can move to another entry, and another card."""
    target = physical_size(new_nbits, mesh)
    if target <= len(bits):
        return bits
    return bits_sharding(mesh).put(bits, target)


def migrate_bits(bits: Sharded, new_mesh: Mesh) -> Sharded:
    """Re-shard onto a different mesh (topology change / device loss): pad
    to the new mesh's grain; the cell ranges follow the new mesh, moving
    between cards where the entries' devices differ."""
    n = len(bits)
    target = physical_size(n, new_mesh)
    if target == n and new_mesh == bits.mesh:
        return bits
    return bits_sharding(new_mesh).put(bits, target)
