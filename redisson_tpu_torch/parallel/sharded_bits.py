"""Sharded bit arrays: ONE logical bit array spanning the mesh (counterpart
of `redisson_tpu.parallel.sharded_bits`).

The semantics are JAX's (its header): bits live unpacked, one uint8 cell
per bit, as an [n] array whose contiguous cell ranges are the mesh
entries' shards (n/D cells each), so each shard owns one bit range;

  * SETBIT / GETBIT batches are replicated to every shard; each shard masks
    the indexes landing in its range and scatters or gathers over its own
    view, and the old values combine by a sum across shards (each bit has
    exactly one owner, so the sum is a select: JAX's `lax.psum`);
  * BITOP AND / OR / XOR between same-sharded arrays is local to each shard
    (the `bitop_cells` kernel over each shard's range); BITCOUNT is a
    per-shard `popcount_partials` launch and an int64 combine on the host,
    exact past 2^31 set bits (an int32 total would wrap);
  * Bloom add / contains compute the [N, k] indexes replicated (the hash is
    cheap, the array is the big thing) and reuse the masked bodies: an add
    runs the segment-OR kernel (`bits_insert_segmented`) per shard with
    shard-local codes, or the plain `scatter_` where a shard holds 2^31
    cells or more (the segment-OR's int32 codes cannot hold its
    one-past-the-end sentinel there). That rule is decided by size before
    any launch, as the single-card planner decides it.

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
from redisson_tpu_torch.parallel.mesh import Mesh, row_blocks

ALLOC_GRAIN = 1024  # per-shard allocation granularity (bits)


def physical_size(nbits: int, mesh: Mesh) -> int:
    """Smallest mesh-divisible physical length >= nbits."""
    grain = ALLOC_GRAIN * mesh.size
    return max(grain, (nbits + grain - 1) // grain * grain)


def make_bits(mesh: Mesh, nbits: int) -> torch.Tensor:
    """Zero bit array of physical_size(nbits) cells on the mesh's device."""
    return torch.zeros((physical_size(nbits, mesh),), dtype=torch.uint8,
                       device=mesh.device)


def _on(mesh: Mesh, arr, dtype) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return torch.as_tensor(arr).to(mesh.device).to(dtype)


# -- scatter / gather bodies --------------------------------------------------


def _local(idx: torch.Tensor, valid: torch.Tensor, lo: int, hi: int):
    """(mine, safe local index) for the shard owning cells [lo, hi)."""
    mine = valid & (idx >= lo) & (idx < hi)
    return mine, torch.where(mine, idx - lo, 0)


def _scatter(bits, idx, valid, mesh: Mesh, set_value: bool):
    idx = _on(mesh, idx, torch.int64)
    valid = _on(mesh, valid, torch.bool)
    old = torch.zeros(idx.shape, dtype=torch.int32, device=bits.device)
    for lo, hi in row_blocks(bits.shape[0], mesh):
        view = bits[lo:hi]
        mine, safe = _local(idx, valid, lo, hi)
        old += torch.where(mine, view[safe], 0).to(torch.int32)
        if set_value:
            view.scatter_reduce_(0, safe, mine.to(torch.uint8), reduce="amax")
        else:
            view.scatter_reduce_(0, safe, (~mine).to(torch.uint8), reduce="amin")
    return bits, old


def set_bits(bits: torch.Tensor, idx, valid, mesh: Mesh):
    """SETBIT batch, in place -> (bits, old_values[K] int32)."""
    return _scatter(bits, idx, valid, mesh, True)


def clear_bits(bits: torch.Tensor, idx, valid, mesh: Mesh):
    """SETBIT 0 batch, in place -> (bits, old_values[K] int32)."""
    return _scatter(bits, idx, valid, mesh, False)


def get_bits(bits: torch.Tensor, idx, valid, mesh: Mesh) -> torch.Tensor:
    """GETBIT batch -> [K] int32 values (0 where not valid)."""
    idx = _on(mesh, idx, torch.int64)
    valid = _on(mesh, valid, torch.bool)
    out = torch.zeros(idx.shape, dtype=torch.int32, device=bits.device)
    for lo, hi in row_blocks(bits.shape[0], mesh):
        mine, safe = _local(idx, valid, lo, hi)
        out += torch.where(mine, bits[lo:hi][safe], 0).to(torch.int32)
    return out


# -- whole-array ops ----------------------------------------------------------


def cardinality_partials(bits: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Per-shard int32 popcount partials (one `popcount_partials` launch
    per shard; each partial is at most 2^18). The cross-shard combine
    happens on the host in int64 (`combine_partials`)."""
    return [pk.popcount_partials(bits[lo:hi])
            for lo, hi in row_blocks(bits.shape[0], mesh)]


def combine_partials(partials) -> int:
    """64-bit exact host combine of the shards' int32 partials."""
    if isinstance(partials, torch.Tensor):
        partials = [partials]
    return int(sum(np.asarray(p.cpu().numpy() if isinstance(p, torch.Tensor)
                              else p, dtype=np.int64).sum()
                   for p in partials))


def cardinality(bits: torch.Tensor, mesh: Mesh) -> int:
    """BITCOUNT: per-shard partials on the device, 64-bit combine on the
    host."""
    return combine_partials(cardinality_partials(bits, mesh))


def _length_parts(bits: torch.Tensor, mesh: Mesh):
    """(highest set INDEX as a Python int, any-set flag): the last shard
    holding a set cell, its last ALLOC_GRAIN block holding one, and the
    last set cell in that block. The +1 happens in Python ints."""
    for lo, hi in reversed(row_blocks(bits.shape[0], mesh)):
        blocks = bits[lo:hi].view(-1, ALLOC_GRAIN).amax(dim=1)
        hit = torch.nonzero(blocks)
        if hit.numel():
            g = int(hit[-1, 0])
            cells = bits[lo + g * ALLOC_GRAIN: lo + (g + 1) * ALLOC_GRAIN]
            j = int(torch.nonzero(cells)[-1, 0])
            return lo + g * ALLOC_GRAIN + j, True
    return 0, False


def length(bits: torch.Tensor, mesh: Mesh) -> int:
    """Highest set bit + 1 (0 if empty): correct up to 2^32 cells."""
    idx, has = _length_parts(bits, mesh)
    return idx + 1 if has else 0


def set_range(bits: torch.Tensor, start: int, last: int, value: bool,
              mesh: Mesh) -> torch.Tensor:
    """Set cells [start, last] INCLUSIVE to `value`, in place (the
    exclusive end of a full 2^32-bit range does not fit uint32, hence the
    inclusive bound JAX keeps; callers guard empty ranges). Each shard
    fills the slice of its view: no index mask over the array."""
    start, stop = int(start), int(last) + 1
    for lo, hi in row_blocks(bits.shape[0], mesh):
        a, b = max(start, lo), min(stop, hi)
        if a < b:
            bits[a:b].fill_(1 if value else 0)
    return bits


def bitop_not(bits: torch.Tensor, last: int, mesh: Mesh) -> torch.Tensor:
    """BITOP NOT over cells [0, last] inclusive, in place; padding cells
    stay 0."""
    stop = int(last) + 1
    for lo, hi in row_blocks(bits.shape[0], mesh):
        b = min(stop, hi)
        if lo < b:
            bits[lo:b].bitwise_xor_(1)
    return bits


def bitop(stack: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """BITOP AND | OR | XOR over [K, n] same-sharded operands -> a fresh
    [n] tensor: one `bitop_cells` launch per shard over its range."""
    out = torch.empty((stack.shape[1],), dtype=torch.uint8, device=stack.device)
    for lo, hi in row_blocks(stack.shape[1], mesh):
        out[lo:hi] = pk.bitop_cells(stack[:, lo:hi], op)
    return out


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


def bloom_add_hashes(bits: torch.Tensor, h1, h2, valid, k: int, m: int,
                     mesh: Mesh, layout: str = "classic"):
    """Set a hashed batch's bits, shard by shard, in place -> (bits, added
    [N] bool), `added` against the batch start (each shard's old cells are
    gathered before its insert; no other shard writes them)."""
    idx = bloom_indexes(h1, h2, valid, k, m, layout)
    flat = idx.reshape(-1)
    vflat = valid[:, None].expand(idx.shape).reshape(-1)
    old = torch.zeros(flat.shape, dtype=torch.int32, device=bits.device)
    for lo, hi in row_blocks(bits.shape[0], mesh):
        view = bits[lo:hi]
        mine, safe = _local(flat, vflat, lo, hi)
        old += torch.where(mine, view[safe], 0).to(torch.int32)
        if uses_segment(hi - lo):
            ingest_kernels.bits_insert_segmented(
                view, torch.where(mine, safe, hi - lo))
        else:
            view.scatter_reduce_(0, safe, mine.to(torch.uint8), reduce="amax")
    added = (old.reshape(idx.shape) == 0).any(dim=-1) & valid
    return bits, added


def bloom_contains_hashes(bits: torch.Tensor, h1, h2, valid, k: int, m: int,
                          mesh: Mesh, layout: str = "classic") -> torch.Tensor:
    """Membership of a hashed batch: each shard gathers the cells it owns,
    the flags sum across shards -> [N] bool."""
    idx = bloom_indexes(h1, h2, valid, k, m, layout)
    flat = idx.reshape(-1)
    vflat = valid[:, None].expand(idx.shape).reshape(-1)
    got = torch.zeros(flat.shape, dtype=torch.int32, device=bits.device)
    for lo, hi in row_blocks(bits.shape[0], mesh):
        mine, safe = _local(flat, vflat, lo, hi)
        got += torch.where(mine, bits[lo:hi][safe], 0).to(torch.int32)
    return (got.reshape(idx.shape) == 1).all(dim=-1) & valid


def _packed_hashes(keys, count: int, seed: int, mesh: Mesh):
    """(h1, h2, valid) of int64 keys (the [n, 2] uint32 layout's bits)."""
    keys = _on(mesh, keys, torch.int64)
    valid = torch.arange(keys.shape[0], device=keys.device) < int(count)
    h1, h2 = hashing.murmur3_x64_128_u64(keys, seed)
    return h1, h2, valid


def _byte_hashes(data, lengths, valid, seed: int, mesh: Mesh):
    h1, h2 = hashing.murmur3_x64_128(_on(mesh, data, torch.uint8),
                                     _on(mesh, lengths, torch.int32), seed)
    return h1, h2, _on(mesh, valid, torch.bool)


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


def grow_bits(bits: torch.Tensor, new_nbits: int, mesh: Mesh) -> torch.Tensor:
    """Enlarge to physical_size(new_nbits), keeping bit positions (the
    SETBIT auto-grow): a new tensor whose shard ranges follow its size."""
    target = physical_size(new_nbits, mesh)
    n = bits.shape[0]
    if target <= n:
        return bits
    out = torch.zeros((target,), dtype=bits.dtype, device=mesh.device)
    out[:n] = bits
    return out


def migrate_bits(bits: torch.Tensor, new_mesh: Mesh) -> torch.Tensor:
    """Re-shard onto a different mesh (topology change / device loss): pad
    to the new mesh's grain; the shard ranges follow the new mesh."""
    n = bits.shape[0]
    target = physical_size(n, new_mesh)
    if target != n:
        return grow_bits(bits, target, new_mesh)
    return bits.to(new_mesh.device)
