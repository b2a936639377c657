"""Sharded HLL bank: [S, m] sketches row-sharded over a logical mesh
(counterpart of `redisson_tpu.parallel.sharded`). The pod's bank and the
mesh data plane's share these functions.

The multi-device design of the JAX package, on the mesh's entries:

  * a bank of S sketches is a `mesh.Sharded` whose block i, S/D rows, is a
    tensor of its own on entry i's device (JAX's `P("shards", None)`), so
    every insert touches exactly one block's rows;
  * inserts take a key batch plus a per-key target row. The batch is
    hashed ONCE, on the mesh's home (entry 0's device), and the hashes go
    to every block's card by peer copy (JAX replicates the chunk with
    `device_put` and hashes it on every device; here the staged chunk
    crosses the host link once, to home, NVLink is far wider than each
    card's host link, and the hash runs once). Each block masks the keys
    routed to its rows
    and folds them through the `seg_insert` kernel's multi-target form
    (`ingest.kernels.hll_insert_segmented_rows`) on its own card: the body
    JAX runs inside `shard_map` once per device;
  * whole-bank PFMERGE = each block's row-max (the `merge_stack` kernel on
    its card), then the [m] partials peer-copied to home and max-combined
    there: JAX's `lax.pmax` over the shard axis;
  * work that mixes bank rows with state on home (a mesh-plane tape window
    or delta chunk, whose BitSet and Bloom cells live in the store there)
    gathers its rows to home (`rows_u8`) and writes them back block by
    block (`set_rows`), peer copies both ways.

Where JAX donates the bank, the port writes it in place and returns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ops import hashing, hll
from redisson_tpu_torch.ops import kernels as pk
from redisson_tpu_torch.parallel.mesh import (
    Mesh, Sharded, bank_sharding, on_home, replicate)


def make_bank(mesh: Mesh, num_sketches: int, m: int = hll.M) -> Sharded:
    """Zero-initialized sharded [S, m] bank: one zero block per entry."""
    ndev = mesh.size
    if num_sketches % ndev != 0:
        raise ValueError(f"num_sketches {num_sketches} not divisible by {ndev} devices")
    return bank_sharding(mesh, mesh.axis).zeros((num_sketches, m), torch.int32)


def h1_of(hi, lo, mesh: Mesh, seed: int = 0,
          pre_hashed: bool = False) -> torch.Tensor:
    """The murmur3 h1 (int64, on the mesh's home) of a (hi, lo) uint32
    lane batch: the raw u64 key hashed on home, or the lanes taken as an
    already computed h1 (`pre_hashed`, what byte keys arrive as)."""
    hi = on_home(mesh, hi).to(torch.int64) & 0xFFFFFFFF
    lo = on_home(mesh, lo).to(torch.int64) & 0xFFFFFFFF
    key = (hi << 32) | lo
    if pre_hashed:
        return key
    return hashing.murmur3_x64_128_u64(key, seed)[0]


def bank_insert_h1(bank: Sharded, h1, row, valid, mesh: Mesh):
    """Fold h1 hashes into their target rows, block by block, in place ->
    (bank, changed_rows): a `Sharded` [S] bool whose blocks stay on their
    cards until read. Bucket and rank are computed once on home; each
    block's body (JAX's `_insert_local`) receives them with the row list
    by peer copy, masks the pairs routed to its rows and runs one
    multi-target segmented insert on its own card."""
    m = bank.shape[1]
    h1 = on_home(mesh, h1)
    bucket, rank = hll.bucket_rank(h1, hll.p_of(m))
    row = on_home(mesh, row, torch.int32)
    rank = torch.where(on_home(mesh, valid, torch.bool), rank, 0).to(torch.int32)
    ops = zip(*(replicate(mesh, t) for t in (bucket.to(torch.int32), rank, row)))
    changed = []
    for (lo, hi), block, (b, r, w) in zip(bank.ranges(), bank.blocks, ops):
        mine = (w >= lo) & (w < hi)
        flags = torch.zeros((hi - lo,), dtype=torch.bool, device=block.device)
        ingest_kernels.hll_insert_segmented_rows(
            block, b, torch.where(mine, r, 0), torch.where(mine, w - lo, 0), flags)
        changed.append(flags)
    return bank, Sharded(mesh, changed)


def bank_insert(bank: Sharded, hi, lo, row, valid, mesh: Mesh,
                seed: int = 0, pre_hashed: bool = False):
    """Insert a key batch into the sharded bank -> (bank, changed_rows):
    per-row change flags vs the pre-batch state (`np.asarray(changed_rows)`
    is the [S] vector)."""
    return bank_insert_h1(bank, h1_of(hi, lo, mesh, seed, pre_hashed), row,
                          valid, mesh)


def changed_on_home(parts) -> torch.Tensor:
    """The read of insert flags: the chunks' `Sharded` flags OR-ed block
    by block on their cards, then the blocks peer-copied to home ->
    one [S] bool."""
    blocks = [torch.stack(col).any(dim=0) if len(col) > 1 else col[0]
              for col in zip(*(p.blocks for p in parts))]
    home = parts[0].mesh.home
    return torch.cat([b.to(home) for b in blocks])


def combine_max(parts, home: Optional[torch.device] = None) -> torch.Tensor:
    """The cross-shard combine of [m] partials (JAX's pmax): each partial
    peer-copied to `home` (default: the first partial's device), then a
    max there."""
    home = parts[0].device if home is None else home
    if len(parts) == 1:
        return parts[0].to(home)
    return torch.stack([p.to(home) for p in parts]).amax(dim=0)


def bank_merge_all(bank: Sharded, mesh: Mesh) -> torch.Tensor:
    """PFMERGE across every sketch in the bank -> [m] merged registers on
    the mesh's home: each block's row-max (one merge_stack on its card),
    then the combine."""
    return combine_max([pk.merge_stack(block) for block in bank.blocks], mesh.home)


def bank_count_all(bank: Sharded, mesh: Mesh) -> torch.Tensor:
    """Union cardinality of the whole bank (merge + count, no mutation)."""
    return hll.count(bank_merge_all(bank, mesh))


def bank_count_row(bank: Sharded, row: int) -> torch.Tensor:
    """Cardinality of one sketch row, on its block's card."""
    return hll.count(bank.row(int(row)))


def _by_block(bank: Sharded, rows):
    """(block, positions in `rows`, local rows) for every block that holds
    some of the global `rows` (host ints)."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    if rows.size and (rows.min() < 0 or rows.max() >= len(bank)):
        raise IndexError(f"row outside [0, {len(bank)})")
    for (lo, hi), block in zip(bank.ranges(), bank.blocks):
        at = np.nonzero((rows >= lo) & (rows < hi))[0]
        if at.size:
            yield block, at, rows[at] - lo


def _on(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(idx).to(device, non_blocking=True)


def fold_rows(bank: Sharded, rows) -> torch.Tensor:
    """Max over the listed rows (they may repeat and span blocks) -> [m]
    on home: one merge_stack row-list launch per block that holds some,
    each on its card, then the partials' combine."""
    parts = [pk.merge_stack(block, local.astype(np.int32))
             for block, _at, local in _by_block(bank, rows)]
    home = bank.mesh.home
    if not parts:
        return torch.zeros((bank.shape[1],), dtype=bank.dtype, device=home)
    return combine_max(parts, home)


def bank_count_rows_merged(bank: Sharded, rows,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Union count over a row subset (rows may repeat)."""
    return hll.count(fold_rows(bank, rows))


def bank_merge_rows(bank: Sharded, rows, target: int) -> Sharded:
    """PFMERGE `rows` (the caller includes `target`) into row `target`, in
    place: the merged registers written into the target's block."""
    bank.row(int(target)).copy_(fold_rows(bank, rows))
    return bank


def bank_merge_count_rows(bank: Sharded, rows, target: int):
    """Fused PFMERGE + PFCOUNT: fold `rows` (incl. `target`) into row
    `target` in place -> (bank, estimate)."""
    merged = fold_rows(bank, rows)
    bank.row(int(target)).copy_(merged)
    return bank, hll.count(merged)


def bank_absorb_host(bank: Sharded, host_u8, mesh: Mesh) -> Sharded:
    """Max-merge a host-folded [S, m] uint8 bank mirror (what
    `native.hll_fold_u64_rows` folds) into the sharded bank, in place:
    each block takes its slice of the mirror."""
    host = torch.from_numpy(np.ascontiguousarray(host_u8))
    if tuple(host.shape) != tuple(bank.shape):
        raise ValueError(f"mirror {tuple(host.shape)} for a bank {bank.shape}")
    for (lo, hi), block in zip(bank.ranges(), bank.blocks):
        torch.maximum(block, host[lo:hi].to(block.device).to(torch.int32), out=block)
    return bank


def zero_row(bank: Sharded, row: int) -> Sharded:
    """Reset one sketch row (pod-mode DEL of an HLL), in place."""
    bank.row(int(row)).zero_()
    return bank


def rows_u8(bank: Sharded, rows) -> torch.Tensor:
    """The registers of the global `rows` (host ints, any blocks, may
    repeat) as [R, m] uint8 images on home, in request order: each block
    gathers its rows on its card and narrows them to uint8 there
    (registers are 0..64, lossless), and the images travel to home by
    peer copy."""
    home = bank.mesh.home
    rows = np.asarray(rows, np.int64).reshape(-1)
    out = torch.empty((rows.size, bank.shape[1]), dtype=torch.uint8, device=home)
    for block, at, local in _by_block(bank, rows):
        out[_on(at, home)] = block[_on(local, block.device)].to(torch.uint8).to(home)
    return out


def set_rows(bank: Sharded, regs_u8: torch.Tensor, rows) -> Sharded:
    """Overwrite the global `rows` (host ints; a repeat must carry the same
    registers) with the [R, m] uint8 images `regs_u8` (on any device), in
    place: each block's images go to its card by peer copy and widen to
    int32 there."""
    for block, at, local in _by_block(bank, rows):
        src = regs_u8[_on(at, regs_u8.device)].to(block.device)
        block[_on(local, block.device)] = src.to(block.dtype)
    return bank


def copy_row(bank: Sharded, src: int, dst: int) -> Sharded:
    """Row `dst` takes row `src`'s registers, in place, wherever their
    blocks lie (a peer copy between their cards)."""
    bank.row(int(dst)).copy_(bank.row(int(src)))
    return bank


def absorb_rows(bank: Sharded, regs_u8: torch.Tensor, rows):
    """Max-merge folded sketches `regs_u8` [R, m] (on any device) into the
    global `rows` (host ints, may repeat), in place -> (bank, changed [R]
    bool on home): each block takes its sketches on its card, and a
    sketch's flag says whether it raised a register of its row's state
    before this call."""
    home, m = bank.mesh.home, bank.shape[1]
    changed = torch.zeros((len(rows),), dtype=torch.bool, device=home)
    for block, at, local in _by_block(bank, rows):
        f = regs_u8[_on(at, regs_u8.device)].to(block.device).to(block.dtype)
        idx = _on(local, block.device)
        changed[_on(at, home)] = (f > block[idx]).any(dim=1).to(home)
        cells = idx[:, None] * m + torch.arange(m, device=block.device)
        block.view(-1).scatter_reduce_(0, cells.reshape(-1), f.reshape(-1),
                                       reduce="amax")
    return bank, changed


def occupancy(bank: Sharded) -> torch.Tensor:
    """Non-empty rows of the whole bank (the DBSIZE analogue): each block
    counts its own on its card, and the partials are summed in int64 on
    home (JAX's psum)."""
    home = bank.mesh.home
    return torch.stack([(b != 0).any(dim=1).sum(dtype=torch.int64).to(home)
                        for b in bank.blocks]).sum()


def grow_bank(bank: Sharded, new_capacity: int, mesh: Mesh) -> Sharded:
    """Enlarge [S, m] -> [S', m] keeping row indices. As in JAX the blocks
    follow the new capacity (S'/D rows each), so an existing row can move
    to another entry, and another card: it is copied to the block that now
    holds its index."""
    s = len(bank)
    if new_capacity < s:
        raise ValueError(f"cannot shrink {s} -> {new_capacity}")
    if new_capacity == s:
        return bank
    return bank_sharding(mesh, mesh.axis).put(bank, new_capacity)


def migrate_bank(bank: Sharded, new_mesh: Mesh) -> Sharded:
    """Re-shard the bank onto a different mesh (topology change): rows go
    to the new mesh's blocks, moving between cards where the entries'
    devices differ."""
    if len(bank) % new_mesh.size:
        raise ValueError(
            f"bank rows {len(bank)} not divisible by "
            f"{new_mesh.size} devices")
    if new_mesh == bank.mesh:
        return bank
    return bank_sharding(new_mesh, new_mesh.axis).put(bank)


def full_step(bank: Sharded, hi, lo, row, valid, mesh: Mesh, seed: int = 0):
    """One complete step: sharded insert, then the global merge-count."""
    bank, _ = bank_insert(bank, hi, lo, row, valid, mesh, seed)
    return bank, bank_count_all(bank, mesh)
