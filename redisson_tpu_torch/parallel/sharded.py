"""Sharded HLL bank: [S, m] sketches row-sharded over a logical mesh
(counterpart of `redisson_tpu.parallel.sharded`).

The multi-device design of the JAX package, on logical devices:

  * a bank of S sketches is one [S, m] int32 tensor whose row blocks are
    the mesh entries' shards (S/D rows each; `parallel/mesh.py`), so every
    insert touches exactly one shard's rows;
  * inserts take a replicated key batch plus a per-key target row; each
    shard masks the keys routed to its row range and folds them into its
    own rows through the `seg_insert` kernel's multi-target form
    (`ingest.kernels.hll_insert_segmented_rows`), the body JAX runs inside
    `shard_map` once per device;
  * whole-bank PFMERGE = each shard's row-max (the `merge_stack` kernel over
    its block) and then the max over the D partials, which stands in for
    JAX's `lax.pmax` over the shard axis.

Where JAX donates the bank, the port writes it in place and returns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ops import hashing, hll
from redisson_tpu_torch.ops import kernels as pk
from redisson_tpu_torch.parallel.mesh import Mesh, row_blocks


def _on(mesh: Mesh, arr, dtype=None) -> torch.Tensor:
    """A replicated operand (numpy or tensor) on the mesh's device."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    t = torch.as_tensor(arr).to(mesh.device)
    return t if dtype is None else t.to(dtype)


def make_bank(mesh: Mesh, num_sketches: int, m: int = hll.M) -> torch.Tensor:
    """Zero-initialized sharded [S, m] bank."""
    ndev = mesh.size
    if num_sketches % ndev != 0:
        raise ValueError(f"num_sketches {num_sketches} not divisible by {ndev} devices")
    return torch.zeros((num_sketches, m), dtype=torch.int32, device=mesh.device)


def h1_of(hi, lo, mesh: Mesh, seed: int = 0,
          pre_hashed: bool = False) -> torch.Tensor:
    """The murmur3 h1 (int64) of a (hi, lo) uint32 lane batch: the raw u64
    key hashed on the device, or the lanes taken as an already computed h1
    (`pre_hashed`, what byte keys arrive as)."""
    hi = _on(mesh, hi).to(torch.int64) & 0xFFFFFFFF
    lo = _on(mesh, lo).to(torch.int64) & 0xFFFFFFFF
    key = (hi << 32) | lo
    if pre_hashed:
        return key
    return hashing.murmur3_x64_128_u64(key, seed)[0]


def bank_insert_h1(bank: torch.Tensor, h1: torch.Tensor, row, valid,
                   mesh: Mesh):
    """Fold h1 hashes into their target rows, shard by shard, in place ->
    (bank, changed_rows[S] bool). Each shard's body (JAX's `_insert_local`)
    masks the pairs routed to its rows and runs one multi-target
    segmented insert over its block of the bank."""
    s, m = bank.shape
    bucket, rank = hll.bucket_rank(h1, hll.p_of(m))
    row = _on(mesh, row, torch.int32)
    valid = _on(mesh, valid, torch.bool)
    rank = torch.where(valid, rank, 0)
    changed = torch.zeros((s,), dtype=torch.bool, device=bank.device)
    for lo, hi in row_blocks(s, mesh):
        mine = valid & (row >= lo) & (row < hi)
        local_row = torch.where(mine, row - lo, 0).to(torch.int32)
        local_rank = torch.where(mine, rank, 0).to(torch.int32)
        ingest_kernels.hll_insert_segmented_rows(
            bank[lo:hi], bucket, local_rank, local_row, changed[lo:hi])
    return bank, changed


def bank_insert(bank: torch.Tensor, hi, lo, row, valid, mesh: Mesh,
                seed: int = 0, pre_hashed: bool = False):
    """Insert a replicated key batch into the sharded bank -> (bank,
    changed_rows[S]): per-row change flags vs the pre-batch state
    (`changed_rows.any()` is the whole-batch bool)."""
    return bank_insert_h1(bank, h1_of(hi, lo, mesh, seed, pre_hashed), row,
                          valid, mesh)


def _partials(bank: torch.Tensor, mesh: Mesh):
    """Each shard's row-max over its block: one merge_stack per shard."""
    return [pk.merge_stack(bank[lo:hi])
            for lo, hi in row_blocks(bank.shape[0], mesh)]


def combine_max(parts) -> torch.Tensor:
    """The cross-shard combine of [m] partials (JAX's pmax)."""
    if len(parts) == 1:
        return parts[0]
    return torch.stack(parts).amax(dim=0)


def bank_merge_all(bank: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """PFMERGE across every sketch in the bank -> [m] merged registers."""
    return combine_max(_partials(bank, mesh))


def bank_count_all(bank: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Union cardinality of the whole bank (merge + count, no mutation)."""
    return hll.count(bank_merge_all(bank, mesh))


def bank_count_row(bank: torch.Tensor, row: int) -> torch.Tensor:
    """Cardinality of one sketch row."""
    return hll.count(bank[int(row)])


def _rows(rows) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(rows, np.int32))


def bank_count_rows_merged(bank: torch.Tensor, rows,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Union count over a row subset (rows may repeat): merge_stack's
    row-list form, read in place."""
    return hll.count(pk.merge_stack(bank, _rows(rows)))


def bank_merge_rows(bank: torch.Tensor, rows, target: int) -> torch.Tensor:
    """PFMERGE `rows` (the caller includes `target`) into row `target`, in
    place."""
    bank[int(target)] = pk.merge_stack(bank, _rows(rows))
    return bank


def bank_merge_count_rows(bank: torch.Tensor, rows, target: int):
    """Fused PFMERGE + PFCOUNT: fold `rows` (incl. `target`) into row
    `target` in place -> (bank, estimate)."""
    merged = pk.merge_stack(bank, _rows(rows))
    bank[int(target)] = merged
    return bank, hll.count(merged)


def bank_absorb_host(bank: torch.Tensor, host_u8, mesh: Mesh) -> torch.Tensor:
    """Max-merge a host-folded [S, m] uint8 bank mirror into the sharded
    bank, in place."""
    torch.maximum(bank, _on(mesh, host_u8, torch.int32), out=bank)
    return bank


def zero_row(bank: torch.Tensor, row: int) -> torch.Tensor:
    """Reset one sketch row (pod-mode DEL of an HLL), in place."""
    bank[int(row)] = 0
    return bank


def grow_bank(bank: torch.Tensor, new_capacity: int, mesh: Mesh) -> torch.Tensor:
    """Enlarge [S, m] -> [S', m] keeping row indices (a new tensor on the
    mesh's device; the row blocks follow the new capacity)."""
    s, m = bank.shape
    if new_capacity < s:
        raise ValueError(f"cannot shrink {s} -> {new_capacity}")
    if new_capacity == s:
        return bank
    out = torch.zeros((new_capacity, m), dtype=bank.dtype, device=mesh.device)
    out[:s] = bank
    return out


def migrate_bank(bank: torch.Tensor, new_mesh: Mesh) -> torch.Tensor:
    """Re-shard the bank onto a different mesh (topology change): the row
    blocks follow the new mesh; the tensor moves only if the new mesh's
    device differs."""
    if bank.shape[0] % new_mesh.size:
        raise ValueError(
            f"bank rows {bank.shape[0]} not divisible by "
            f"{new_mesh.size} devices")
    return bank.to(new_mesh.device)


def full_step(bank: torch.Tensor, hi, lo, row, valid, mesh: Mesh,
              seed: int = 0):
    """One complete step: sharded insert, then the global merge-count."""
    bank, _ = bank_insert(bank, hi, lo, row, valid, mesh, seed)
    return bank, bank_count_all(bank, mesh)
