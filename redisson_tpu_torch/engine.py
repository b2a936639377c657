"""Device entry points of the sketch engine (counterpart of
`redisson_tpu.engine`: the HLL half, lines 35-430, and the BitSet / Bloom
half, lines 689-907).

Each function is the work of one device call of a microbatch: hash ->
bucket/rank -> insert, with a validity mask so the executor can pad batches
to bucket sizes (padded lanes carry rank 0, a no-op under max).

Where JAX donated its state argument, the port updates the tensor in place
and returns it: a PFADD or PFMERGE writes its bank row (or register array)
where it lies, and never holds two bank-sized buffers. The insert itself
writes a fresh row first, so the PFADD "changed" flag keeps JAX's meaning
(any register raised by this batch). Reads that leave the bank
(`hll_bank_row`, for export) clone.

Every named HLL is a row of one `[S, m]` int32 bank: multi-sketch PFMERGE
and PFCOUNT are one row-max over an index vector. The bank is one tensor,
or, on the cluster's mesh data plane, a `parallel.mesh.Sharded` whose
blocks lie on the mesh entries' devices: every `hll_bank_*` function takes
either, and hands a `Sharded` to the blocked-bank functions of
`parallel/sharded.py` (the pod's), which work block by block on each
block's card and meet on the mesh's home. The hand-written kernels
are the segmented insert (`ingest="segment"`; a multi-target run takes its
multi-target form, one launch per chunk) and `merge_stack`
(`hll_merge_stack`, `hll_count_merged`, and the bank merges, which it reads
in place through the index vector). The mesh collectives (`engine.py:446-563`
of the JAX package) fold each shard's rows of a mesh-sharded bank with
`merge_stack` and combine the partials by a max (JAX's pmax).

BitSet and Bloom state is an [m] uint8 cell tensor (`ops/bitset.py`).
SETBIT, CLEAR and the Bloom scatter add write it in place (JAX donates
it); the segment-OR add (`ingest="segment"`) returns a fresh tensor, like
the kernel, and the backend installs whichever comes back. The hand
kernels of this half: `popcount_partials` (BITCOUNT), `bitop_cells`
(BITOP) and `bits_insert_segmented` (the segment-OR).

The delta half (`engine.py:564-686` of the JAX package): the Bloom host
mirror's pack / absorb, and the device side of the delta / tape ingest,
whose hand kernels are `delta_merge` (`delta_merge_stack`) and
`window_merge` (`tape_apply`). Both merge in place into a window's stack of
old rows, where JAX donated it.
"""

from __future__ import annotations

import numpy as np
import torch

from redisson_tpu_torch.ops import bitset, bloom, hashing, hll
from redisson_tpu_torch.ops import kernels as pk
from redisson_tpu_torch.ops import window_kernel as wk
from redisson_tpu_torch.parallel import sharded
from redisson_tpu_torch.parallel.mesh import Sharded

# Batch-size buckets: powers of two between MIN_BUCKET and MAX_BUCKET keys.
MIN_BUCKET = 1 << 10
MAX_BUCKET = 1 << 21


def bucket_size(n: int) -> int:
    b = MIN_BUCKET
    while b < n and b < MAX_BUCKET:
        b <<= 1
    return b


def chunk_spans(n: int, chunk: int = None):
    """[0, n) split into device-call-sized spans."""
    if chunk is None:
        chunk = MAX_BUCKET  # read at call time (tests shrink it)
    return [(s, min(s + chunk, n)) for s in range(0, max(n, 1), chunk)] if n else []


def pad_bytes(data, lengths):
    """Pad an [N, W] byte batch + lengths to (bucket, W) with a valid mask."""
    n = data.shape[0]
    b = bucket_size(n)
    if n == b:
        return data, lengths, np.ones((b,), bool)
    pdata = np.zeros((b, data.shape[1]), np.uint8)
    pdata[:n] = data
    plengths = np.zeros((b,), np.int32)
    plengths[:n] = lengths
    valid = np.zeros((b,), bool)
    valid[:n] = True
    return pdata, plengths, valid


def pad_rows(arr):
    """Pad [n, ...] rows to the bucket size along axis 0 -> (padded, n)."""
    n = arr.shape[0]
    b = bucket_size(n)
    if n == b:
        return arr, n
    out = np.zeros((b,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    return out, n


def pad_ints(arr, fill=0):
    n = arr.shape[0]
    b = bucket_size(n)
    if n == b:
        return arr, np.ones((b,), bool)
    out = np.full((b,) + arr.shape[1:], fill, arr.dtype)
    out[:n] = arr
    valid = np.zeros((b,), bool)
    valid[:n] = True
    return out, valid


def pad_rows_repeat(rows):
    """Pad a row-index vector to the next power of two by repeating the
    first element (repeats are idempotent under max)."""
    n = rows.shape[0]
    b = 1 << max(0, int(n - 1).bit_length())
    if n == b:
        return rows
    out = np.full((b,), rows[0], rows.dtype)
    out[:n] = rows
    return out


def _index(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device).long()
    return torch.as_tensor(np.asarray(rows), device=device).long()


# ---------------------------------------------------------------------------
# HLL
# ---------------------------------------------------------------------------


def _hll_h1_u64(x: torch.Tensor, seed: int, family: str) -> torch.Tensor:
    """The HLL hash of int64 keys (8-byte LE) by family: 'm3' = murmur3 x64
    128 low half; 'redis' = MurmurHash64A (0xadc83b19)."""
    if family == "redis":
        return hashing.murmur2_64a_u64(x)
    return hashing.murmur3_x64_128_u64(x, seed)[0]


def _hll_h1_bytes(data, lengths, seed: int, family: str) -> torch.Tensor:
    if family == "redis":
        return hashing.murmur2_64a(data, lengths)
    return hashing.murmur3_x64_128(data, lengths, seed)[0]


def _insert_impl(regs, bucket, rank, valid, impl):
    """One register-array insert by strategy, as a fresh tensor: 'scatter'
    (scatter_reduce amax) or 'sort' (sort-compress + small scatter). Padded
    lanes carry rank 0. ('segment' inserts in place: `_segment_insert`.)"""
    if impl == "scatter":
        return hll.insert_scatter(regs, bucket, rank)
    bucket = torch.where(valid, bucket, 0)
    return hll.insert_sorted(regs, bucket, rank)


def _segment_insert(regs, bucket, rank, changed):
    """`ingest="segment"`: the in-place segmented insert (the CUDA kernel; its
    plain version on the CPU) writes PFADD's flag into `changed`, one bool
    element. Padded lanes carry rank 0, whatever their bucket."""
    from redisson_tpu_torch.ingest import kernels as ingest_kernels

    ingest_kernels.hll_insert_segmented(regs, bucket, rank, changed)


def _valid_prefix(n: int, count: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < count


def _hll_add(regs, h1, valid, impl):
    bucket, rank = hll.bucket_rank(h1, hll.p_of(regs.shape[0]))
    rank = torch.where(valid, rank, 0)
    if impl == "segment":
        changed = torch.zeros((), dtype=torch.bool, device=regs.device)
        _segment_insert(regs, bucket, rank, changed)
        return regs, changed
    new = _insert_impl(regs, bucket, rank, valid, impl)
    changed = (new != regs).any()
    regs.copy_(new)  # in place: the JAX version donates regs
    return regs, changed


def hll_add_bytes(regs, data, lengths, valid, impl: str = "scatter",
                  seed: int = 0, family: str = "m3"):
    """PFADD of a padded byte-key batch into `regs` (in place) ->
    (regs, changed)."""
    return _hll_add(regs, _hll_h1_bytes(data, lengths, seed, family), valid, impl)


def hll_add_packed(regs, packed, count: int, impl: str = "scatter",
                   seed: int = 0, family: str = "m3"):
    """PFADD of int64 keys (`packed`, the bits of the JAX package's [n, 2]
    uint32 layout), the first `count` lanes valid."""
    valid = _valid_prefix(packed.shape[0], count, packed.device)
    return _hll_add(regs, _hll_h1_u64(packed, seed, family), valid, impl)


def join_u64(hi, lo) -> torch.Tensor:
    """The JAX package's (hi, lo) uint32 lanes -> one int64 key tensor."""
    hi = torch.as_tensor(hi).to(torch.int64) & 0xFFFFFFFF
    lo = torch.as_tensor(lo).to(torch.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


def hll_add_u64(regs, hi, lo, valid, impl: str = "scatter", seed: int = 0,
                family: str = "m3"):
    """PFADD of a padded batch of 64-bit keys given as uint32 (hi, lo)
    lanes (the 8-byte LE fast path), into `regs` in place."""
    return _hll_add(regs, _hll_h1_u64(join_u64(hi, lo), seed, family), valid,
                    impl)


def hll_absorb(regs, folded_u8):
    """Merge a host-folded uint8 sketch into the registers, in place ->
    (regs, changed)."""
    f = folded_u8.to(regs.dtype)
    changed = (f > regs).any()
    torch.maximum(regs, f, out=regs)
    return regs, changed


def hll_count(regs):
    return hll.count(regs)


def hll_merge(dst, src):
    return torch.maximum(dst, src)


def hll_merge_all(arrays):
    """Merge a python list of register arrays (one stacked reduce)."""
    if len(arrays) == 1:
        return arrays[0]
    if len(arrays) == 2:
        return hll_merge(arrays[0], arrays[1])
    return hll_merge_stack(torch.stack(arrays))


def hll_merge_stack(stack):
    """PFMERGE over an [S, m] stack (the merge_stack kernel on a card)."""
    return pk.merge_stack(stack)


def hll_count_merged(stack):
    """Count over [S, m] stacked sketches without mutating them."""
    return hll.count(hll_merge_stack(stack))


# ---------------------------------------------------------------------------
# HLL bank: named sketches as rows of ONE [S, m] bank (a tensor, or a
# `Sharded` on the mesh data plane).
# ---------------------------------------------------------------------------


def hll_bank_make(capacity: int, m: int = None, device=None) -> torch.Tensor:
    return torch.zeros((capacity, hll.M if m is None else m),
                       dtype=torch.int32, device=device)


def _bank_add(bank, h1, rows, valid, impl: str = "scatter"):
    """Multi-target insert, in place: key i raises bank row rows[i]. Returns
    (bank, changed_rows[S]). A blocked bank takes the pod's per-block
    insert whatever `impl` (the segmented kernel's multi-target form on
    each block's card, JAX's `_insert_local`), its flags read into one [S]
    bool on home. Under 'segment' the segmented kernel's
    multi-target form folds the whole chunk in one launch and sets the
    flags; otherwise the flat scatter at row*m + bucket (JAX's path), where
    a row changed iff some key's rank exceeds the register it lands on
    (gathered before the scatter): the same flag as JAX's whole-bank row
    compare, without a bank-sized copy."""
    if isinstance(bank, Sharded):
        bank, changed = sharded.bank_insert_h1(bank, h1, rows, valid, bank.mesh)
        return bank, sharded.changed_on_home([changed])
    s, m = bank.shape
    bucket, rank = hll.bucket_rank(h1, hll.p_of(m))
    rank = torch.where(valid, rank, 0)  # padded lanes never raise
    if impl == "segment":
        from redisson_tpu_torch.ingest import kernels as ingest_kernels

        changed_rows = torch.zeros(s, dtype=torch.bool, device=bank.device)
        ingest_kernels.hll_insert_segmented_rows(bank, bucket, rank, rows, changed_rows)
        return bank, changed_rows
    rows = torch.where(valid, rows.long(), 0)
    idx = rows * m + bucket
    flat = bank.view(-1)
    raised = (rank > flat[idx]).to(torch.int32)
    changed_rows = torch.zeros(s, dtype=torch.int32, device=bank.device)
    changed_rows.scatter_reduce_(0, rows, raised, reduce="amax")
    flat.scatter_reduce_(0, idx, rank, reduce="amax")
    return bank, changed_rows > 0


def _bank_add_row(bank, h1, row: int, valid, impl: str = "scatter"):
    """Single-target insert into bank row `row`, in place. Returns (bank,
    changed_rows[S]). Under 'segment' the kernel folds into the row and
    writes its flag itself; the other strategies insert into a fresh row
    and write it back. A blocked bank runs it on the row's block, on its
    card."""
    if isinstance(bank, Sharded):
        b, j = bank.locate(row)
        block = bank.blocks[b]
        _, flags = _bank_add_row(block, h1.to(block.device), j,
                                 valid.to(block.device), impl)
        changed_rows = torch.zeros(len(bank), dtype=torch.bool, device=h1.device)
        changed_rows[row:row + 1] = flags[j:j + 1].to(h1.device)
        return bank, changed_rows
    s, m = bank.shape
    bucket, rank = hll.bucket_rank(h1, hll.p_of(m))
    rank = torch.where(valid, rank, 0)
    old_row = bank[row]
    changed_rows = torch.zeros(s, dtype=torch.bool, device=bank.device)
    if impl == "segment":
        _segment_insert(old_row, bucket, rank, changed_rows[row:row + 1])
        return bank, changed_rows
    new_row = _insert_impl(old_row, bucket, rank, valid, impl)
    changed_rows[row] = (new_row != old_row).any()
    old_row.copy_(new_row)
    return bank, changed_rows


def hll_bank_add_packed(bank, packed, count: int, row: int, seed: int = 0,
                        family: str = "m3", impl: str = "scatter"):
    """Single-target PFADD of int64 keys into bank row `row`."""
    valid = _valid_prefix(packed.shape[0], count, packed.device)
    return _bank_add_row(bank, _hll_h1_u64(packed, seed, family), row, valid, impl)


def hll_bank_add_packed_rows(bank, packed, rows, count: int, seed: int = 0,
                             family: str = "m3"):
    """Multi-target PFADD: per-key target row (cross-sketch coalesced run)."""
    valid = _valid_prefix(packed.shape[0], count, packed.device)
    return _bank_add(bank, _hll_h1_u64(packed, seed, family), rows, valid)


def hll_bank_add_u64(bank, hi, lo, valid, row: int, seed: int = 0,
                     family: str = "m3", impl: str = "scatter"):
    """Single-target PFADD of (hi, lo) keys into bank row `row`."""
    return _bank_add_row(bank, _hll_h1_u64(join_u64(hi, lo), seed, family),
                         row, valid, impl)


def hll_bank_add_u64_rows(bank, hi, lo, rows, valid, seed: int = 0,
                          family: str = "m3", impl: str = "scatter"):
    """Multi-target PFADD of (hi, lo) keys (per-key target row); `impl`
    'segment' takes the segmented kernel's multi-target form, any other
    the flat scatter."""
    return _bank_add(bank, _hll_h1_u64(join_u64(hi, lo), seed, family), rows,
                     valid, impl)


def hll_bank_add_bytes(bank, data, lengths, valid, row: int, seed: int = 0,
                       family: str = "m3", impl: str = "scatter"):
    """Single-target byte-key PFADD into bank row `row`."""
    return _bank_add_row(bank, _hll_h1_bytes(data, lengths, seed, family), row,
                         valid, impl)


def hll_bank_add_bytes_rows(bank, data, lengths, rows, valid, seed: int = 0,
                            family: str = "m3", impl: str = "scatter"):
    """Multi-target byte-key PFADD (per-key target row, int32); `impl`
    'segment' takes the segmented kernel, any other the flat scatter."""
    return _bank_add(bank, _hll_h1_bytes(data, lengths, seed, family), rows, valid,
                     impl)


def _row(bank, row: int):
    """The view of one bank row (in its block, for a blocked bank)."""
    return bank.row(row) if isinstance(bank, Sharded) else bank[row]


def hll_bank_row(bank, row: int):
    """One row's registers as a fresh tensor (export/snapshot: independent
    of later in-place inserts), on the row's device."""
    return _row(bank, row).clone()


def hll_bank_count(bank, row: int):
    return hll.count(_row(bank, row))


def _merged_rows(bank, rows):
    """Max over a row subset (rows may repeat), read from the bank in place
    by merge_stack; JAX gathers the rows and reduces them with jnp.max. The
    list stays on the host: on a card it reaches the kernel by value (no
    allocation, no host-to-device copy per merge). A blocked bank folds
    each block's rows on its card and combines the partials on home."""
    if isinstance(bank, Sharded):
        return sharded.fold_rows(bank, rows)
    return pk.merge_stack(bank, np.asarray(rows, np.int32))


def hll_bank_count_rows(bank, rows):
    """Union count over a row subset (countWith); `rows` may repeat."""
    return hll.count(_merged_rows(bank, rows))


def hll_bank_merge_rows(bank, rows, target: int):
    """PFMERGE rows (the caller includes `target` in `rows`) into row
    `target`, in place."""
    _row(bank, target).copy_(_merged_rows(bank, rows))
    return bank


def hll_bank_merge_count_rows(bank, rows, target: int):
    """Fused PFMERGE + PFCOUNT: fold `rows` into row `target` (in place) and
    estimate the merged cardinality -> (bank, estimate)."""
    merged = _merged_rows(bank, rows)
    _row(bank, target).copy_(merged)
    return bank, hll.count(merged)


def hll_bank_absorb_rows(bank, regs_u8, rows):
    """Max-merge folded sketches [R, m] into bank rows [R] (rows may repeat),
    in place -> (bank, changed[R]) with one flag per source sketch."""
    if isinstance(bank, Sharded):
        return sharded.absorb_rows(bank, regs_u8, rows)
    s, m = bank.shape
    f = regs_u8.to(torch.int32)
    rows = _index(rows, bank.device)
    idx = (rows[:, None] * m + torch.arange(m, device=bank.device)[None, :])
    flat = bank.view(-1)
    changed = (f > flat[idx]).any(dim=1)
    flat.scatter_reduce_(0, idx.reshape(-1), f.reshape(-1), reduce="amax")
    return bank, changed


def hll_bank_set_row(bank, regs, row: int):
    """Overwrite one row (hll_import / restore), in place."""
    _row(bank, row).copy_(regs.to(torch.int32))
    return bank


def hll_bank_rows_u8(bank, rows):
    """Bank rows as uint8 register images (registers are 0..64, lossless),
    [R, m] in request order; from a blocked bank, on the mesh's home
    (`rows` then host ints)."""
    if isinstance(bank, Sharded):
        return sharded.rows_u8(bank, rows)
    return bank[_index(rows, bank.device)].to(torch.uint8)


def hll_bank_set_rows(bank, regs_u8, rows):
    """Overwrite bank rows [R] (unique) with [R, m] uint8 images, in place;
    a blocked bank writes each block's rows on its card."""
    if isinstance(bank, Sharded):
        return sharded.set_rows(bank, regs_u8, rows)
    bank[_index(rows, bank.device)] = regs_u8.to(torch.int32)
    return bank


def hll_bank_zero_row(bank, row: int):
    _row(bank, row).zero_()
    return bank


def hll_bank_grow(bank, new_cap: int):
    """Elastic capacity: [S, m] -> [S', m], row indices stable (a new
    tensor: the old one is released). A blocked bank is re-placed at S'/D
    rows a block, as JAX re-places it: rows change blocks, and cards."""
    if isinstance(bank, Sharded):
        return sharded.grow_bank(bank, new_cap, bank.mesh)
    s, m = bank.shape
    out = torch.zeros((new_cap, m), dtype=bank.dtype, device=bank.device)
    out[:s] = bank
    return out


# ---------------------------------------------------------------------------
# Mesh collectives (cluster data_plane="mesh")
#
# The bank is a `Sharded` over a logical mesh (parallel/mesh.py SLOT_AXIS).
# Cross-shard PFMERGE / PFCOUNT / DBSIZE run as JAX's shard_map collectives
# do, through the pod's blocked-bank functions: each block max-folds the
# requested rows IT holds (merge_stack on its card, JAX's `_local_fold`),
# the [m] partials meet on home by peer copy and combine by a max (JAX's
# pmax), and the target row's block takes the merged registers. No
# register image crosses the host link.
# ---------------------------------------------------------------------------


def _on_mesh(bank, mesh) -> Sharded:
    if not isinstance(bank, Sharded) or bank.mesh != mesh:
        raise ValueError("a mesh collective takes a bank placed on its mesh "
                         "(ShardedBank.place)")
    return bank


def hll_bank_merge_rows_collective(bank, rows, target, *, mesh):
    """PFMERGE `rows` into row `target` on a mesh-sharded bank, in place:
    per-block folds, a max across blocks, the owner's writeback."""
    return sharded.bank_merge_rows(_on_mesh(bank, mesh), rows, target)


def hll_bank_merge_count_rows_collective(bank, rows, target, *, mesh):
    """Fused collective PFMERGE + PFCOUNT -> (bank, estimate)."""
    return sharded.bank_merge_count_rows(_on_mesh(bank, mesh), rows, target)


def hll_bank_count_rows_collective(bank, rows, *, mesh):
    """Union cardinality over rows of a mesh-sharded bank (countWith)."""
    return sharded.bank_count_rows_merged(_on_mesh(bank, mesh), rows)


def hll_bank_occupancy_collective(bank, *, mesh):
    """Mesh-wide non-empty row count (DBSIZE analogue): per-block counts
    summed in int64."""
    return sharded.occupancy(_on_mesh(bank, mesh))


# ---------------------------------------------------------------------------
# Host mirror and delta ingest: the device half (ingest/delta.py and
# ingest/tape.py are the host half). Bit order everywhere is numpy's
# packbits: cell i lives in byte i >> 3 at bit 7 - (i & 7).
# ---------------------------------------------------------------------------

_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _pack_rows(cells):
    """[..., 8n] uint8 cells -> [..., n] packed bytes: the weighted sum of
    each 8 cells, modulo 256 (JAX's int32 sum cast to uint8)."""
    w = torch.tensor(_PACK_WEIGHTS, dtype=torch.uint8, device=cells.device)
    return (cells.reshape(*cells.shape[:-1], -1, 8) * w).sum(
        dim=-1, dtype=torch.uint8)


def bitset_pack(bits):
    """[m] uint8 cells -> (m+7)//8 packed bytes: pulling a Bloom filter to
    its host mirror moves one bit per cell, not one byte."""
    pad = (-bits.shape[0]) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,))])
    return _pack_rows(bits)


def delta_unpack(packed, cells: int):
    """Packed bytes -> [cells] uint8 cells."""
    sh = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8,
                      device=packed.device)
    return ((packed[:, None] >> sh) & 1).reshape(-1)[:cells]


def bitset_absorb_packed(bits, packed):
    """OR a packed bitmap into [m] uint8 cells, in place (the device half of
    a Bloom mirror sync)."""
    torch.maximum(bits, delta_unpack(packed, bits.shape[0]), out=bits)
    return bits


def delta_scatter_bytes(idx, val, nbytes: int):
    """A sparse (idx, val) byte plane made dense. Padding entries (0, 0)
    are a no-op under the max."""
    out = torch.zeros((nbytes,), dtype=torch.uint8, device=idx.device)
    return out.scatter_reduce_(0, idx.long(), val, reduce="amax")


def delta_merge_stack(old, delta):
    """One multi-target delta merge: max of the [T, L] uint8 stack of old
    rows with the delta stack, in place into `old` -> (merged [T, L],
    changed [T] bool). The delta_merge kernel on a card."""
    return pk.delta_merge(old, delta)


def tape_apply(bank, wire, table, hll_rows, store_old, *, n_hll: int,
               lanes: int, want_old: bool = False):
    """Retire one encoded window tape.

    Gathers the HLL entries' bank rows (uint8) and the store entries' cell
    tensors into a zero-padded [T2, lanes] stack of old rows on the wire's
    device, packs their pre-merge bits when `want_old` (SETBIT results;
    formed before the merge overwrites the stack), merges the whole tape
    with ONE `window_merge`, and writes the HLL rows back. The first
    `n_hll` entries of `hll_rows` are the HLL entries' rows (JAX pads the
    vector to a power of two by repeating the first; the repeats are not
    read). A blocked bank's rows are gathered from their blocks to the
    wire's device (home) and written back block by block, each on its
    card: the one launch still retires a window whose rows span cards.

    `bank` [S, m] int32 or a `Sharded` (None when `n_hll` is 0; `hll_rows`
    host ints for a `Sharded`), `wire` uint8 [T2, W] and `table` int32
    [T2, 5] from the encode, `store_old` the store entries' cell tensors in
    row order. Returns (bank, merged [T2, lanes], changed [T2] bool,
    old_packed [T2, lanes // 8] | None).
    """
    t2 = table.shape[0]
    old = torch.zeros((t2, lanes), dtype=torch.uint8, device=wire.device)
    if n_hll:
        m = bank.shape[1]
        rows = hll_rows[:n_hll]
        old[:n_hll, :m] = hll_bank_rows_u8(bank, rows)
    for j, cells in enumerate(store_old):
        old[n_hll + j, : cells.shape[0]] = cells
    old_packed = _pack_rows(old.clamp(max=1)) if want_old else None
    merged, changed = wk.window_merge(old, wire, table)
    if n_hll:
        bank = hll_bank_set_rows(bank, merged[:n_hll, :m], rows)
    return bank, merged, changed, old_packed


# ---------------------------------------------------------------------------
# BitSet
# ---------------------------------------------------------------------------


def bitset_set(bits, idx, valid):
    """SETBIT batch, in place -> (bits, old values). Padded lanes read
    index 0 and write nothing (a max with 0)."""
    idx = torch.where(valid, idx, 0)
    old = bits[idx]
    bits.scatter_reduce_(0, idx, valid.to(torch.uint8), reduce="amax")
    return bits, old


def bitset_clear(bits, idx, valid):
    """SETBIT 0 batch, in place -> (bits, old values); padded lanes take a
    min with 1, a no-op on 0/1 cells."""
    idx = torch.where(valid, idx, 0)
    old = bits[idx]
    bits.scatter_reduce_(0, idx, (~valid).to(torch.uint8), reduce="amin")
    return bits, old


def bitset_get(bits, idx, valid):
    return bits[torch.where(valid, idx, 0)]


def bitset_cardinality_partials(bits):
    """Device half of BITCOUNT: [G, 1] int32 partials (the popcount kernel
    on a card)."""
    return pk.popcount_partials(bits)


def bitset_cardinality(bits) -> int:
    """BITCOUNT, exact past 2^31 set bits: the partials combine on the
    host in Python ints."""
    return bitset.combine_partials(bitset_cardinality_partials(bits))


def bitset_bitop(stack, op: str):
    """BITOP AND|OR|XOR over [K, n] stacked operands -> [n] (the bitop
    kernel on a card)."""
    return pk.bitop_cells(stack, op)


def bitset_length_partials(bits):
    """Device half of lengthAsync: per-chunk int32 local offsets."""
    return bitset.length_partials(bits)


def bitset_length(bits) -> int:
    """Index of the highest set bit + 1, exact past 2^31 bits. Blocks; the
    backend's LENGTH stages `bitset_length_partials` and combines on the
    completer instead."""
    return bitset.combine_length(bitset_length_partials(bits))


def bitset_not_masked(bits, n: int):
    """BITOP NOT over cells [0, n) only, in place: Redis NOT acts on the
    written bytes (STRLEN), not the allocation."""
    head = bits[:n]
    torch.sub(1, head, out=head)
    return bits


# ---------------------------------------------------------------------------
# Bloom
# ---------------------------------------------------------------------------


def _set_indexes(bits, idx, valid, impl: str = "scatter"):
    """Set a batch's [N, k] cell indexes in place -> (bits, added). `added`
    is any(old == 0) over cells gathered before the insert, so it is taken
    against the batch start. The scatter path writes padded lanes as index
    0, value 0; the segment path sends them to the one-past-end cell m,
    which the kernel and its plain version drop."""
    idx = torch.where(valid[:, None], idx, 0)
    old = bits[idx.reshape(-1)].reshape(idx.shape)
    vals = valid[:, None].expand(idx.shape)
    if impl == "segment":
        from redisson_tpu_torch.ingest import kernels as ingest_kernels

        new = ingest_kernels.segmented_bits_set(
            bits, torch.where(vals, idx, bits.shape[0]).reshape(-1))
    else:
        new = bits.scatter_reduce_(0, idx.reshape(-1),
                                   vals.reshape(-1).to(torch.uint8), reduce="amax")
    return new, (old == 0).any(dim=-1) & valid


def _bloom_add(bits, h1, h2, valid, k: int, m: int, impl: str = "scatter"):
    """k-index double hashing -> masked set -> (bits, added)."""
    return _set_indexes(bits, bloom.indexes(h1, h2, k, m), valid, impl)


def _bloom_contains(bits, h1, h2, valid, k: int, m: int):
    idx = bloom.indexes(h1, h2, k, m)
    idx = torch.where(valid[:, None], idx, 0)
    return bloom.contains(bits, idx) & valid


def _packed_hashes(packed, count: int, seed: int):
    """(h1, h2, valid) of int64 keys, hashed as their 8-byte LE encodings
    (the byte path's hash on 8-byte keys)."""
    valid = _valid_prefix(packed.shape[0], count, packed.device)
    h1, h2 = hashing.murmur3_x64_128_u64(packed, seed)
    return h1, h2, valid


def bloom_add_bytes(bits, data, lengths, valid, k: int, m: int, seed: int = 0,
                    impl: str = "scatter"):
    """Bloom add of a padded byte-key batch -> (bits, added)."""
    h1, h2 = hashing.murmur3_x64_128(data, lengths, seed)
    return _bloom_add(bits, h1, h2, valid, k, m, impl)


def bloom_contains_bytes(bits, data, lengths, valid, k: int, m: int, seed: int = 0):
    h1, h2 = hashing.murmur3_x64_128(data, lengths, seed)
    return _bloom_contains(bits, h1, h2, valid, k, m)


def bloom_add_packed(bits, packed, count: int, k: int, m: int, seed: int = 0,
                     impl: str = "scatter"):
    """Bloom add of int64 keys, the first `count` lanes valid."""
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _bloom_add(bits, h1, h2, valid, k, m, impl)


def bloom_contains_packed(bits, packed, count: int, k: int, m: int, seed: int = 0):
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _bloom_contains(bits, h1, h2, valid, k, m)


def bloom_contains_count_packed(bits, packed, count: int, k: int, m: int,
                                seed: int = 0):
    """Membership COUNT of an int64 key batch as one device scalar: only
    it leaves the device (what an FPR probe over 2^30 keys wants)."""
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _bloom_contains(bits, h1, h2, valid, k, m).sum()


# -- blocked bloom (ops/bloom.py BLOCK_BITS) -------------------------------


def _blocked_add(bits, h1, h2, valid, k: int, m: int):
    """The blocked layout's add: always the in-place scatter."""
    block, pos = bloom.blocked_indexes(h1, h2, k, m)
    return _set_indexes(bits, bloom.blocked_absolute(block, pos), valid)


def _blocked_contains(bits, h1, h2, valid, k: int, m: int):
    block, pos = bloom.blocked_indexes(h1, h2, k, m)
    block = torch.where(valid, block, 0)
    return bloom.blocked_contains(bits, block, pos) & valid


def blocked_bloom_add_packed(bits, packed, count: int, k: int, m: int, seed: int = 0):
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _blocked_add(bits, h1, h2, valid, k, m)


def blocked_bloom_contains_packed(bits, packed, count: int, k: int, m: int,
                                  seed: int = 0):
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _blocked_contains(bits, h1, h2, valid, k, m)


def blocked_bloom_contains_count_packed(bits, packed, count: int, k: int, m: int,
                                        seed: int = 0):
    h1, h2, valid = _packed_hashes(packed, count, seed)
    return _blocked_contains(bits, h1, h2, valid, k, m).sum()


def blocked_bloom_add_bytes(bits, data, lengths, valid, k: int, m: int, seed: int = 0):
    h1, h2 = hashing.murmur3_x64_128(data, lengths, seed)
    return _blocked_add(bits, h1, h2, valid, k, m)


def blocked_bloom_contains_bytes(bits, data, lengths, valid, k: int, m: int,
                                 seed: int = 0):
    h1, h2 = hashing.murmur3_x64_128(data, lengths, seed)
    return _blocked_contains(bits, h1, h2, valid, k, m)
