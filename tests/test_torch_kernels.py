"""The kernel modules' plain versions against the JAX package's Pallas
kernels in interpret mode (segmented insert, merge_stack, popcount
partials, bitop, the segment-OR), and the host-side code around the CUDA
kernels (the HLL insert's grid and its flush, row blocking, sentinels, the
segment-OR's slab binning), with numpy emulations of the kernels'
algorithms. The CUDA kernels themselves run
only on a card: `chip_smoke.py` and tests/test_torch_cuda.py hold them
against these plain versions there."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.ingest import kernels as jk
from redisson_tpu.ops import hll as jhll
from redisson_tpu.ops import pallas_kernels as pk
from redisson_tpu_torch.ingest import kernels as ik
from redisson_tpu_torch.ops import kernels as ok

M = 2048  # small register count keeps interpret mode fast; any 2^p works


def _batch(case: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, M, n).astype(np.int32)
    rank = rng.integers(1, 52, n).astype(np.int32)
    if case == "hot":
        bucket[:] = 1234
    elif case == "invalid":
        # Padded/invalid lanes arrive as bucket 0, rank 0.
        dead = rng.random(n) < 0.5
        bucket[dead] = 0
        rank[dead] = 0
    elif case == "all_invalid":
        rank[:] = 0  # the engine's padded lanes keep their hash's bucket
    return bucket, rank


def _start(case: str, bucket, rank) -> np.ndarray:
    """Registers before the insert; under "no_raise" they already hold the
    batch, so nothing rises."""
    regs = np.random.default_rng(9).integers(0, 10, M).astype(np.int32)
    if case == "no_raise":
        np.maximum.at(regs, bucket, rank)
    return regs


CASES = [("uniform", 3000), ("hot", 3000), ("invalid", 3000), ("uniform", 0),
         ("uniform", 1), ("no_raise", 3000), ("all_invalid", 3000)]


@functools.lru_cache(maxsize=None)
def _pallas_insert(case: str, n: int):
    """JAX's segmented insert (Pallas, interpret mode) of `case` -> (start
    registers, bucket, rank, result)."""
    bucket, rank = _batch(case, n, n + len(case))
    start = _start(case, bucket, rank)
    want = np.asarray(jk.hll_insert_segmented(
        jnp.asarray(start), jnp.asarray(bucket), jnp.asarray(rank), interpret=True))
    return start, bucket, rank, want


@pytest.mark.parametrize("case,n", CASES)
def test_segmented_insert_plain_matches_pallas(case, n):
    start, bucket, rank, want = _pallas_insert(case, n)
    np.testing.assert_array_equal(
        want, np.asarray(jhll.insert_sorted(jnp.asarray(start), jnp.asarray(bucket),
                                            jnp.asarray(rank))))
    regs = torch.from_numpy(start.copy())
    changed = torch.zeros((), dtype=torch.bool)
    before = ik.launches["seg_insert"]
    got = ik.hll_insert_segmented(regs, torch.from_numpy(bucket), torch.from_numpy(rank),
                                  changed)
    assert got is regs  # in place: JAX's new array and these registers hold the same values
    np.testing.assert_array_equal(regs.numpy(), want)
    assert bool(changed) == bool((want != start).any())
    if case in ("no_raise", "all_invalid") or n == 0:
        assert not bool(changed)
    again = torch.from_numpy(start.copy())
    assert ik.hll_insert_segmented_plain(again, torch.from_numpy(bucket),
                                         torch.from_numpy(rank)) is again
    np.testing.assert_array_equal(again.numpy(), want)
    assert ik.launches["seg_insert"] == before  # the CPU path launches nothing


def _emulate_seg_kernel(bucket, rank, regs, blocks, cluster, seed):
    """csrc/seg_insert.cu's algorithms in numpy -> (registers, changed).

    blocks == 0, the direct kernel: every pair raises its register itself.
    Else the shared kernel: `blocks` contiguous slices of the pairs (`per`
    rounded up to 4), each folded into a zeroed block copy; each cluster of
    `cluster` blocks takes the max of its copies, and its block `me` flushes
    the me-th slice of the registers. Ranks <= 0 and buckets outside
    [0, m) never fold. Either way the raises (pairs, or flushes of combined
    values) run in a random order, each reading the registers either from
    before the call or as they stand (both are what a thread may see), and
    raise a register only where the value exceeds what it read; `changed`
    is whether any raise was issued."""
    m, n = regs.shape[0], bucket.shape[0]
    keep = (bucket >= 0) & (bucket < m) & (rank > 0)
    raises = []  # (lo, hi, values): raise regs[lo:hi] to values
    if blocks == 0:
        raises = [(int(b), int(b) + 1, np.array([r], np.int32))
                  for b, r in zip(bucket[keep], rank[keep])]
    else:
        per = -(-n // blocks)
        per = (per + 3) & ~3
        copies = np.zeros((blocks, m), np.int32)
        for blk in range(blocks):
            sl = slice(blk * per, (blk + 1) * per)
            np.maximum.at(copies[blk], bucket[sl][keep[sl]], rank[sl][keep[sl]])
        m4 = m // 4
        for first in range(0, blocks, cluster):
            combined = copies[first:first + cluster].max(axis=0)
            for me in range(cluster):
                lo, hi = 4 * (m4 * me // cluster), 4 * (m4 * (me + 1) // cluster)
                raises.append((lo, hi, combined[lo:hi]))
    rng = np.random.default_rng(seed)
    out = regs.copy()
    changed = False
    for k in rng.permutation(len(raises)):
        lo, hi, acc = raises[k]
        seen = (regs if rng.random() < 0.5 else out)[lo:hi].copy()
        issue = acc > seen
        changed |= bool(issue.any())
        out[lo:hi] = np.where(issue, np.maximum(out[lo:hi], acc), out[lo:hi])
    return out, changed


@pytest.mark.parametrize("case,n", CASES[:3] + CASES[5:] + [("uniform", 0)])
@pytest.mark.parametrize("blocks,cluster", [(0, 0), (1, 1), (3, 1), (132, 4), (128, 8)])
def test_seg_insert_kernel_algorithm(case, n, blocks, cluster):
    """The sort-free kernels (direct, and the shared kernel's slices, block
    copies, cluster combine and flush) with their read-before-atomic raises
    give the plain version's registers and flag, and JAX's registers,
    whatever the order."""
    start, bucket, rank, want = _pallas_insert(case, n)
    plain = torch.from_numpy(start.copy())
    flag = torch.zeros((1,), dtype=torch.bool)
    ik.hll_insert_segmented_plain(plain, torch.from_numpy(bucket), torch.from_numpy(rank),
                                  flag)
    np.testing.assert_array_equal(plain.numpy(), want)
    for seed in range(3):
        got, changed = _emulate_seg_kernel(bucket, rank, start, blocks, cluster, seed)
        np.testing.assert_array_equal(got, want)
        assert changed == bool(flag[0])


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8192, 40_000, 65_536, ik.MAX_DIRECT_PAIRS,
                               ik.MAX_DIRECT_PAIRS + 1, 1 << 20, 1 << 21, (1 << 21) + 3])
@pytest.mark.parametrize("m", [1 << 14, 1 << 15, 1 << 16])
def test_seg_plan_covers_the_batch(n, m):
    blocks, cluster = ik.seg_plan(n, m)
    if n <= ik.MAX_DIRECT_PAIRS or m > ik.MAX_SHARED_REGISTERS:
        assert (blocks, cluster) == (0, 0)  # the direct kernel: any m
        return
    assert 1 <= blocks <= ik.MAX_BLOCKS and 1 <= cluster <= ik.MAX_CLUSTER
    assert blocks % cluster == 0 and cluster & (cluster - 1) == 0
    per = -(-n // blocks)
    per = (per + 3) & ~3  # as the entry rounds it: slices start on a 16-byte vector
    assert per * blocks >= n and per * (blocks - 1) < n + 4 * blocks
    if n >= ik.PAIRS_PER_BLOCK * ik.MAX_BLOCKS:
        assert blocks == ik.MAX_BLOCKS and cluster == ik.MAX_CLUSTER


def test_segmented_insert_takes_any_register_count():
    """p = 16 registers do not fit one block's shared memory; they take the
    direct kernel on a card and the plain version here, with JAX's values."""
    m = 1 << 16
    rng = np.random.default_rng(3)
    start = rng.integers(0, 10, m).astype(np.int32)
    bucket = rng.integers(0, m, 5000).astype(np.int32)
    rank = rng.integers(0, 52, 5000).astype(np.int32)
    want = np.asarray(jk.hll_insert_segmented(jnp.asarray(start), jnp.asarray(bucket),
                                              jnp.asarray(rank), interpret=True))
    regs = torch.from_numpy(start.copy())
    changed = torch.zeros((), dtype=torch.bool)
    ik.hll_insert_segmented(regs, torch.from_numpy(bucket), torch.from_numpy(rank), changed)
    np.testing.assert_array_equal(regs.numpy(), want)
    assert bool(changed)
    assert ik.seg_plan(1 << 21, m) == (0, 0)


@pytest.mark.parametrize("s", [0, 1, 7, 70, 130])
def test_merge_stack_plain_matches_pallas(s):
    stack = np.random.default_rng(s).integers(0, 52, (s, M)).astype(np.int32)
    want = np.asarray(pk.merge_stack(jnp.asarray(stack), block=8))
    before = ok.launches["merge_stack"]
    got = ok.merge_stack(torch.from_numpy(stack))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ok.merge_stack_plain(torch.from_numpy(stack)).numpy(),
                                  want)
    assert got.shape == (M,) and got.dtype == torch.int32
    assert ok.launches["merge_stack"] == before


@pytest.mark.parametrize("s,rows", [(70, [3, 5, 3, 69, 0]), (7, []),
                                    (130, list(range(129, -1, -1))), (5, [4] * 9)])
def test_merge_stack_over_listed_rows_matches_pallas(s, rows):
    """The client's merge over bank rows: the listed rows (repeats and any
    order) merged in place give the Pallas merge of the gathered stack."""
    stack = np.random.default_rng(s).integers(0, 52, (s, M)).astype(np.int32)
    idx = np.asarray(rows, np.int32)
    want = np.asarray(pk.merge_stack(jnp.asarray(stack[idx]), block=8))
    before = ok.launches["merge_stack"]
    got = ok.merge_stack(torch.from_numpy(stack), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ok.merge_stack_plain(torch.from_numpy(stack), torch.from_numpy(idx)).numpy(), want)
    assert ok.launches["merge_stack"] == before


def _emulate_rows_kernel(bank, bucket, rank, rows, seed):
    """csrc/seg_insert.cu's seg_rows_kernel in numpy -> (bank, changed[S]).
    Pairs with rank <= 0, or a row or bucket out of range, never fold. The
    others raise in a random order, each reading its register either from
    before the call or as it stands (both are what a thread may see), and
    raising it only where the rank exceeds what it read; a raise sets its
    row's flag."""
    s, m = bank.shape
    keep = (rank > 0) & (rows >= 0) & (rows < s) & (bucket >= 0) & (bucket < m)
    rng = np.random.default_rng(seed)
    out, changed = bank.copy(), np.zeros(s, bool)
    for k in rng.permutation(np.flatnonzero(keep)):
        w, b, r = rows[k], bucket[k], rank[k]
        if r > (bank if rng.random() < 0.5 else out)[w, b]:
            out[w, b] = max(out[w, b], r)
            changed[w] = True
    return out, changed


@pytest.mark.parametrize("case", ["uniform", "hot", "no_raise", "all_invalid",
                                  "out_of_range", "empty"])
def test_seg_rows_kernel_algorithm(case):
    """The multi-target insert: its plain version is JAX's flat scatter at
    row * m + bucket (registers, and a row flagged iff one of its registers
    rose), and the kernel's algorithm gives the same whatever the order."""
    s, n = 6, 0 if case == "empty" else 3000
    rng = np.random.default_rng(len(case))
    bank = rng.integers(0, 10, (s, M)).astype(np.int32)
    bucket = rng.integers(0, M, n).astype(np.int32)
    rank = rng.integers(0, 52, n).astype(np.int32)
    rows = rng.integers(0, s - 1, n).astype(np.int32)  # the last row is never hit
    if case == "hot":
        bucket[:], rows[:] = 77, 2
    elif case == "all_invalid":
        rank[:] = 0
    elif case == "no_raise":
        np.maximum.at(bank.reshape(-1), rows.astype(np.int64) * M + bucket, rank)
    elif case == "out_of_range":
        bucket[::7], rows[1::7], rows[2::7] = M, s, -1
    keep = (rank > 0) & (rows >= 0) & (rows < s) & (bucket >= 0) & (bucket < M)
    flat = jnp.asarray(bank).reshape(-1).at[
        (rows.astype(np.int64) * M + bucket)[keep]].max(rank[keep])
    want = np.asarray(flat).reshape(s, M)
    want_changed = (want != bank).any(axis=1)
    got = torch.from_numpy(bank.copy())
    changed = torch.zeros(s, dtype=torch.bool)
    before = ik.launches["seg_insert"]
    assert ik.hll_insert_segmented_rows(got, torch.from_numpy(bucket), torch.from_numpy(rank),
                                        torch.from_numpy(rows), changed) is got
    assert ik.launches["seg_insert"] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(changed.numpy(), want_changed)
    assert not want_changed[s - 1]
    assert want_changed.any() == (case in ("uniform", "hot", "out_of_range"))
    for seed in range(3):
        out, flags = _emulate_rows_kernel(bank, bucket, rank, rows, seed)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(flags, want_changed)


@pytest.mark.parametrize("s,m", [(1024, 16384), (1000, 16384), (3, 16384), (5, 8)])
def test_merge_row_blocks_cover_every_row(s, m):
    rows = ok.rows_per_block(s, m)
    blocks = -(-s // rows)
    assert rows >= 1 and blocks * rows >= s and (blocks - 1) * rows < s
    col_blocks = -(-m // 1024)
    assert col_blocks * blocks <= 528 + col_blocks  # about one block per SM slot


# -- BitSet / Bloom kernels ---------------------------------------------------


@pytest.mark.parametrize("n,block", [(70001, 4096), (1 << 16, 4096), (1, 4096),
                                     (300_000, 1 << 18), (0, 1 << 18)])
def test_popcount_plain_matches_pallas(n, block):
    cells = (np.random.default_rng(n).random(n) < 0.37).astype(np.uint8)
    want = np.asarray(pk.popcount_partials(jnp.asarray(cells), block=block))
    before = ok.launches["popcount_partials"]
    got = ok.popcount_partials(torch.from_numpy(cells), block)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)  # partial by partial
    np.testing.assert_array_equal(
        ok.popcount_partials_plain(torch.from_numpy(cells), block).numpy(), want)
    assert int(ok.popcount_cells(torch.from_numpy(cells), block)) == int(cells.sum())
    assert ok.launches["popcount_partials"] == before


@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("k,n", [(8, 5000), (1, 4096), (3, 17), (2, 0)])
def test_bitop_plain_matches_pallas(op, k, n):
    stack = (np.random.default_rng(k * n + 1).random((k, n)) < 0.5).astype(np.uint8)
    want = np.asarray(pk.bitop_cells(jnp.asarray(stack), op, block=2048))
    before = ok.launches["bitop_cells"]
    got = ok.bitop_cells(torch.from_numpy(stack), op)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ok.bitop_cells_plain(torch.from_numpy(stack), op).numpy(),
                                  want)
    assert got.shape == (n,) and got.dtype == torch.uint8
    assert ok.launches["bitop_cells"] == before


def _bit_codes(m: int, n: int, seed: int) -> np.ndarray:
    """Cell indexes with duplicates and one-past-the-end sentinels (the
    engine's invalid lanes)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, n).astype(np.int32)
    if n:
        idx[: n // 10] = idx[n // 10: 2 * (n // 10)]
        idx[rng.random(n) < 0.2] = m
    return idx


@pytest.mark.parametrize("m,n", [(70001, 8192), (4096, 500), (70001, 0), (1024, 1)])
def test_bits_segmented_plain_matches_pallas(m, n):
    cells = (np.random.default_rng(m).random(m) < 0.01).astype(np.uint8)
    idx = _bit_codes(m, n, n + 3)
    want = np.asarray(jk.bits_insert_segmented(jnp.asarray(cells), jnp.asarray(idx),
                                               interpret=True))
    ref = cells.copy()
    ref[idx[idx < m]] = 1
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(
        np.asarray(jk.bits_insert_segmented_lax(jnp.asarray(cells), jnp.asarray(idx))), want)
    before = ik.launches["bits_insert_segmented"]
    tcells = torch.from_numpy(cells.copy())
    got = ik.bits_insert_segmented(tcells, torch.from_numpy(idx))
    assert got is tcells  # in place: JAX's new array and these cells hold the same values
    np.testing.assert_array_equal(tcells.numpy(), want)
    again = torch.from_numpy(cells.copy())
    assert ik.segmented_bits_set(again, torch.from_numpy(idx)) is again
    np.testing.assert_array_equal(again.numpy(), want)
    assert ik.launches["bits_insert_segmented"] == before


@pytest.mark.parametrize("case", ["no_codes", "only_sentinels", "negative_codes",
                                  "hot_cell", "ragged_m", "int64_codes"])
def test_bits_segment_or_drops_what_pallas_drops(case):
    """Codes outside [0, m) are dropped, compared as unsigned: the sentinel
    m, anything larger and negative codes, as the Pallas kernel drops them
    (`bits_insert_segmented_lax` wraps a negative index, so it is not the
    reference here)."""
    m = 4103 if case == "ragged_m" else 4096
    rng = np.random.default_rng(len(case))
    cells = (rng.random(m) < 0.02).astype(np.uint8)
    idx = rng.integers(0, m, 3000).astype(np.int32)
    if case == "no_codes":
        idx = idx[:0]
    elif case == "only_sentinels":
        idx[:] = m
    elif case == "negative_codes":
        idx[::3] = -rng.integers(1, 1 << 30, idx[::3].shape[0])
        idx[1::7] = m + rng.integers(0, 1 << 20, idx[1::7].shape[0])
    elif case == "hot_cell":
        idx[:] = m - 1
    elif case == "ragged_m":
        idx[:50] = m - 1 - np.arange(50)
    want = np.asarray(jk.bits_insert_segmented(jnp.asarray(cells), jnp.asarray(idx),
                                               interpret=True)) if idx.size else cells
    tidx = torch.from_numpy(idx.astype(np.int64) if case == "int64_codes" else idx)
    tcells = torch.from_numpy(cells.copy())
    assert ik.bits_insert_segmented(tcells, tidx) is tcells
    np.testing.assert_array_equal(tcells.numpy(), want)
    np.testing.assert_array_equal(
        _emulate_slab_kernel(cells, idx, 10, 3), want)


def _emulate_slab_kernel(cells, codes, shift, grid):
    """csrc/bits_insert.cu's algorithm in numpy, with `shift`-bit slabs and
    `grid` code chunks: per-chunk slab counts reserve bin ranges (in reverse
    chunk order: the kernel's atomics land in any order), a scan gives the
    bin offsets, each chunk writes its codes' in-slab offsets into its
    ranges, and each slab applies its bin as marks, max into the cells."""
    m, n = cells.shape[0], codes.shape[0]
    slabs = (m + (1 << shift) - 1) >> shift
    u = codes.astype(np.int64) & (0xFFFFFFFF if codes.dtype == np.int32 else -1)
    u = np.where(u < 0, m, u)  # an int64 negative is >= m as unsigned
    per = -(-n // grid) if n else 0
    chunks = [u[b * per:(b + 1) * per] for b in range(grid)]
    chunks = [c[c < m] for c in chunks]
    count = np.zeros(slabs, np.int64)
    base = np.zeros((grid, slabs), np.int64)
    for b in reversed(range(grid)):
        base[b] = count
        count += np.bincount(chunks[b] >> shift, minlength=slabs)
    start = np.concatenate([[0], np.cumsum(count)])
    bins = np.full(int(start[-1]), -1, np.int64)
    for b in range(grid):
        cursor = start[:-1] + base[b]
        for v in chunks[b]:
            bins[cursor[v >> shift]] = v & ((1 << shift) - 1)
            cursor[v >> shift] += 1
    assert (bins >= 0).all()  # the ranges tile the bins exactly
    out = cells.copy()
    for s in range(slabs):
        marks = np.zeros(1 << shift, np.uint8)
        marks[bins[start[s]:start[s + 1]]] = 1
        lo, hi = s << shift, min((s + 1) << shift, m)
        out[lo:hi] = np.maximum(out[lo:hi], marks[: hi - lo])
    return out


@pytest.mark.parametrize("m", [70001, 4096, 1000])
def test_bits_tile_spans_and_kernel_algorithm(m):
    """The segment-OR kernel's binning and slab apply, at the kernel's own
    16-bit slabs and at small ones (many slabs, a ragged last slab), drop
    the sentinel m and set exactly the plain version's cells."""
    idx = _bit_codes(m, 5000, 4)
    cells = (np.random.default_rng(1).random(m) < 0.01).astype(np.uint8)
    want = ik.bits_insert_segmented_plain(torch.from_numpy(cells.copy()),
                                          torch.from_numpy(idx)).numpy()
    for shift in (16, 10, 7):  # 16: the kernel's own 64 KiB slabs (kSlabShift)
        for grid in (1, 3, 64):
            np.testing.assert_array_equal(_emulate_slab_kernel(cells, idx, shift, grid),
                                          want)


def test_planner_times_the_bits_paths():
    from redisson_tpu_torch.ingest import planner

    costs = planner.measure_device_paths("bits", 1 << 12, torch.device("cpu"))
    assert set(costs) == {"scatter", "segment"} and all(c > 0 for c in costs.values())
    with pytest.raises(ValueError):
        planner.measure_device_paths("nope", 10, torch.device("cpu"))
    p = planner.IngestPlanner("cpu", measure=lambda s, n, d: {"scatter": 2.0,
                                                              "segment": 1.0})
    assert p.plan("bits", 5000).path == "segment"
    assert p.plan("bits", 5000, exclude=("segment",)).path == "scatter"


def test_planner_prices_host_candidates_and_priors():
    """Measured device paths pay `device_overhead`; `extra_costs` join as
    they are; a prior fills only paths the measurement did not time."""
    from redisson_tpu_torch.ingest import planner

    p = planner.IngestPlanner("cpu", measure=lambda s, n, d: {"scatter": 2.0,
                                                              "sort": 3.0})
    p.set_prior("hll", 5000, {"scatter": 99.0, "segment": 0.5})
    plan = p.plan("hll", 5000, extra_costs={"delta": 4.0}, device_overhead=1.5)
    assert plan.costs == {"scatter": 3.5, "sort": 4.5, "segment": 2.0, "delta": 4.0}
    assert plan.path == "segment"
    plan = p.plan("hll", 5000, exclude=("segment",), extra_costs={"delta": 3.0},
                  device_overhead=1.5)
    assert plan.path == "delta"
    assert p.plan("hll", 5000, exclude=("segment",)).path == "scatter"
    p.set_prior("hll", 5000, {"segment": 0.1})  # the row is measured: no effect
    assert p.plan("hll", 5000).costs["segment"] == 0.5


def test_delta_wrappers_refuse_what_they_cannot_run():
    from redisson_tpu_torch.ops import window_kernel as wk

    meta = torch.zeros((2, 1024), dtype=torch.uint8, device="meta")
    table = torch.zeros((2, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ok.delta_merge(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        wk.window_merge(meta, meta, table)
    cells = torch.zeros((2, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError):
        wk.window_merge(cells, cells, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        wk.window_merge(cells, cells[:1], torch.zeros((2, 5), dtype=torch.int32))


def test_wrappers_refuse_devices_they_cannot_run_on():
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version (here: a meta tensor, no card needed)."""
    stack = torch.zeros((4, M), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ok.merge_stack(stack)
    regs = torch.zeros((M,), dtype=torch.int32, device="meta")
    b = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ik.hll_insert_segmented(regs, b, b)
    with pytest.raises(ValueError):
        ik.hll_insert_segmented(regs, b, b, torch.zeros((), dtype=torch.bool,
                                                        device="meta"))
    with pytest.raises(ValueError):  # int64 registers, on any device
        ik.hll_insert_segmented(torch.zeros((M,), dtype=torch.int64),
                                torch.zeros(8, dtype=torch.int32),
                                torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        ok.merge_stack(torch.zeros((4, M), dtype=torch.int64))
    with pytest.raises(ValueError):
        ok.merge_stack(stack, torch.zeros((2,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        ik.hll_insert_segmented_rows(stack, b, b, b)
    cells = torch.zeros((M,), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ok.popcount_partials(cells)
    with pytest.raises(ValueError):
        ok.bitop_cells(torch.zeros((3, M), dtype=torch.uint8, device="meta"), "or")
    with pytest.raises(ValueError):
        ik.bits_insert_segmented(cells, torch.zeros((8,), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        ok.bitop_cells(torch.zeros((3, M), dtype=torch.uint8), "nand")
    with pytest.raises(ValueError):
        ok.popcount_partials(torch.zeros((M,), dtype=torch.int32))
    # int32 codes cannot hold the sentinel of a 2^31-cell array, on any device.
    with pytest.raises(ValueError, match="2\\^31"):
        ik.bits_insert_segmented(torch.zeros((1 << 31,), dtype=torch.uint8, device="meta"),
                                 torch.zeros((8,), dtype=torch.int64))
