"""The kernel modules' plain versions against the JAX package's Pallas
kernels in interpret mode (segmented insert, merge_stack, popcount
partials, bitop, the segment-OR), and the host-side code around the CUDA
kernels (code sorting, tile spans, row blocking, sentinels). The CUDA kernels themselves run
only on a card: `chip_smoke.py` and tests/test_torch_cuda.py hold them
against these plain versions there."""

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
    return bucket, rank


CASES = [("uniform", 3000), ("hot", 3000), ("invalid", 3000), ("uniform", 0),
         ("uniform", 1)]


@pytest.mark.parametrize("case,n", CASES)
def test_segmented_insert_plain_matches_pallas(case, n):
    bucket, rank = _batch(case, n, n + len(case))
    start = np.random.default_rng(9).integers(0, 10, M).astype(np.int32)
    want = np.asarray(jk.hll_insert_segmented(
        jnp.asarray(start), jnp.asarray(bucket), jnp.asarray(rank), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jhll.insert_sorted(jnp.asarray(start), jnp.asarray(bucket),
                                            jnp.asarray(rank))))
    regs = torch.from_numpy(start.copy())
    before = ik.launches["seg_insert"]
    got = ik.hll_insert_segmented(regs, torch.from_numpy(bucket), torch.from_numpy(rank))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(regs.numpy(), start)  # fresh output
    assert ik.launches["seg_insert"] == before  # the CPU path launches nothing


def _emulate_seg_kernel(codes, starts, regs, tile, shift):
    """The CUDA kernel's algorithm in numpy: per tile, only the last code of
    each bucket run stores its value into the tile accumulator."""
    out = regs.copy()
    n = codes.shape[0]
    for t in range(starts.shape[0] - 1):
        acc = np.zeros(tile, np.int32)
        for i in range(starts[t], starts[t + 1]):
            b = codes[i] >> shift
            if i + 1 < n and (codes[i + 1] >> shift) == b:
                continue
            acc[b - t * tile] = codes[i] & ((1 << shift) - 1) if shift else 1
        sl = slice(t * tile, min((t + 1) * tile, regs.shape[0]))
        out[sl] = np.maximum(out[sl], acc[: sl.stop - sl.start])
    return out


@pytest.mark.parametrize("case,n", CASES[:4])
@pytest.mark.parametrize("tile", [128, 100])
def test_tile_spans_and_kernel_algorithm(case, n, tile):
    bucket, rank = _batch(case, n, 17)
    codes = torch.from_numpy(bucket * 64 + rank)
    sorted_codes, starts = ik.sort_codes(codes, M, ik.HLL_SHIFT, tile)
    g = -(-M // tile)
    assert starts.dtype == torch.int32 and starts.shape == (g + 1,)
    s = sorted_codes.numpy()
    assert (np.diff(s) >= 0).all()
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(s, (np.arange(g + 1) * tile) << 6))
    regs = np.random.default_rng(2).integers(0, 10, M).astype(np.int32)
    want = ik.hll_insert_segmented_plain(torch.from_numpy(regs), torch.from_numpy(bucket),
                                         torch.from_numpy(rank)).numpy()
    np.testing.assert_array_equal(
        _emulate_seg_kernel(s, starts.numpy(), regs, tile, ik.HLL_SHIFT), want)


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
    before = ik.launches["bits_insert_segmented"]
    tcells = torch.from_numpy(cells.copy())
    got = ik.bits_insert_segmented(tcells, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcells.numpy(), cells)  # fresh output
    np.testing.assert_array_equal(
        ik.segmented_bits_set(torch.from_numpy(cells), torch.from_numpy(idx)).numpy(), want)
    assert ik.launches["bits_insert_segmented"] == before


@pytest.mark.parametrize("m", [70001, 4096, 1000])
def test_bits_tile_spans_and_kernel_algorithm(m):
    """The kernel's algorithm at shift 0 drops the sentinel m, also when it
    lands in a ragged last tile."""
    idx = _bit_codes(m, 5000, 4)
    cells = (np.random.default_rng(1).random(m) < 0.01).astype(np.uint8)
    sorted_codes, starts = ik.sort_codes(torch.from_numpy(idx), m, 0, ik.BITS_TILE)
    g = -(-m // ik.BITS_TILE)
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(sorted_codes.numpy(), np.arange(g + 1) * ik.BITS_TILE))
    want = ik.bits_insert_segmented_plain(torch.from_numpy(cells),
                                          torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(
        _emulate_seg_kernel(sorted_codes.numpy(), starts.numpy(), cells.astype(np.int32),
                            ik.BITS_TILE, 0).astype(np.uint8), want)


def test_tile_bounds_stay_in_int32_for_the_largest_arrays():
    codes = torch.tensor([0, 5, ik.MAX_SEGMENT_CELLS - 1, ik.MAX_SEGMENT_CELLS],
                         dtype=torch.int32)
    _, starts = ik.sort_codes(codes, ik.MAX_SEGMENT_CELLS, 0, ik.BITS_TILE)
    assert starts.dtype == torch.int32
    assert starts[0] == 0 and starts[-1] == 3  # the sentinel lies in no span
    assert (starts[1:] >= starts[:-1]).all()


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
        ik.seg_insert_launch(torch.zeros(M, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.int32),
                             torch.zeros(M // ik.TILE + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ok.merge_stack(torch.zeros((4, M), dtype=torch.int64))
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
