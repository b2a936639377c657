"""On-card tests of the hand-written CUDA kernels and the client (marker
`cuda`): each kernel against its plain version at the main path's shapes
(segmented insert, merge_stack, popcount partials, bitop, the segment-OR
and its edge cases, delta_merge, window_merge), and the client (HLL,
Bloom, BitSet, the delta / tape / hostfold ingest) on the card against the
client on the CPU. They skip where no card is visible. Run them on a
machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which such a machine
need not have.)
"""

import numpy as np
import pytest
import torch

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ingest import kernels as ik
from redisson_tpu_torch.ops import kernels as ok
from redisson_tpu_torch.ops import window_kernel as wk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,case,m", [(1 << 21, "uniform", 16384), (1 << 16, "hot", 16384),
                                      (0, "uniform", 16384), (40_000, "uniform", 16384),
                                      (40_003, "uniform", 16384),
                                      (1 << 16, "all_invalid", 16384),
                                      (1 << 16, "no_raise", 16384),
                                      (1 << 21, "no_raise", 16384), (1 << 21, "hot", 16384),
                                      ((1 << 18) + 5, "uniform", 16384),
                                      (1 << 20, "uniform", 1 << 15),
                                      (1 << 20, "uniform", 1 << 16)])
def test_seg_insert_matches_plain(dev, n, case, m):
    """Both kernels (`seg_plan`: direct up to 2^17 pairs and for m > 2^15,
    shared above), registers and flag."""
    g = torch.Generator(device=dev).manual_seed(n)
    regs = torch.randint(0, 20, (m,), dtype=torch.int32, device=dev, generator=g)
    bucket = torch.randint(0, m, (n,), dtype=torch.int32, device=dev, generator=g)
    if case == "hot":
        bucket.fill_(77)
    rank = torch.randint(0, 52, (n,), dtype=torch.int32, device=dev, generator=g)
    if case == "all_invalid":
        rank.zero_()
    elif case == "no_raise":  # the registers already hold the batch
        regs.scatter_reduce_(0, bucket.long(), rank, reduce="amax")
    want = regs.clone()
    want_flag = torch.zeros((1,), dtype=torch.bool, device=dev)
    ik.hll_insert_segmented_plain(want, bucket, rank, want_flag)
    flag = torch.zeros((1,), dtype=torch.bool, device=dev)
    before = ik.launches["seg_insert"]
    got = ik.hll_insert_segmented(regs, bucket, rank, flag)
    assert got is regs  # in place
    assert torch.equal(regs, want) and torch.equal(flag, want_flag)
    assert bool(flag) == (case in ("uniform", "hot") and n > 0)
    assert ik.launches["seg_insert"] == before + (1 if n else 0)


def test_seg_insert_writes_a_bank_rows_flag(dev):
    """A bank row and its slot of the [S] flags, as `_bank_add_row` passes
    them; the other rows and flags stay as they were."""
    g = torch.Generator(device=dev).manual_seed(5)
    bank = torch.randint(0, 20, (4, 16384), dtype=torch.int32, device=dev, generator=g)
    bucket = torch.randint(0, 16384, (1 << 20,), dtype=torch.int32, device=dev, generator=g)
    rank = torch.randint(0, 52, (1 << 20,), dtype=torch.int32, device=dev, generator=g)
    rank[: 1 << 16] += 12  # the second batch still raises some registers
    want = bank.clone()
    for n in (1 << 16, 1 << 20):  # the direct and the shared kernel
        changed = torch.zeros(4, dtype=torch.bool, device=dev)
        ik.hll_insert_segmented(bank[2], bucket[:n], rank[:n], changed[2:3])
        ik.hll_insert_segmented_plain(want[2], bucket[:n], rank[:n])
        assert torch.equal(bank, want)
        assert changed.tolist() == [False, False, True, False]


@pytest.mark.parametrize("s", [1024, 1000, 256, 5, 0])
def test_merge_stack_matches_plain(dev, s):
    g = torch.Generator(device=dev).manual_seed(s)
    stack = torch.randint(0, 52, (s, 16384), dtype=torch.int32, device=dev, generator=g)
    before = ok.launches["merge_stack"]
    assert torch.equal(ok.merge_stack(stack), ok.merge_stack_plain(stack))
    assert ok.launches["merge_stack"] == before + (1 if s else 0)


@pytest.mark.parametrize("threads,cluster", [(64, 4), (64, 16), (128, 8), (128, 9),
                                             (128, 16), (256, 12), (256, 8)])
@pytest.mark.parametrize("s", [256, 1024, 3, 1001])
def test_merge_stack_grids_match_plain(dev, threads, cluster, s):
    """Grids chip_smoke.py probes (strip width, cluster size up to the
    non-portable 16) give the plain version's merge."""
    g = torch.Generator(device=dev).manual_seed(s + threads)
    stack = torch.randint(0, 52, (s, 16384), dtype=torch.int32, device=dev, generator=g)
    plan = ok.merge_plan(s, 16384, threads, cluster)
    out = torch.full((16384,), -1, dtype=torch.int32, device=dev)
    rc = ok._kernel("merge_stack_i32")(stack.data_ptr(), None, out.data_ptr(), s, s, 16384,
                                       *plan, 0, 0, ok._stream(stack))
    assert rc == 0
    assert torch.equal(out, ok.merge_stack_plain(stack))


@pytest.mark.parametrize("n,case", [(1 << 21, "uniform"), (1 << 21, "no_raise"),
                                    (32_771, "uniform"), (32_771, "out_of_range"),
                                    (1 << 16, "hot"), (0, "uniform")])
def test_seg_insert_rows_matches_plain(dev, n, case):
    """The multi-target form at a config 3 chunk (2^21 lanes over 256
    rows) and a window of small PFADDs: registers and per-row flags."""
    g = torch.Generator(device=dev).manual_seed(n + len(case))
    s, m = 300, 16384
    bank = torch.randint(0, 20, (s, m), dtype=torch.int32, device=dev, generator=g)
    bucket = torch.randint(0, m, (n,), dtype=torch.int32, device=dev, generator=g)
    rank = torch.randint(0, 52, (n,), dtype=torch.int32, device=dev, generator=g)
    rows = torch.randint(0, 256, (n,), dtype=torch.int32, device=dev, generator=g)
    if case == "hot":
        bucket.fill_(77)
        rows.fill_(3)
    elif case == "no_raise":
        bank.view(-1).scatter_reduce_(0, rows.long() * m + bucket.long(), rank,
                                      reduce="amax")
    elif case == "out_of_range":
        bucket[::7] = m
        rows[1::7] = s
        rows[2::7] = -1
    want = bank.clone()
    want_changed = torch.zeros(s, dtype=torch.bool, device=dev)
    ik.hll_insert_segmented_rows_plain(want, bucket, rank, rows, want_changed)
    changed = torch.zeros(s, dtype=torch.bool, device=dev)
    before = ik.launches["seg_insert"]
    assert ik.hll_insert_segmented_rows(bank, bucket, rank, rows, changed) is bank
    assert torch.equal(bank, want) and torch.equal(changed, want_changed)
    assert bool(changed.any()) == (case != "no_raise" and n > 0)
    assert ik.launches["seg_insert"] == before + (1 if n else 0)


@pytest.mark.parametrize("height,r", [(300, 257), (1100, 1001), (300, 2), (8, 0)])
def test_merge_stack_over_bank_rows_matches_plain(dev, height, r):
    """The client's merges at the paths' shapes: 257 rows of a bank (config
    3's 256 and the target), 1001 (the HLL path's 1000 and the target),
    with repeats."""
    g = torch.Generator(device=dev).manual_seed(r)
    bank = torch.randint(0, 52, (height, 16384), dtype=torch.int32, device=dev, generator=g)
    rows = torch.randint(0, height, (r,), dtype=torch.int32, device=dev, generator=g)
    assert torch.equal(ok.merge_stack(bank, rows), ok.merge_stack_plain(bank, rows))


@pytest.mark.parametrize("form", ["numpy", "cpu tensor", "device"])
@pytest.mark.parametrize("r", [1, 2, 16, 257, 1001]
                         + [c + d for c in ok.ROW_CAPACITIES for d in (-1, 0, 1)])
def test_merge_stack_over_host_rows_matches_plain(dev, form, r):
    """The row list by value (host forms up to the largest capacity, a
    device tensor past it) or as a device tensor, with repeats: one launch,
    the plain version's merge."""
    g = torch.Generator(device=dev).manual_seed(r)
    bank = torch.randint(0, 52, (1100, 16384), dtype=torch.int32, device=dev, generator=g)
    rows = torch.randint(0, 1100, (r,), dtype=torch.int32, device=dev, generator=g)
    want = ok.merge_stack_plain(bank, rows)
    given = {"numpy": rows.cpu().numpy(), "cpu tensor": rows.cpu(), "device": rows}[form]
    before = ok.launches["merge_stack"]
    assert torch.equal(ok.merge_stack(bank, given), want)
    assert ok.launches["merge_stack"] == before + 1


@pytest.mark.parametrize("form", ["numpy", "device"])
@pytest.mark.parametrize("r", [5, 64, 1001, 8001])
def test_merge_stack_skips_rows_out_of_range(dev, form, r):
    """A listed row outside [0, height) is skipped in every form; rows all
    out of range merge to zeros."""
    g = torch.Generator(device=dev).manual_seed(r + 7)
    height = 300
    bank = torch.randint(0, 52, (height, 16384), dtype=torch.int32, device=dev, generator=g)
    rows = torch.randint(0, height, (r,), dtype=torch.int32, device=dev, generator=g)
    rows[::3] = height
    rows[1::5] = -1
    rows[2::7] = 1 << 30
    kept = rows[(rows >= 0) & (rows < height)]
    given = rows.cpu().numpy() if form == "numpy" else rows
    assert torch.equal(ok.merge_stack(bank, given), ok.merge_stack_plain(bank, kept))
    none = torch.full((r,), -3, dtype=torch.int32, device=dev)
    given = none.cpu().numpy() if form == "numpy" else none
    assert not ok.merge_stack(bank, given).any()


def test_client_merges_launch_once_and_copy_no_rows(dev):
    """Ten client PFMERGEs over 256 sketches: one merge_stack kernel each,
    no memset and no host-to-device copy (the row list goes by value)."""
    from torch.profiler import ProfilerActivity, profile

    c = RedissonTorch.create(Config().use_cuda(ingest="scatter"))
    try:
        names = [f"m:{i}" for i in range(256)]
        rng = np.random.default_rng(5)
        for n in names:
            c.get_hyper_log_log(n).add_ints(rng.integers(0, 2**63, 500, np.uint64))
        dest = c.get_hyper_log_log("m:dest")
        dest.merge_with(*names)  # creates the target row and warms the path
        torch.cuda.synchronize()
        before = ok.launches["merge_stack"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                dest.merge_with(*names)
            torch.cuda.synchronize()
        keys = {e.key: e.count for e in prof.key_averages()}
        assert ok.launches["merge_stack"] == before + 10
        assert sum(n for k, n in keys.items() if "merge_kernel" in k) == 10, keys
        assert not [k for k in keys if "Memset" in k or "HtoD" in k], keys
    finally:
        c.shutdown()


@pytest.mark.parametrize("n", [1 << 27, 257_296_945, 1_000_003, 0])
def test_popcount_matches_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    cells = (torch.rand(n, device=dev, generator=g) < 0.3).to(torch.uint8)
    before = ok.launches["popcount_partials"]
    got = ok.popcount_partials(cells)
    assert torch.equal(got, ok.popcount_partials_plain(cells))
    assert ok.launches["popcount_partials"] == before + (1 if n else 0)
    # A view at an odd offset is copied to an aligned buffer, not refused.
    if n:
        assert torch.equal(ok.popcount_partials(cells[1:]),
                           ok.popcount_partials_plain(cells[1:]))


@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("k,n", [(8, 1 << 27), (3, 1_000_003), (1, 4096)])
def test_bitop_matches_plain(dev, op, k, n):
    g = torch.Generator(device=dev).manual_seed(k + n)
    stack = (torch.rand((k, n), device=dev, generator=g) < 0.5).to(torch.uint8)
    assert torch.equal(ok.bitop_cells(stack, op), ok.bitop_cells_plain(stack, op))


@pytest.mark.parametrize("m", [257_296_945, 1_000_003, 4096])
def test_segment_or_matches_plain(dev, m):
    g = torch.Generator(device=dev).manual_seed(m)
    cells = (torch.rand(m, device=dev, generator=g) < 0.01).to(torch.uint8)
    n = (1 << 21) * 7
    idx = torch.randint(0, m, (n,), device=dev, generator=g)
    idx[: n // 10] = idx[n // 10: 2 * (n // 10)]  # duplicates
    idx[torch.rand(n, device=dev, generator=g) < 0.1] = m  # sentinels
    want = ik.bits_insert_segmented_plain(cells.clone(), idx)
    before = ik.launches["bits_insert_segmented"]
    got = ik.bits_insert_segmented(cells, idx)
    assert got.data_ptr() == cells.data_ptr()  # in place
    assert torch.equal(got, want)
    assert ik.launches["bits_insert_segmented"] == before + 1


def _segment_or_case(dev, case):
    """(cells, idx) of one edge case of the segment-OR."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    m = {"below_one_slab": 40_000, "ragged_m": 3 * (1 << 16) + 9,
         "full_width": 257_296_945}.get(case, 200_003)
    cells = (torch.rand(m + 1, device=dev, generator=g) < 0.02).to(torch.uint8)
    cells = cells[1:] if case == "odd_offset_view" else cells[:m]
    n = (1 << 21) * 7 if case == "full_width" else 50_000
    idx = torch.randint(0, m, (n,), device=dev, generator=g)
    if case == "no_codes":
        idx = idx[:0]
    elif case == "only_sentinels":
        idx.fill_(m)
    elif case in ("negative_codes", "int32_codes"):
        idx[::3] = -torch.randint(1, 1 << 30, (idx[::3].numel(),), device=dev,
                                  generator=g)
        if case == "int32_codes":
            idx = idx.to(torch.int32)
    elif case == "hot_cell":
        idx.fill_(m - 1)
    elif case == "ragged_m":
        idx[:100] = m - 1 - torch.arange(100, device=dev)  # the ragged tail
    elif case == "full_width":
        idx[: n // 10] = idx[n // 10: 2 * (n // 10)]  # duplicates
        idx[torch.rand(n, device=dev, generator=g) < 0.05] = m  # sentinels
    return cells, idx


@pytest.mark.parametrize("case", ["no_codes", "only_sentinels", "negative_codes",
                                  "int32_codes", "hot_cell", "below_one_slab", "ragged_m",
                                  "odd_offset_view", "full_width"])
def test_segment_or_edge_cases(dev, case):
    cells, idx = _segment_or_case(dev, case)
    want = ik.bits_insert_segmented_plain(cells.clone(), idx)
    before = ik.launches["bits_insert_segmented"]
    got = ik.bits_insert_segmented(cells, idx)
    torch.cuda.synchronize()
    assert got is cells and torch.equal(cells, want)
    assert ik.launches["bits_insert_segmented"] == before + (1 if idx.numel() else 0)
    if case == "only_sentinels":
        assert torch.equal(want, _segment_or_case(dev, case)[0])


def test_bloom_and_bitset_on_card_match_cpu(dev):
    out = []
    for device in ("cuda:0", "cpu"):
        c = RedissonTorch.create(Config().use_cuda(device=device, ingest="segment"))
        try:
            f = c.get_bloom_filter("f")
            f.try_init(1_000_000, 0.01)
            keys = np.arange(3_000_000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            added = f.add_ints(keys[:1_000_000])
            b = c.get_bit_set("b")
            old = b.set_bits(np.arange(0, 1 << 22, 3))
            c.get_bit_set("w").or_("b")
            out.append((added, old, f.contains_count_ints(keys), f.count(),
                        b.cardinality(), c.to_numpy_objects()))
        finally:
            c.shutdown()
    (ga, go, gn, gc, gb, gobj), (ca, co, cn, cc, cb, cobj) = out
    np.testing.assert_array_equal(ga, ca)
    np.testing.assert_array_equal(go, co)
    assert (gn, gc, gb) == (cn, cc, cb)
    for name in cobj:
        np.testing.assert_array_equal(gobj[name][1], cobj[name][1])


def test_client_on_card_matches_cpu(dev):
    regs = []
    for device in ("cuda:0", "cpu"):
        c = RedissonTorch.create(Config().use_cuda(device=device, ingest="segment"))
        try:
            h = c.get_hyper_log_log("h")
            assert h.add_ints(np.arange(3_000_000, dtype=np.uint64))
            h.add_all([f"k{i}" for i in range(1000)])
            regs.append(c._executor.execute_sync("h", "hll_export", None)[0])
        finally:
            c.shutdown()
    np.testing.assert_array_equal(regs[0], regs[1])


def _cells(dev, shape, seed, high=65):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, high, shape, dtype=torch.uint8, device=dev, generator=g)


def _merge_stacks(dev, t, l):
    """old and delta stacks: random rows, and for t >= 2 a row that cannot
    rise and a row in which only the last cell (of the last sector) rises."""
    high = 65 if l == 16384 else 2
    old, delta = _cells(dev, (t, l), t, high), _cells(dev, (t, l), l, high)
    if t >= 2:
        quiet, last = 1, (2 if t >= 3 else 0)
        delta[quiet] = 0
        old[last].fill_(1)
        delta[last] = 0
        old[last, -1], delta[last, -1] = 0, 1
    return old, delta


@pytest.mark.parametrize("t,l", [(256, 16384), (1, 1 << 28), (3, 1024), (64, 1 << 20),
                                 (2, 16)])
def test_delta_merge_matches_plain(dev, t, l):
    old, delta = _merge_stacks(dev, t, l)
    want_old, want = ok.delta_merge_plain(old.clone(), delta)
    before = ok.launches["delta_merge"]
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    got_old, got = ok.delta_merge(old, delta)
    # The one allocation of the call is the flag tensor it returns.
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert got.dtype == torch.bool and got.shape == (t,)
    assert got_old.data_ptr() == old.data_ptr()  # in place
    assert torch.equal(got_old, want_old) and torch.equal(got, want)
    assert ok.launches["delta_merge"] == before + 1
    if t >= 2:
        assert not got[1] and got[2 if t >= 3 else 0]


def _tape(dev, t, lanes, width, seed):
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 4, t).astype(np.int32)
    lengths = rng.integers(0, lanes + 1, t).astype(np.int32)
    lengths[ops == wk.OP_PAD] = 0
    lengths[: t // 4] = lanes - rng.integers(0, 8, t // 4)  # not a multiple of 8
    ops[-1], lengths[-1] = wk.OP_HLL, 0  # a real row of length 0
    ops[0], lengths[0] = wk.OP_BLOOM, min(lanes, 13)  # ends inside the first vector
    table = np.stack([ops, rng.integers(-1, 9, t), rng.integers(-10**6, 10**6, t),
                      lengths, np.zeros(t)], axis=1).astype(np.int32)
    old = torch.from_numpy(rng.integers(0, 2, (t, lanes)).astype(np.uint8)).to(dev)
    wire = torch.from_numpy(rng.integers(0, 256, (t, width)).astype(np.uint8)).to(dev)
    return old, wire, torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("t,lanes,width", [(64, 1 << 20, 1 << 17), (256, 16384, 16384),
                                           (8, 4096, 128), (4, 2048, 4096),
                                           (4, 1024, 100), (2, 16, 16), (2, 16, 2),
                                           (3, 1 << 17, 1 << 14)])
def test_window_merge_matches_plain(dev, t, lanes, width):
    old, wire, table = _tape(dev, t, lanes, width, t + lanes)
    want_old, want = wk.window_merge_plain(old.clone(), wire, table)
    before = wk.launches["window_merge"]
    got_old, got = wk.window_merge(old, wire, table)
    assert got.dtype == torch.bool and got.shape == (t,)
    assert got_old.data_ptr() == old.data_ptr()  # in place
    assert torch.equal(got_old, want_old) and torch.equal(got, want)
    assert not got[-1]  # a row of length 0 cannot rise
    assert wk.launches["window_merge"] == before + 1


def test_delta_ingest_on_card_matches_cpu(dev):
    out = []
    for device in ("cuda:0", "cpu"):
        per_mode = []
        for ingest in ("delta", "tape", "hostfold"):
            c = RedissonTorch.create(Config().use_cuda(device=device, ingest=ingest))
            try:
                h = c.get_hyper_log_log("h")
                flags = [h.add_ints(np.arange(i, 300_000, 7, dtype=np.uint64))
                         for i in range(3)]
                f = c.get_bloom_filter("f")
                f.try_init(100_000, 0.01)
                added = f.add_ints(np.arange(30_000, dtype=np.uint64))
                b = c.get_bit_set("b")
                old = b.set_bits(np.arange(0, 1 << 20, 5))
                c._executor.execute_sync("f", "bloom_sync", None)
                regs = c._executor.execute_sync("h", "hll_export", None)[0]
                per_mode.append((flags, added, old, regs, c.to_numpy_objects()))
            finally:
                c.shutdown()
        out.append(per_mode)
    for card, cpu in zip(*out):
        for a, b in zip(card[:4], cpu[:4]):
            np.testing.assert_array_equal(a, b)
        for name in cpu[4]:
            np.testing.assert_array_equal(card[4][name][1], cpu[4][name][1])


def test_rbatch_over_256_sketches_on_card_matches_cpu(dev):
    """BASELINE config 3's shape at 2,000 keys per sketch: the batched
    PFADD on the card (segmented insert) and the PFMERGE + PFCOUNT over the
    256 (merge_stack) leave the bank the CPU client's batch leaves."""
    rng = np.random.default_rng(3)
    keys = [[k.tobytes() for k in rng.integers(0, 2**63, 2000, np.uint64)]
            for _ in range(256)]
    names = [f"b3:s{i}" for i in range(256)]
    out = []
    for device in ("cuda:0", "cpu"):
        c = RedissonTorch.create(Config().use_cuda(device=device, ingest="segment"))
        try:
            seg0, mrg0 = ik.launches["seg_insert"], ok.launches["merge_stack"]
            batch = c.create_batch()
            for n, k in zip(names, keys):
                batch.get_hyper_log_log(n).add_all_async(k)
            flags = batch.execute()
            union = c.get_hyper_log_log("b3:merged").merge_with_and_count(*names)
            bank, rows = c.to_numpy_state()
            out.append((flags, union, {n: bank[rows[n]] for n in names + ["b3:merged"]}))
            if device != "cpu":
                assert ik.launches["seg_insert"] > seg0
                assert ok.launches["merge_stack"] > mrg0
        finally:
            c.shutdown()
    (gflags, gunion, grows), (cflags, cunion, crows) = out
    assert gflags == cflags == [True] * 256
    assert gunion == cunion
    for n in grows:
        np.testing.assert_array_equal(grows[n], crows[n], err_msg=n)
