"""On-card tests of the hand-written CUDA kernels and the client (marker
`cuda`): each kernel against its plain version at the main path's shapes
(segmented insert, merge_stack, popcount partials, bitop, the segment-OR
and its edge cases, delta_merge, window_merge), and the client (HLL,
Bloom, BitSet, the delta / tape / hostfold ingest) on the card against the
client on the CPU; persistence, the snapshot cut, add_device replay and a
real out-of-memory error on the card; the served, traced path against the
CPU, the (hi, lo) PFADD under segment, the memory gate shedding a SETBIT
at the high watermark before it allocates, xxhash64 and bitpos on the card against the CPU and
numpy; a journal follower and a two-replica fleet on the card (replay
through seg_insert and the segment-OR, replica reads through merge_stack
and popcount, state equal to the primary's, a failover losing no
acknowledged write); a 4-shard cluster facade on cuda:0 against a CPU
cluster, and PFADDs over its RESP servers against an in-process client on
the card; geo-sized planes through delta_merge, and a geo pair on the card
against a geo pair on the CPU; the redis durability tier flushing the
card's HLL rows, a Bloom filter and a BitSet to the embedded RESP server
and loading them back onto the card, and load_hll under both hash
families; the pod tier's per-shard launches (insert, merge-all, BITCOUNT
past 2^31 set bits on a 2^32-cell array, BITOP, Bloom add) on 4 logical
shards of cuda:0 against the plain versions, a pod client and a mesh-plane
merge+count on the card against the CPU. They skip where no card is
visible. Run them on a
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
from redisson_tpu_torch.ops.crc16 import key_slot

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


# -- durability and faults on the card ---------------------------------------


def _persist_client(path, ingest="segment", **fault_kw):
    cfg = Config()
    cfg.use_cuda(ingest=ingest)
    cfg.use_persist(str(path), fsync="always")
    if fault_kw:
        cfg.use_faults(**fault_kw)
    return RedissonTorch.create(cfg)


def _sketches(c):
    """name -> registers or cells of every sketch, through the executor."""
    out = {}
    for n in sorted(c.keys()):
        if n in c.sketch.bank_names():
            out[n] = c._executor.execute_sync(n, "hll_export", None)[0].tobytes()
        else:
            out[n] = c._executor.execute_sync(n, "bits_export", None)[1].tobytes()
    return out


def test_persist_round_trip_on_card(dev, tmp_path):
    """Journaled PFADD / Bloom / SETBIT on the card, a snapshot and a
    suffix, recovered by a new client: state equal to the live client's,
    and the recovery ran seg_insert and the segment-OR on the card."""
    import shutil

    rng = np.random.default_rng(3)
    c = _persist_client(tmp_path / "lead")
    try:
        for i in range(8):
            c.get_hyper_log_log(f"h{i}").add_ints(
                rng.integers(0, 2**63, 40_000, dtype=np.uint64))
        bf = c.get_bloom_filter("bf")
        bf.try_init(1_000_000, 0.01)
        bf.add_ints(rng.integers(0, 2**63, 100_000, dtype=np.uint64))
        bits = c.get_bit_set("day")
        bits.set(1 << 20, True)
        c.snapshot_now()
        for i in range(8):
            c.get_hyper_log_log(f"h{i}").add_ints(
                rng.integers(0, 2**63, 40_000, dtype=np.uint64))
        bf.add_ints(rng.integers(0, 2**63, 100_000, dtype=np.uint64))
        for off in rng.integers(0, 1 << 20, 50):
            bits.set(int(off), True)
        c.persist.journal.sync()
        want = _sketches(c)
        shutil.copytree(tmp_path / "lead", tmp_path / "img")
    finally:
        c.shutdown()
    ik.reset_launches()
    r = _persist_client(tmp_path / "img")
    try:
        assert r.persist.last_recovery["replay_errors"] == 0
        assert ik.launches["seg_insert"] > 0
        assert ik.launches["bits_insert_segmented"] > 0
        assert _sketches(r) == want
    finally:
        r.shutdown()


def test_snapshot_cut_holds_against_in_place_kernels(dev, tmp_path, monkeypatch):
    """The segment-OR and SETBIT write the card's cell tensors in place; a
    snapshot whose host copies are taken after more such writes still
    equals the journal prefix at its watermark."""
    from redisson_tpu_torch.persist import snapshotter as snap_mod
    from redisson_tpu_torch.persist.journal import iter_records

    rng = np.random.default_rng(5)
    c = _persist_client(tmp_path / "lead")
    bf = c.get_bloom_filter("bf")
    bf.try_init(1_000_000, 0.01)
    bits = c.get_bit_set("bits")

    def traffic(n):
        futs = []
        for _ in range(n):
            futs.append(bf.add_ints_async(rng.integers(0, 2**63, 50_000, dtype=np.uint64)))
            futs.append(c._executor.execute_async(
                "bits", "bitset_set" if rng.random() < 0.5 else "bitset_clear",
                {"idx": rng.integers(0, 1 << 20, 4096).astype(np.int64)}, nkeys=4096))
        for f in futs:
            f.result()

    bits.set((1 << 20) - 1, True)
    traffic(10)
    c.persist.journal.sync()
    records = list(iter_records(str(tmp_path / "lead")))
    real = snap_mod.Snapshotter._host_objects
    monkeypatch.setattr(snap_mod.Snapshotter, "_host_objects",
                        staticmethod(lambda cut: (traffic(10), real(cut))[1]))
    try:
        snap = c.snapshot_now()
    finally:
        c.shutdown()
    ref = RedissonTorch.create(Config().use_cuda(ingest="scatter"))
    got = RedissonTorch.create(Config().use_cuda(ingest="scatter"))
    try:
        for rec in records:
            ref._executor.execute_sync(rec.target, rec.kind, rec.payload)
        got.load_checkpoint(snap)
        assert _sketches(got) == _sketches(ref)
    finally:
        ref.shutdown()
        got.shutdown()


def test_add_device_journaled_and_recovered(dev, tmp_path):
    """A CUDA key tensor is journaled as its host copy and replayed onto the
    card: the recovered row equals the live one."""
    import shutil

    c = _persist_client(tmp_path / "lead")
    try:
        keys = torch.randint(-(2**62), 2**62, (200_000,), dtype=torch.int64, device=dev)
        h = c.get_hyper_log_log("dev")
        h.add_device(keys)
        c.persist.journal.sync()
        want = _sketches(c)
        count = h.count()
        shutil.copytree(tmp_path / "lead", tmp_path / "img")
    finally:
        c.shutdown()
    r = _persist_client(tmp_path / "img")
    try:
        assert r.persist.last_recovery["replayed"] == 1
        assert _sketches(r) == want
        assert r.get_hyper_log_log("dev").count() == count
    finally:
        r.shutdown()


def test_real_oom_is_retryable_and_not_sticky(dev, tmp_path):
    """A SETBIT whose offset needs a bitmap larger than the card's free
    memory raises torch.cuda.OutOfMemoryError inside the run; it comes out
    of the op path as a RetryableFault, and the next PFADD succeeds."""
    from redisson_tpu_torch.fault.taxonomy import RetryableFault

    c = _persist_client(tmp_path / "p", plan=[])
    try:
        h = c.get_hyper_log_log("h")
        h.add_ints(np.arange(1000, dtype=np.uint64))
        free, _total = torch.cuda.mem_get_info(dev)
        with pytest.raises(RetryableFault) as info:
            c.get_bit_set("huge").set(2 * free, True)  # one byte per bit
        assert isinstance(info.value.cause, torch.cuda.OutOfMemoryError)
        assert h.add_ints(np.arange(1000, 2000, dtype=np.uint64))
    finally:
        c.shutdown()


def _served(device, **mem):
    cfg = Config()
    cfg.use_cuda(device=device, ingest="segment")
    cfg.use_serve()
    cfg.use_trace(sample_every=1)
    cfg.use_memstat(**mem)
    return RedissonTorch.create(cfg)


def test_served_path_on_card_matches_cpu(dev):
    """The served, traced PFADD / PFCOUNT / PFMERGE path on the card: rows
    and replies equal the same client on the CPU, seg_insert and
    merge_stack launched, the ledger without drift."""
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, 2**63, 40_000, dtype=np.uint64) for _ in range(8)]
    got = {}
    ik.reset_launches()
    ok.reset_launches()
    for device in ("cuda:0", "cpu"):
        c = _served(device)
        try:
            with c.serve.tenant("t1"):
                futs = [c.get_hyper_log_log(f"s{i}").add_ints_async(b)
                        for i, b in enumerate(batches)]
                flags = [f.result() for f in futs]
            counts = [c.get_hyper_log_log(f"s{i}").count() for i in range(8)]
            union = c.get_hyper_log_log("u").merge_with_and_count(
                *[f"s{i}" for i in range(8)])
            assert c.memory_verify()["ok"]
            assert c.trace.snapshot()["tracer"]["sampled"] >= 17
            got[device] = (flags, counts, union, c.to_numpy_state())
        finally:
            c.shutdown()
    assert ik.launches["seg_insert"] and ok.launches["merge_stack"]
    card, cpu = got["cuda:0"], got["cpu"]
    assert card[:3] == cpu[:3]
    (cb, cr), (pb, pr) = card[3], cpu[3]
    for n in pr:
        np.testing.assert_array_equal(cb[cr[n]], pb[pr[n]])


def test_hilo_payload_under_segment_on_card(dev):
    keys = np.random.default_rng(22).integers(0, 2**64, 40_000, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    c = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    try:
        ik.reset_launches()
        assert c._executor.execute_sync("a", "hll_add", {"hi": hi, "lo": lo}, 40_000)
        torch.cuda.synchronize()
        assert ik.launches["seg_insert"] >= 1
        c.get_hyper_log_log("b").add_ints(keys)
        a = c._executor.execute_sync("a", "hll_export", None)[0]
        b = c._executor.execute_sync("b", "hll_export", None)[0]
        np.testing.assert_array_equal(a, b)
    finally:
        c.shutdown()


def test_watermark_sheds_setbit_before_it_allocates_on_card(dev):
    from redisson_tpu_torch.serve.errors import RejectedError

    c = _served("cuda:0", high_watermark_bytes=1 << 50,
                include_overhead=False)
    try:
        c.get_bit_set("a").set((1 << 25) - 1)
        live = c.memstat.live_bytes()
        c._pressure.config.high_watermark_bytes = live  # at the mark
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # frees blocks whose last use waits on an event
        before = torch.cuda.memory_allocated()
        with pytest.raises(RejectedError) as ei:
            c.get_bit_set("b").set((1 << 25) - 1)
        assert ei.value.reason == "memory"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() == before
        device = c._pressure.snapshot()["device"]
        free, total = torch.cuda.mem_get_info()
        assert device["source"] == "torch.cuda" and device["total_bytes"] == total
        assert 0 < device["free_bytes"] <= total
        assert c.get_bit_set("a").cardinality() == 1  # reads flow
        c.delete("a")
        c.get_bit_set("b").set((1 << 25) - 1)
        assert c.memory_verify()["ok"]
    finally:
        c.shutdown()


@pytest.mark.parametrize("width", [8, 33, 72])
def test_xxhash64_on_card_matches_cpu(dev, width):
    from redisson_tpu_torch.ops import hashing

    rng = np.random.default_rng(width)
    n = 1 << 20
    data = torch.from_numpy(rng.integers(0, 256, (n, width), dtype=np.uint8))
    lengths = torch.from_numpy(rng.integers(0, width + 1, n).astype(np.int32))
    for seed in (0, 2**64 - 1):
        want = hashing.xxhash64(data, lengths, seed)
        got = hashing.xxhash64(data.to(dev), lengths.to(dev), seed)
        assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["empty", "ones", "sparse", "last"])
def test_bitpos_on_card_matches_numpy(dev, case):
    from redisson_tpu_torch.ops import bitset

    n = (1 << 27) + 12345  # a daily bitmap's width and a ragged last chunk
    cells = np.zeros(n, np.uint8)
    if case == "ones":
        cells[:] = 1
    elif case == "sparse":
        cells[np.random.default_rng(5).integers(1 << 20, n, 1000)] = 1
    elif case == "last":
        cells[n - 1] = 1
    t = torch.from_numpy(cells).to(dev)
    for value in (0, 1):
        hit = np.flatnonzero(cells == value)
        assert bitset.bitpos(t, value) == (int(hit[0]) if hit.size else -1)


def _fleet_writes(c, rng, tag: str):
    """HLL, Bloom and BitSet writes of one round; returns the HLL batches."""
    batches = [rng.integers(0, 2**64, 40_000, dtype=np.uint64) for _ in range(8)]
    for i, b in enumerate(batches):
        c.get_hyper_log_log(f"{tag}{i}").add_ints(b)
    bf = c.get_bloom_filter("bf")
    bf.try_init(1_000_000, 0.01)
    bf.add_ints(rng.integers(0, 2**64, 200_000, dtype=np.uint64))
    c.get_bit_set("day").set_bits(rng.integers(0, 1 << 24, 100_000))
    return batches


def _state(c):
    torch.cuda.synchronize()
    bank, rows = c.to_numpy_state()
    return {n: bank[r].copy() for n, r in rows.items()}, c.to_numpy_objects()


def _same_state(a, b):
    (ah, ao), (bh, bo) = a, b
    assert ah.keys() == bh.keys() and ao.keys() == bo.keys()
    for n in ah:
        np.testing.assert_array_equal(ah[n], bh[n])
    for n in ao:
        np.testing.assert_array_equal(ao[n][1], bo[n][1])


def test_follower_replays_through_the_kernels_on_card(dev, tmp_path):
    from redisson_tpu_torch.persist.follower import JournalFollower

    cfg = Config()
    cfg.use_cuda(ingest="segment")
    cfg.use_persist(str(tmp_path / "lead"), fsync="always")
    c = RedissonTorch.create(cfg)
    try:
        _fleet_writes(c, np.random.default_rng(41), "h")
        want = _state(c)
        last = c.persist.journal.last_seq
    finally:
        c.shutdown()
    ik.reset_launches()
    fcfg = Config()
    fcfg.use_cuda(ingest="segment")
    follower = JournalFollower(str(tmp_path / "lead"), config=fcfg,
                               poll_interval_s=0.005)
    try:
        promoted = follower.promote(catch_up=True, timeout_s=120)
        torch.cuda.synchronize()
        assert ik.launches["seg_insert"] and ik.launches["bits_insert_segmented"]
        assert follower.applied_seq == last and follower.lag() == 0
        assert promoted.device.type == "cuda"
        _same_state(_state(promoted), want)
    finally:
        follower.close()


def test_replica_fleet_on_card(dev, tmp_path):
    cfg = Config()
    cfg.use_cuda(ingest="segment")
    cfg.use_persist(str(tmp_path / "primary"), fsync="always")
    cfg.use_replicas(2, auto_failover=False, health_interval_s=0.0,
                     poll_interval_s=0.005)
    c = RedissonTorch.create(cfg)
    try:
        rng = np.random.default_rng(42)
        batches = _fleet_writes(c, rng, "h")
        assert c.wait_for_replicas(2, timeout_s=120) == 2
        want = _state(c)
        for rep in c.replicas.replicas:
            assert rep.client.device.type == "cuda"
            _same_state(_state(rep.client), want)
        ok.reset_launches()
        names = [f"h{i}" for i in range(8)]
        ex = c._executor
        union = c.get_hyper_log_log(names[0]).count_with(*names[1:])
        assert union == ex.execute_sync(names[0], "hll_count_with",
                                        {"names": names[1:]})
        bits = c.get_bit_set("day").cardinality()
        torch.cuda.synchronize()
        assert c._dispatch.replica_reads >= 2
        assert ok.launches["merge_stack"] and ok.launches["popcount_partials"]
        assert bits == int(np.count_nonzero(want[1]["day"][1]))
        # failover: fence, promote, retarget, every acknowledged write kept
        old = c.persist.journal
        promoted = c.replicas.failover("card drill")
        assert old.fenced and promoted.device.type == "cuda"
        assert promoted.persist.journal.last_seq == old.last_seq
        more = [rng.integers(0, 2**64, 40_000, dtype=np.uint64) for _ in range(2)]
        for i, b in enumerate(more):
            c.get_hyper_log_log(f"h{i}").add_ints(b)
        assert c.wait_for_replicas(1, timeout_s=120) == 1
        now = _state(promoted)
        _same_state(_state(c.replicas.replicas[0].client), now)
        ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
        try:
            for i, b in enumerate(batches):
                ref.get_hyper_log_log(f"h{i}").add_ints(b)
            for i, b in enumerate(more):
                ref.get_hyper_log_log(f"h{i}").add_ints(b)
            rbank, rrows = ref.to_numpy_state()
        finally:
            ref.shutdown()
        for n in names:
            np.testing.assert_array_equal(now[0][n], rbank[rrows[n]])
    finally:
        c.shutdown()



def _cluster_rows(c):
    """name -> registers of every HLL, read from the shard that owns it."""
    table = c.cluster.router.slot_table()
    out = {}
    for sid, shard in c.cluster.shards.items():
        bank, rows = shard.client.to_numpy_state()
        for name, row in rows.items():
            if table[key_slot(name)] == sid:
                out[name] = bank[row]
    return out


def test_cluster_facade_on_card_matches_cpu(dev):
    """`use_cluster()` with no compute section puts every shard on cuda:0;
    PFADDs routed per owner and a cross-shard PFMERGE land the same
    registers as a CPU cluster's, through seg_insert and merge_stack."""
    card = Config()
    card.use_cluster(num_shards=4)
    cpu = Config()
    cpu.use_cuda(device="cpu", ingest="sort")
    cpu.use_cluster(num_shards=4)
    rng = np.random.default_rng(43)
    batches = {n: rng.integers(0, 2**64, 40_000, dtype=np.uint64)
               for n in [f"hll:{i}" for i in range(32)] + ["{t}0", "{t}1"]}
    states, counts = [], []
    ik.reset_launches()
    ok.reset_launches()
    for cfg in (card, cpu):
        c = RedissonTorch.create(cfg)
        try:
            futs = [c.get_hyper_log_log(n).add_ints_async(b)
                    for n, b in batches.items()]
            [f.result() for f in futs]
            if cfg is card:
                for shard in c.cluster.shards.values():
                    assert shard.client.device == dev
                    assert shard.client.sketch.bank.device == dev
            names = list(batches)
            counts.append((c.get_hyper_log_log(names[0]).merge_with_and_count(
                *names[1:8]),
                c.get_hyper_log_log("{t}0").count_with("{t}1")))
            states.append(_cluster_rows(c))
        finally:
            c.shutdown()
    assert ik.launches["seg_insert"] and ok.launches["merge_stack"]
    assert set(states[0]) == set(states[1])
    for n in states[1]:
        np.testing.assert_array_equal(states[0][n], states[1][n], err_msg=n)
    assert abs(counts[0][0] - counts[1][0]) <= 1e-5 * counts[1][0]
    assert abs(counts[0][1] - counts[1][1]) <= 1e-5 * counts[1][1]


def test_wire_pfadd_on_card_matches_in_process(dev, tmp_path):
    """One RESP server per shard on the card: PFADDs pipelined to the owning
    servers (the port's own codec) land the registers an in-process client
    on the card gets from the same bytes; a wrong shard answers -MOVED."""
    import socket

    from redisson_tpu_torch.wire import proto

    cfg = Config()
    cfg.use_cluster(num_shards=4, dir=str(tmp_path / "cl"))
    cfg.use_wire()
    c = RedissonTorch.create(cfg)
    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    try:
        table = c.cluster.router.slot_table()
        rng = np.random.default_rng(44)
        keys = {f"w:{i}": [rng.bytes(12) for _ in range(400)] for i in range(64)}
        by_shard = {}
        for name, vals in keys.items():
            by_shard.setdefault(table[key_slot(name)], []).append(
                (b"PFADD", name.encode(), *vals))
            ref.get_hyper_log_log(name).add_all(vals)
        for sid, cmds in by_shard.items():
            host, _, port = c.wire.addr_of(sid).rpartition(":")
            with socket.create_connection((host, int(port)), timeout=30) as s:
                s.sendall(proto.resp_encode_pipeline(cmds))
                parser, got = proto.RespParser(), []
                while len(got) < len(cmds):
                    got.extend(parser.feed(s.recv(1 << 16)))
                parser.close()
                assert got == [1] * len(cmds)
        wrong = next(s for s in range(4) if s != table[key_slot("w:0")])
        host, _, port = c.wire.addr_of(wrong).rpartition(":")
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(proto.resp_encode(b"PFADD", b"w:0", b"x"))
            parser = proto.RespParser()
            frames = []
            while not frames:
                frames = parser.feed(s.recv(1 << 16))
            parser.close()
            assert str(frames[0]).startswith(f"MOVED {key_slot('w:0')} ")
        bank, rows = ref.to_numpy_state()
        got = _cluster_rows(c)
        for name in keys:
            np.testing.assert_array_equal(got[name], bank[rows[name]], err_msg=name)
    finally:
        ref.shutdown()
        c.shutdown()


@pytest.mark.parametrize("t,l", [(1088, 16384), (1, 1 << 27), (1, 1 << 28)])
def test_geo_plane_stacks_through_delta_merge_match_plain(dev, t, l):
    """The stacks a geo site's remote applies give delta_merge at phase
    21's widths: one site's 1088 HLL planes in one window, the 2^27-bit
    bitmap's plane and the Bloom filter's (m = 257,296,945, padded to
    2^28 lanes)."""
    old, delta = _merge_stacks(dev, t, l)
    want_old, want = ok.delta_merge_plain(old.clone(), delta)
    before = ok.launches["delta_merge"]
    got_old, got = ok.delta_merge(old, delta)
    assert torch.equal(got_old, want_old) and torch.equal(got, want)
    assert ok.launches["delta_merge"] == before + 1


def _geo_pair(root, device):
    from redisson_tpu_torch.geo import connect_sites

    sites = []
    for sid in ("A", "B"):
        cfg = Config()
        if device == "cpu":
            cfg.use_cuda(device="cpu")
        cfg.use_persist(str(root / device / sid), fsync="always")
        cfg.use_geo(sid, poll_interval_s=0.005)
        sites.append(RedissonTorch.create(cfg))
    connect_sites(sites)
    return sites


def test_geo_pair_on_card_matches_cpu_pair(dev, tmp_path):
    """Two geo sites on the card (the default config) converge to the
    state two sites on the CPU reach from the same writes, remote planes
    through delta_merge (geo_planes > 0, geo_classic == 0)."""
    from redisson_tpu_torch.geo import converge

    rng = np.random.default_rng(21)
    hll = [rng.integers(0, 1 << 62, size=20_000, dtype=np.int64).astype(np.uint64)
           for _ in range(8)]
    bloom = [rng.integers(0, 1 << 62, size=50_000, dtype=np.int64).astype(np.uint64)
             for _ in range(2)]
    bits = [rng.integers(0, 1 << 20, size=30_000) for _ in range(2)]
    states = {}
    for device in ("cpu", "cuda"):
        ok.reset_launches()
        sites = _geo_pair(tmp_path, device)
        try:
            for i, keys in enumerate(hll):
                sites[i % 2].get_hyper_log_log(f"h{i % 3}").add_ints(keys)
            for i, keys in enumerate(bloom):
                f = sites[i].get_bloom_filter("bf")
                f.try_init(200_000, 0.01)
                f.add_ints(keys)
            for i, idx in enumerate(bits):
                sites[i].get_bit_set("day").set_bits(idx)
            assert converge(sites, 60)
            states[device] = [
                {n: c.geo._export(n)[1] for n in ("h0", "h1", "h2", "bf", "day")}
                for c in sites]
            for c in sites:
                assert c.sketch.counters["geo_planes"] > 0
                assert c.sketch.counters["geo_classic"] == 0
            if device == "cuda":
                torch.cuda.synchronize()
                assert ok.launches["delta_merge"] > 0
        finally:
            for c in sites:
                c.shutdown()
    for i in range(2):
        for n, cells in states["cpu"][i].items():
            np.testing.assert_array_equal(states["cuda"][i][n], cells, err_msg=n)
            np.testing.assert_array_equal(states["cuda"][1 - i][n], cells, err_msg=n)


def _durable_pair(hll_hash, port):
    """A card client and a CPU client, both flushing to the server."""
    out = []
    for device in ("cuda:0", "cpu"):
        cfg = Config()
        cfg.use_cuda(device=device, hll_hash=hll_hash)
        cfg.use_redis().address = f"redis://127.0.0.1:{port}"
        out.append(RedissonTorch.create(cfg))
    return out


def _durable_fill(c):
    rng = np.random.default_rng(21)
    for i in range(4):
        c.get_hyper_log_log(f"d:h{i}").add_all(
            [b"u%d" % v for v in rng.integers(0, 10**6, 30_000)])
    bf = c.get_bloom_filter("d:bf")
    bf.try_init(expected_insertions=200_000, false_probability=0.01)
    bf.add_all([b"b%d" % i for i in range(100_000)])
    bs = c.get_bit_set("d:bs")
    for v in rng.integers(0, 1 << 20, 500):
        bs.set(int(v))


def test_durability_round_trip_on_card(dev):
    from redisson_tpu_torch.interop import hyll
    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis

    names = [f"d:h{i}" for i in range(4)]
    with EmbeddedRedis() as er:
        card, cpu = _durable_pair("murmur3", er.port)
        try:
            _durable_fill(card)
            _durable_fill(cpu)
            blobs = []
            for c in (card, cpu):
                assert c.durability.flush() == 6
                blobs.append({n: bytes(c.durability.client.execute("GET", n))
                              for n in names + ["d:bf", "d:bs"]})
            assert blobs[0] == blobs[1]  # the card's bytes are the CPU's
            for n in names:
                regs, _v = card._executor.execute_sync(n, "hll_export", None)
                assert np.array_equal(hyll.decode(blobs[0][n]), regs)
            card.flushall()
            for n in names:
                assert card.durability.load_hll(n)
            assert card.durability.load_bloom("d:bf")
            assert card.durability.load_bitset("d:bs")
            for n in ("d:bf", "d:bs"):
                assert card._store.get(n).state.device == dev
            assert card.get_bloom_filter("d:bf").contains_all(
                [b"b%d" % i for i in range(100_000)]).all()
            assert card.get_bit_set("d:bs").cardinality() == \
                cpu.get_bit_set("d:bs").cardinality()
            assert card.get_hyper_log_log(names[0]).count_with(*names[1:]) == \
                cpu.get_hyper_log_log(names[0]).count_with(*names[1:])
            card.durability.flush(only_dirty=True)  # the loads moved versions
            assert card.durability.flush(only_dirty=True) == 0
        finally:
            card.shutdown()
            cpu.shutdown()


@pytest.mark.parametrize("family", ["murmur3", "redis"])
def test_load_hll_under_both_families_on_card(dev, family):
    from redisson_tpu_torch.interop import hyll
    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis

    keys = [b"user:%d" % i for i in range(20_000)]
    with EmbeddedRedis(hll_hash=family) as er:
        card, cpu = _durable_pair(family, er.port)
        try:
            card.get_hyper_log_log("f:h").add_all(keys)
            card.flush_to_redis(["f:h"])
            blob = bytes(card.durability.client.execute("GET", "f:h"))
            assert hyll.blob_family(blob) == ("m3" if family == "murmur3" else "redis")
            card.durability.client.execute("PFADD", "f:srv", *keys[:2000])
            assert cpu.durability.load_hll("f:h")
            a, _ = card._executor.execute_sync("f:h", "hll_export", None)
            b, _ = cpu._executor.execute_sync("f:h", "hll_export", None)
            assert np.array_equal(a, b)
            card.get_hyper_log_log("f:srv").add_all(keys[:2000])
            mine, _ = card._executor.execute_sync("f:srv", "hll_export", None)
            srv = hyll.decode(card.durability.client.execute("GET", "f:srv"))
            assert np.array_equal(mine, srv)  # the server's fold is the card's
            assert card.durability.load_hll("f:srv", force=True)
        finally:
            card.shutdown()
            cpu.shutdown()


# -- the pod tier and the mesh data plane: 4 logical shards on cuda:0 ----------


def _mesh4(dev):
    from redisson_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(4)
    assert mesh.size == 4 and mesh.device == dev
    return mesh


def test_sharded_insert_and_merge_on_card_match_plain(dev):
    """Per-shard seg_insert (multi-target form) and merge_stack launches
    over shard views equal the plain versions on the same inputs."""
    from redisson_tpu_torch.parallel import sharded

    mesh = _mesh4(dev)
    g = np.random.default_rng(1)
    n, s = 1 << 20, 1024
    keys = g.integers(0, 2**63, n, dtype=np.int64).view(np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    row = g.integers(0, s, n).astype(np.int32)
    valid = g.random(n) < 0.95
    bank = sharded.make_bank(mesh, s)
    ik.reset_launches()
    ok.reset_launches()
    bank, changed = sharded.bank_insert(bank, hi, lo, row, valid, mesh)
    assert ik.launches["seg_insert"] == 4
    cpu_mesh = type(mesh)(mesh.axis, (torch.device("cpu"),) * 4)
    want, want_changed = sharded.bank_insert(
        sharded.make_bank(cpu_mesh, s), hi, lo, row, valid, cpu_mesh)
    assert torch.equal(bank.cpu(), want) and torch.equal(changed.cpu(), want_changed)
    merged = sharded.bank_merge_all(bank, mesh)
    assert ok.launches["merge_stack"] == 4
    assert torch.equal(merged.cpu(), want.amax(dim=0))


def test_sharded_bitcount_past_2_31_on_card(dev):
    """BITCOUNT of a 2^32-cell array (4 GiB, 2^30 cells per shard) past
    2^31 set bits: one popcount_partials launch per shard, exact int64
    combine; LENGTH reaches 2^32 at the top index."""
    from redisson_tpu_torch.parallel import sharded_bits

    mesh = _mesh4(dev)
    if torch.cuda.get_device_properties(dev).total_memory < (12 << 30):
        pytest.skip("needs 12 GiB of device memory")
    bits = sharded_bits.make_bits(mesh, 1 << 32)
    try:
        bits = sharded_bits.set_range(bits, 0, (1 << 31) + (1 << 20), True, mesh)
        idx = torch.tensor([(1 << 32) - 1, 3 << 30], dtype=torch.int64, device=dev)
        bits, old = sharded_bits.set_bits(bits, idx, torch.ones(2, dtype=torch.bool,
                                                                device=dev), mesh)
        assert old.tolist() == [0, 0]
        ok.reset_launches()
        total = sharded_bits.cardinality(bits, mesh)
        assert ok.launches["popcount_partials"] == 4
        assert total == (1 << 31) + (1 << 20) + 1 + 2
        assert sharded_bits.length(bits, mesh) == 1 << 32
    finally:
        del bits
        torch.cuda.empty_cache()


def test_sharded_bitop_and_bloom_on_card_match_plain(dev):
    from redisson_tpu_torch.ops import bloom_math
    from redisson_tpu_torch.parallel import sharded_bits

    mesh = _mesh4(dev)
    cpu_mesh = type(mesh)(mesh.axis, (torch.device("cpu"),) * 4)
    g = torch.Generator().manual_seed(3)
    n = 1 << 27
    a = (torch.rand(n, generator=g) < 0.3).to(torch.uint8)
    b = (torch.rand(n, generator=g) < 0.6).to(torch.uint8)
    stack = torch.stack([a, b])
    for op in ("and", "or", "xor"):
        ok.reset_launches()
        got = sharded_bits.bitop(stack.to(dev), op, mesh)
        assert ok.launches["bitop_cells"] == 4
        assert torch.equal(got.cpu(), sharded_bits.bitop(stack, op, cpu_mesh))
    m = bloom_math.optimal_num_of_bits(1_000_000, 0.01)
    k = bloom_math.optimal_num_of_hash_functions(1_000_000, m)
    keys = torch.randint(0, 2**62, (1 << 20,), generator=g, dtype=torch.int64)
    bits = sharded_bits.make_bits(mesh, m)
    ik.reset_launches()
    bits, added = sharded_bits.bloom_add_packed(bits, keys.to(dev), 1 << 20, k, m,
                                                0, mesh)
    assert ik.launches["bits_insert_segmented"] == 4
    want, want_added = sharded_bits.bloom_add_packed(
        sharded_bits.make_bits(cpu_mesh, m), keys, 1 << 20, k, m, 0, cpu_mesh)
    assert torch.equal(bits.cpu(), want) and torch.equal(added.cpu(), want_added)


def test_pod_client_on_card_matches_cpu(dev):
    out = []
    for device in ("cuda:0", "cpu"):
        cfg = Config()
        cfg.use_pod(device=device, num_shards=4, bank_capacity=64)
        c = RedissonTorch.create(cfg)
        try:
            for i in range(8):
                c.get_hyper_log_log(f"p:{i}").add_ints(
                    np.arange(i * 1000, i * 1000 + 40_000, dtype=np.uint64))
            c.get_hyper_log_log("p:b").add_all([b"k%d" % i for i in range(5000)])
            merged = c.get_hyper_log_log("p:0").merge_with_and_count(
                *[f"p:{i}" for i in range(1, 8)])
            bs = c.get_bit_set("p:bits")
            bs.set_range(0, 100_000)
            bf = c.get_bloom_filter("p:bf")
            bf.try_init(100_000, 0.01)
            bf.add_ints(np.arange(50_000, dtype=np.uint64))
            out.append((merged, bs.cardinality(),
                        bf.contains_count_ints(np.arange(60_000, dtype=np.uint64)),
                        c.to_numpy_state()[0], c.to_numpy_objects()))
        finally:
            c.shutdown()
    (m1, c1, f1, b1, o1), (m2, c2, f2, b2, o2) = out
    assert (m1, c1, f1) == (m2, c2, f2)
    assert np.array_equal(b1, b2)
    assert set(o1) == set(o2)
    for name in o1:
        assert np.array_equal(o1[name][1], o2[name][1]), name


def test_mesh_plane_merge_count_on_card_matches_cpu(dev, tmp_path):
    out = []
    for device in ("cuda:0", "cpu"):
        cfg = Config()
        cfg.use_cuda(device=device)
        cfg.use_cluster(num_shards=4, dir=str(tmp_path / device.replace(":", "")),
                        data_plane="mesh")
        c = RedissonTorch.create(cfg)
        try:
            for i in range(16):
                c.get_hyper_log_log(f"mp:{i}").add_all(
                    [b"%d:%d" % (i, j) for j in range(3000)])
            ok.reset_launches()
            got = c.get_hyper_log_log("mp:0").merge_with_and_count(
                *[f"mp:{i}" for i in range(1, 16)])
            backend = c.cluster.mesh_client._routing.sketch
            if device != "cpu":
                assert ok.launches["merge_stack"] >= 2  # one per shard holding rows
            out.append((got, backend.counters["collective_merges"],
                        backend.mesh_occupancy()))
        finally:
            c.shutdown()
    assert out[0] == out[1]
