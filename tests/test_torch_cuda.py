"""On-card tests of the hand-written CUDA kernels and the client (marker
`cuda`): each kernel against its plain version at the main path's shapes
(segmented insert, merge_stack, popcount partials, bitop, segment-OR), and
the client (HLL, Bloom, BitSet) on the card against the client on the CPU. They skip where
no card is visible. Run them on a machine with one:

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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,hot", [(1 << 21, False), (1 << 16, True), (0, False)])
def test_seg_insert_matches_plain(dev, n, hot):
    g = torch.Generator(device=dev).manual_seed(n)
    regs = torch.randint(0, 20, (16384,), dtype=torch.int32, device=dev, generator=g)
    bucket = torch.randint(0, 16384, (n,), dtype=torch.int32, device=dev, generator=g)
    if hot:
        bucket.fill_(77)
    rank = torch.randint(0, 52, (n,), dtype=torch.int32, device=dev, generator=g)
    before = ik.launches["seg_insert"]
    got = ik.hll_insert_segmented(regs, bucket, rank)
    assert torch.equal(got, ik.hll_insert_segmented_plain(regs, bucket, rank))
    assert ik.launches["seg_insert"] == before + (1 if n else 0)


@pytest.mark.parametrize("s", [1024, 1000, 5, 0])
def test_merge_stack_matches_plain(dev, s):
    g = torch.Generator(device=dev).manual_seed(s)
    stack = torch.randint(0, 52, (s, 16384), dtype=torch.int32, device=dev, generator=g)
    assert torch.equal(ok.merge_stack(stack), ok.merge_stack_plain(stack))


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
    before = ik.launches["bits_insert_segmented"]
    got = ik.bits_insert_segmented(cells, idx)
    assert torch.equal(got, ik.bits_insert_segmented_plain(cells, idx))
    assert ik.launches["bits_insert_segmented"] == before + 1


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
