"""The port's BitSet against the JAX package on the CPU: the ops module, the
engine's SETBIT / CLEAR / GETBIT (cells and old-value vectors), and every
bitset op through both clients driven with one seeded op sequence, then
compared through `bits_export`. Also the state carry-over from the JAX
store into the port. Every result is compared bit for bit."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu import engine as je
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.ops import bitset as jbitset
from redisson_tpu_torch import engine as te
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ops import bitset as tbitset


def _cells(n: int, density: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random(n) < density).astype(np.uint8)


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 5, 3 << 20])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_partials_match_jax(n, density):
    cells = _cells(n, density, n)
    if density == 0.3:
        cells[-1] = 1  # the highest set bit sits in the ragged tail
    tc = torch.from_numpy(cells)
    np.testing.assert_array_equal(
        tbitset.cardinality_partials(tc).numpy(),
        np.asarray(jbitset.cardinality_partials(jnp.asarray(cells))))
    np.testing.assert_array_equal(
        tbitset.length_partials(tc).numpy(),
        np.asarray(jbitset.length_partials(jnp.asarray(cells))))
    assert tbitset.cardinality(tc) == int(cells.sum())
    assert tbitset.length(tc) == jbitset.length(jnp.asarray(cells))


@pytest.mark.parametrize("n", [1, 7, 8, 1001, 4096])
def test_pack_unpack_match_jax(n):
    cells = _cells(n, 0.5, n)
    packed = tbitset.pack(torch.from_numpy(cells))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jbitset.pack(jnp.asarray(cells))))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(cells))
    np.testing.assert_array_equal(tbitset.unpack(packed, n).numpy(), cells)


@pytest.mark.parametrize("start,end,value", [(0, 1000, True), (5, 6, False),
                                             (100, 5000, True), (3000, 2000, True),
                                             (0, 0, True), (999, 1 << 32, False)])
def test_set_range_matches_jax(start, end, value):
    cells = _cells(4096, 0.5, 1)
    np.testing.assert_array_equal(
        tbitset.set_range(torch.from_numpy(cells), start, end, value).numpy(),
        np.asarray(jbitset.set_range(jnp.asarray(cells), start, end, value)))


def test_set_clear_get_bits_match_jax():
    cells = _cells(5000, 0.3, 2)
    idx = np.random.default_rng(3).integers(0, 5000, 700)
    for tfn, jfn in ((tbitset.set_bits, jbitset.set_bits),
                     (tbitset.clear_bits, jbitset.clear_bits)):
        tnew, told = tfn(torch.from_numpy(cells), torch.from_numpy(idx))
        jnew, jold = jfn(jnp.asarray(cells), jnp.asarray(idx.astype(np.uint32)))
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
        np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
    np.testing.assert_array_equal(
        tbitset.get_bits(torch.from_numpy(cells), torch.from_numpy(idx)).numpy(),
        np.asarray(jbitset.get_bits(jnp.asarray(cells), jnp.asarray(idx.astype(np.uint32)))))


@pytest.mark.parametrize("op", ["set", "clear", "get"])
def test_engine_bitset_ops_match_jax(op):
    cells = _cells(1 << 14, 0.4, 4)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 1 << 14, 2048)
    idx[10:20] = idx[:10]  # duplicates read the pre-batch value
    valid = np.arange(2048) < 2000
    idx[~valid] = 77  # padded lanes must neither read nor write their index
    tfn, jfn = {"set": (te.bitset_set, je.bitset_set),
                "clear": (te.bitset_clear, je.bitset_clear),
                "get": (te.bitset_get, je.bitset_get)}[op]
    tbits = torch.from_numpy(cells.copy())
    tout = tfn(tbits, torch.from_numpy(idx), torch.from_numpy(valid))
    jout = jfn(jnp.asarray(cells), jnp.asarray(idx.astype(np.uint32)),
               jnp.asarray(valid))
    if op == "get":
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        return
    (tnew, told), (jnew, jold) = tout, jout
    assert tnew is tbits  # the port writes the cells in place
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(told.numpy(), np.asarray(jold))


@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_engine_bitop_and_not_match_jax(op, k):
    stack = np.stack([_cells(3000, 0.5, 10 + r) for r in range(k)])
    np.testing.assert_array_equal(
        te.bitset_bitop(torch.from_numpy(stack), op).numpy(),
        np.asarray(je.bitset_bitop(jnp.asarray(stack), op)))
    cells = stack[0]
    for n in (0, 1, 1000, 3000):
        np.testing.assert_array_equal(
            te.bitset_not_masked(torch.from_numpy(cells.copy()), n).numpy(),
            np.asarray(je.bitset_not_masked(jnp.asarray(cells), np.uint32(n))))


def _bitset_script(client):
    """Every op is synchronous: each result is comparable op by op."""
    rng = np.random.default_rng(2024)
    out = []
    days = [client.get_bit_set(f"day:{d}") for d in range(4)]
    for d, b in enumerate(days):
        ids = rng.integers(0, 50_000 + 20_000 * d, 30_000)
        out.append(("set_bits", d, b.set_bits(ids).tolist()))
        out.append(("clear_bits", d, b.clear_bits(ids[:300]).tolist()))
        out.append(("get_bits", d, b.get_bits(rng.integers(0, 200_000, 2000)).tolist()))
        out.append(("set", d, b.set(int(ids[0])), b.set(7, False), b.get(7)))
        out.append(("aggregates", d, b.cardinality(), b.length(), b.size()))
    days[0].set_range(10, 5000)
    days[1].set_range(100, 3000, False)
    days[2].clear(40, 90)
    out.append(("after ranges", [(b.cardinality(), b.length(), b.size()) for b in days]))
    week = client.get_bit_set("week")
    week.or_(*[b.name for b in days], "absent")
    both = client.get_bit_set("both")
    both.or_(days[0].name)
    both.and_(*[b.name for b in days[1:]])
    odd = client.get_bit_set("odd")
    odd.xor(*[b.name for b in days])
    for b in (week, both, odd):
        out.append(("bitop", b.name, b.cardinality(), b.length(), b.size()))
    days[3].not_()
    # Compared through the cells below, not through cardinality(): the JAX
    # backend keeps serving its pre-NOT cached count (see
    # test_not_invalidates_cached_reads).
    out.append(("not", days[3].size()))
    client.get_bit_set("never").not_()
    out.append(("empty", client.get_bit_set("never").size(),
                client.get_bit_set("never").cardinality()))
    out.append(("to_byte_array", len(days[2].to_byte_array()),
                sorted(days[2].as_bit_set())[:50]))
    days[1].rename("moved")
    out.append(("renamed", client.get_bit_set("moved").cardinality(),
                days[0].is_exists(), client.get_bit_set("day:1").is_exists()))
    out.append(("delete", days[2].delete(), days[2].is_exists()))
    days[0].clear()
    out.append(("cleared", days[0].cardinality(), days[0].is_exists()))
    cells = {}
    for name in ("moved", "day:3", "week", "both", "odd"):
        otype, host, meta, _version = client._executor.execute_sync(
            name, "bits_export", None)
        cells[name] = (otype, np.asarray(host, np.uint8), meta)
    return out, cells


def test_client_script_matches_jax():
    jc = RedissonTPU.create(JConfig())
    tc = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        jout, jcells = _bitset_script(jc)
        tout, tcells = _bitset_script(tc)
    finally:
        jc.shutdown()
        tc.shutdown()
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert t == j, t[:2]
    assert tcells.keys() == jcells.keys()
    for name, (otype, host, meta) in jcells.items():
        assert tcells[name][0] == otype and tcells[name][2] == meta, name
        np.testing.assert_array_equal(tcells[name][1], host, err_msg=name)


def test_bitop_result_against_numpy():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        rng = np.random.default_rng(8)
        ref = np.zeros((3, 1 << 17), np.uint8)
        for d in range(3):
            ids = rng.integers(0, 1 << 17, 40_000)
            ref[d, ids] = 1
            c.get_bit_set(f"d{d}").set_bits(ids)
        c.get_bit_set("u").or_("d0", "d1", "d2")
        c.get_bit_set("x").xor("d0", "d1", "d2")
        got = c.to_numpy_objects()
        np.testing.assert_array_equal(got["u"][1], ref.max(0))
        np.testing.assert_array_equal(got["x"][1], ref[0] ^ ref[1] ^ ref[2])
        assert c.get_bit_set("u").cardinality() == int(ref.max(0).sum())
    finally:
        c.shutdown()


def test_state_carries_over_from_the_jax_store():
    """Both packages start from one state (an HLL bank plus BitSet and Bloom
    objects exported from the JAX backend), take the same further ops, and
    end bit-identical."""
    jc = RedissonTPU.create(JConfig())
    tc = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        keys = np.arange(20_000, dtype=np.uint64)
        jc.get_hyper_log_log("h").add_ints(keys)
        jc.get_bit_set("b").set_bits(np.arange(0, 9000, 7))
        jc.get_bloom_filter("f").try_init(10_000, 0.01)
        jc.get_bloom_filter("f").add_ints(keys[:5000])
        backend = jc._backend.sketch
        objects = {n: jc._executor.execute_sync(n, "bits_export", None)
                   for n in ("b", "f")}
        tc.from_jax_state(np.asarray(backend.bank), dict(backend._rows), objects)
        for c in (jc, tc):
            c.get_bit_set("b").set_bits([1, 2, 9001])
            assert c.get_bloom_filter("f").contains_ints(keys[:5000]).all()
            c.get_bloom_filter("f").add_ints(keys[5000:8000])
            c.get_hyper_log_log("h").add_ints(keys + np.uint64(1 << 40))
        for n in ("b", "f"):
            j = jc._executor.execute_sync(n, "bits_export", None)
            t = tc._executor.execute_sync(n, "bits_export", None)
            assert t[0] == j[0] and t[2] == j[2]
            np.testing.assert_array_equal(t[1], np.asarray(j[1], np.uint8))
        assert (tc.get_bloom_filter("f").count() == jc.get_bloom_filter("f").count())
        assert tc.get_bit_set("b").cardinality() == jc.get_bit_set("b").cardinality()
        treg, _ = tc._executor.execute_sync("h", "hll_export", None)
        jreg, _ = jc._executor.execute_sync("h", "hll_export", None)
        np.testing.assert_array_equal(treg, np.asarray(jreg, np.uint8))
        assert set(tc.to_numpy_objects()) == {"b", "f"}
    finally:
        jc.shutdown()
        tc.shutdown()


def test_group_coalesced_runs_isolate_failures():
    """bloom_add and bitset_set runs steal queue heads of other targets; a
    bad target fails its own ops only."""
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        c.get_bloom_filter("ok").try_init(1000, 0.01)
        c.get_hyper_log_log("h").add("x")
        # The dispatcher waits on a barrier while the ops are submitted, so
        # they are all queued when it picks the first one.
        release, entered = threading.Event(), threading.Event()

        def hold():
            entered.set()
            release.wait(60)

        held = c._executor.execute_barrier(hold)
        assert entered.wait(60), "the dispatcher never reached the barrier"
        try:
            futs = [c.get_bloom_filter(n).add_ints_async(np.arange(10, dtype=np.uint64))
                    for n in ("ok", "uninit", "h", "ok")]
            futs += [c.get_bit_set(n).set_bits_async([3, 4]) for n in ("s1", "h", "s2")]
        finally:
            release.set()
        held.result()
        # Both "ok" ops coalesce into one run: each sees the run-start state.
        assert futs[0].result().all() and futs[3].result().all()
        with pytest.raises(RuntimeError, match="not initialized"):
            futs[1].result()
        for f in (futs[2], futs[5]):
            with pytest.raises(TypeError):
                f.result()
        assert futs[4].result().tolist() == [False, False]
        assert futs[6].result().tolist() == [False, False]
        assert c.get_bit_set("s1").cardinality() == 2
    finally:
        c.shutdown()


def test_not_invalidates_cached_reads():
    """BITOP NOT bumps the target's write epoch, so a count cached before it
    is not served after it. (The JAX backend's NOT swaps the cells without
    bumping the epoch and answers the second cardinality() with the cached
    pre-NOT count; its cells agree with the port's.)"""
    jc = RedissonTPU.create(JConfig())
    tc = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        ids = np.random.default_rng(6).integers(0, 5000, 1500)
        cells = np.zeros(5000, np.uint8)
        cells[ids] = 1
        ext = ((int(ids.max()) // 8) + 1) * 8
        for c in (jc, tc):
            b = c.get_bit_set("b")
            b.set_bits(ids)
            assert b.cardinality() == int(cells.sum())
            b.not_()
        want = int(ext - cells[:ext].sum())
        assert tc.get_bit_set("b").cardinality() == want
        t = tc._executor.execute_sync("b", "bits_export", None)[1]
        j = jc._executor.execute_sync("b", "bits_export", None)[1]
        np.testing.assert_array_equal(t, np.asarray(j, np.uint8))
        assert int(t.sum()) == want
    finally:
        jc.shutdown()
        tc.shutdown()


def test_flip_bits_matches_jax():
    rng = np.random.default_rng(3)
    cells = _cells(5000, 0.3, 4)
    idx = rng.integers(0, 5000, 1200)  # duplicates flip once
    jn, jo = jbitset.flip_bits(jnp.asarray(cells), jnp.asarray(idx.astype(np.int32)))
    tn, to = tbitset.flip_bits(torch.from_numpy(cells), torch.from_numpy(idx))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _bitpos_cases():
    n = 3 * (1 << 20) + 777  # a ragged last chunk
    empty = np.zeros(n, np.uint8)
    ones = np.ones(n, np.uint8)
    tail_hit = np.zeros(n, np.uint8)
    tail_hit[n - 1] = 1  # the only 1 sits in the padded chunk
    tail_zero = np.ones(n, np.uint8)
    tail_zero[n - 3] = 0  # the only 0 as well: pad cells must not match
    mid = _cells(n, 0.001, 9)
    return {"empty": empty, "all_ones": ones, "tail_hit": tail_hit,
            "tail_zero": tail_zero, "sparse": mid, "tiny": np.array([1, 1, 0], np.uint8)}


@pytest.mark.parametrize("case", sorted(_bitpos_cases()))
@pytest.mark.parametrize("value", [0, 1])
def test_bitpos_matches_jax(case, value):
    cells = _bitpos_cases()[case]
    jp = jbitset.bitpos_partials(jnp.asarray(cells), value)
    tp = tbitset.bitpos_partials(torch.from_numpy(cells), value)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    want = jbitset.bitpos(jnp.asarray(cells), value)
    assert tbitset.bitpos(torch.from_numpy(cells), value) == want
    hit = np.flatnonzero(cells == value)
    assert want == (int(hit[0]) if hit.size else -1)


def test_combine_bitpos_is_exact_past_2_31():
    """The host combine works in python ints: a hit in chunk 3000 of 2^20
    cells lies past 2^31."""
    partials = np.full(3001, -1, np.int32)
    partials[3000] = 12345
    want = 3000 * (1 << 20) + 12345
    assert want > 2**31
    assert tbitset.combine_bitpos(partials) == want == jbitset.combine_bitpos(partials)
    assert tbitset.combine_bitpos(torch.from_numpy(partials)) == want
