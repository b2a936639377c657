"""The port's Bloom filter against the JAX package on the CPU: index math,
engine adds (cells and `added` flags), membership and membership counts in
the classic and blocked layouts, and the client end to end. Every result
is compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu import engine as je
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.models.object import pack_u64 as jpack
from redisson_tpu.ops import bloom as jbloom
from redisson_tpu.ops.u64 import U64
from redisson_tpu_torch import engine as te
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ops import bloom as tbloom
from redisson_tpu_torch.ops import bloom_math

# The full-width filter of BASELINE config 2: try_init(2^28 // 10, 0.01).
M_FULL = 257_296_945


def _hashes(n: int, seed: int) -> np.ndarray:
    h = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                             endpoint=False)
    # Hashes at the edges: top bit set, all ones, 2^63, values whose
    # multiples wrap 2^64 within a few steps.
    h[:6] = [2**64 - 1, 2**63, 2**63 - 1, 0, 1, 2**64 - 3]
    return h


def _j64(h: np.ndarray) -> U64:
    return U64(jnp.asarray((h >> np.uint64(32)).astype(np.uint32)),
               jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _t64(h: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(h.view(np.int64).copy())


def test_full_width_geometry():
    m = bloom_math.optimal_num_of_bits(2**28 // 10, 0.01)
    assert m == M_FULL
    assert bloom_math.optimal_num_of_hash_functions(2**28 // 10, m) == 7


@pytest.mark.parametrize("m", [1 << 20, 1 << 32, (1 << 31) - 1, M_FULL, 1000003])
@pytest.mark.parametrize("k", [1, 7, 10])
def test_indexes_match_jax(m, k):
    h1, h2 = _hashes(4000, m % 97), _hashes(4000, k + 11)
    want = np.asarray(jbloom.indexes(_j64(h1), _j64(h2), k, m)).astype(np.int64)
    got = tbloom.indexes(_t64(h1), _t64(h2), k, m)
    assert got.dtype == torch.int64 and got.shape == (4000, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # And the definition itself, in python ints.
    for i in range(8):
        a, b = int(h1[i]), int(h2[i])
        assert got[i].tolist() == [((a + j * b) % 2**64) % m for j in range(k)]


@pytest.mark.parametrize("m", [1 << 20, 512 * 1001, 1 << 32])
def test_blocked_indexes_match_jax(m):
    h1, h2 = _hashes(3000, 5), _hashes(3000, 6)
    jblock, jpos = jbloom.blocked_indexes(_j64(h1), _j64(h2), 7, m)
    tblock, tpos = tbloom.blocked_indexes(_t64(h1), _t64(h2), 7, m)
    np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(
        tbloom.blocked_absolute(tblock, tpos).numpy(),
        np.asarray(jbloom.blocked_absolute(jblock, jpos)).astype(np.int64))


def test_check_size_matches_jax():
    for m in (0, -1, (1 << 32) + 1, (1 << 31) + 1, 3 << 30):
        with pytest.raises(ValueError):
            jbloom.check_size(m)
        with pytest.raises(ValueError):
            tbloom.check_size(m)
    for m in (1, (1 << 31) - 1, 1 << 31, 1 << 32):
        jbloom.check_size(m)
        tbloom.check_size(m)


def _keys(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                                endpoint=False)


def _padded(keys: np.ndarray, b: int):
    out = np.zeros((b,), np.uint64)
    out[: keys.shape[0]] = keys
    return out


M_SMALL = 95_851  # try_init(10_000, 0.01): ragged, not a power of two


@pytest.mark.parametrize("impl", ["scatter", "segment"])
@pytest.mark.parametrize("m,k", [(M_SMALL, 7), (1 << 16, 3), (2048, 10)])
def test_engine_add_and_contains_packed(impl, m, k):
    rng = np.random.default_rng(m + k)
    bits = (rng.random(m) < 0.05).astype(np.uint8)
    keys = _keys(3000, k)
    keys[100:200] = keys[:100]  # duplicates inside one batch
    count = 2900  # 124 padded lanes must write nothing
    padded = _padded(keys[:count], 3024)
    jbits, jadded = je.bloom_add_packed(jnp.asarray(bits), jpack(padded),
                                        np.int32(count), k, m, 5, impl)
    tbits, tadded = te.bloom_add_packed(torch.from_numpy(bits.copy()),
                                        _t64(padded), count, k, m, 5, impl)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tadded.numpy(), np.asarray(jadded))
    assert tadded[:count].any() and not tadded[count:].any()

    probe = _padded(np.concatenate([keys[:500], _keys(1500, 99)]), 2048)
    jc = je.bloom_contains_packed(jbits, jpack(probe), np.int32(2000), k, m, 5)
    tc = te.bloom_contains_packed(tbits, _t64(probe), 2000, k, m, 5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc[:500].all()
    jn = je.bloom_contains_count_packed(jbits, jpack(probe), np.int32(2000), k, m, 5)
    tn = te.bloom_contains_count_packed(tbits, _t64(probe), 2000, k, m, 5)
    assert int(tn) == int(jn) == int(tc.sum())


@pytest.mark.parametrize("impl", ["scatter", "segment"])
def test_engine_add_and_contains_bytes(impl):
    rng = np.random.default_rng(3)
    n, w = 1024, 32
    lengths = rng.integers(0, w, n).astype(np.int32)
    data = rng.integers(0, 256, (n, w)).astype(np.uint8)
    data[np.arange(w)[None, :] >= lengths[:, None]] = 0
    valid = np.arange(n) < 1000
    bits = np.zeros((M_SMALL,), np.uint8)
    jbits, jadded = je.bloom_add_bytes(jnp.asarray(bits), jnp.asarray(data),
                                       jnp.asarray(lengths), jnp.asarray(valid),
                                       7, M_SMALL, 0, impl)
    tbits, tadded = te.bloom_add_bytes(
        torch.from_numpy(bits.copy()), torch.from_numpy(data),
        torch.from_numpy(lengths), torch.from_numpy(valid), 7, M_SMALL, 0, impl)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tadded.numpy(), np.asarray(jadded))
    jc = je.bloom_contains_bytes(jbits, jnp.asarray(data), jnp.asarray(lengths),
                                 jnp.asarray(valid), 7, M_SMALL, 0)
    tc = te.bloom_contains_bytes(tbits, torch.from_numpy(data),
                                 torch.from_numpy(lengths), torch.from_numpy(valid),
                                 7, M_SMALL, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("m,k", [(M_SMALL, 7), (4096, 3)])
def test_set_indexes_segment_in_place_matches_jax(m, k):
    """The segment path of `_set_indexes` sets the cells in place and
    returns the same tensor; cells equal JAX's segment-OR (Pallas in
    interpret mode, and its lax fallback) on the same indexes, and `added`
    is taken against the batch start (a key whose cells earlier keys of
    the batch set is still added)."""
    from redisson_tpu.ingest import kernels as jk

    rng = np.random.default_rng(m + k)
    cells = (rng.random(m) < 0.05).astype(np.uint8)
    idx = rng.integers(0, m, (2000, k))
    idx[100:200] = idx[:100]  # whole keys repeated inside the batch
    valid = np.arange(2000) < 1900
    flat = np.where(valid[:, None], idx, m).reshape(-1).astype(np.int32)
    want = np.asarray(jk.bits_insert_segmented(jnp.asarray(cells), jnp.asarray(flat),
                                               interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jk.bits_insert_segmented_lax(jnp.asarray(cells), jnp.asarray(flat))),
        want)
    want_added = (cells[np.where(valid[:, None], idx, 0)] == 0).any(axis=1) & valid
    bits = torch.from_numpy(cells.copy())
    got, added = te._set_indexes(bits, torch.from_numpy(idx), torch.from_numpy(valid),
                                 "segment")
    assert got is bits
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(added.numpy(), want_added)
    assert added[100:200].equal(added[:100])


def test_engine_blocked_layout():
    m = tbloom.blocked_geometry(M_SMALL)
    keys = _keys(2500, 8)
    padded = _padded(keys, 4096)
    bits = np.zeros((m,), np.uint8)
    jbits, jadded = je.blocked_bloom_add_packed(jnp.asarray(bits), jpack(padded),
                                                np.int32(2500), 7, m, 0)
    tbits, tadded = te.blocked_bloom_add_packed(torch.from_numpy(bits.copy()),
                                                _t64(padded), 2500, 7, m, 0)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tadded.numpy(), np.asarray(jadded))
    probe = _padded(np.concatenate([keys[:1000], _keys(3000, 9)]), 4096)
    jc = je.blocked_bloom_contains_packed(jbits, jpack(probe), np.int32(4000), 7, m, 0)
    tc = te.blocked_bloom_contains_packed(tbits, _t64(probe), 4000, 7, m, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc[:1000].all()
    jn = je.blocked_bloom_contains_count_packed(jbits, jpack(probe), np.int32(4000),
                                                7, m, 0)
    tn = te.blocked_bloom_contains_count_packed(tbits, _t64(probe), 4000, 7, m, 0)
    assert int(tn) == int(jn)


def _bloom_script(client, blocked: bool):
    """One seeded op sequence; every op is synchronous, so each result is
    comparable op by op."""
    rng = np.random.default_rng(77)
    out = []
    f = client.get_bloom_filter("bf")
    out.append(("init", f.try_init(20_000, 0.02, blocked=blocked)))
    out.append(("re-init", f.try_init(20_000, 0.02, blocked=blocked)))
    meta = [f.get_size(), f.get_hash_iterations(), f.get_expected_insertions(),
            f.get_false_probability(), f.is_blocked()]
    out.append(("meta", meta))
    inserted = rng.integers(0, 2**63, 9000, dtype=np.uint64)
    for lo in range(0, 9000, 3000):
        out.append(("add_ints", f.add_ints(inserted[lo: lo + 3000]).tolist()))
    out.append(("re-add", f.add_ints(inserted[:500]).tolist()))
    words = [f"item:{i}" for i in range(700)]
    out.append(("add_all", f.add_all(words).tolist()))
    out.append(("add", f.add("item:0")))
    probe = np.concatenate([inserted[:2000], rng.integers(2**63, 2**64, 4000,
                                                          dtype=np.uint64)])
    out.append(("contains_ints", f.contains_ints(probe).tolist()))
    out.append(("contains_ints again", f.contains_ints(probe[:100]).tolist()))
    out.append(("contains_all", f.contains_all(words[:50] + ["nope", "x"]).tolist()))
    out.append(("contains_count", f.contains_count_ints(probe)))
    out.append(("count", f.count()))
    g = client.get_bloom_filter("other")
    g.try_init(5000, 0.1)
    g.add_ints(inserted[:4000])
    out.append(("other count", g.count()))
    out.append(("exists", f.is_exists(), client.get_bloom_filter("nope").is_exists()))
    cells = {}
    for name in ("bf", "other"):
        otype, host, meta, _version = client._executor.execute_sync(
            name, "bits_export", None)
        cells[name] = (otype, np.asarray(host, np.uint8), meta)
    return out, cells


@pytest.mark.parametrize("ingest,blocked", [("scatter", False), ("segment", False),
                                            ("scatter", True)])
def test_client_script_matches_jax(ingest, blocked):
    jcfg = JConfig()
    jcfg.use_tpu().ingest = ingest
    jc = RedissonTPU.create(jcfg)
    tc = RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))
    try:
        jout, jcells = _bloom_script(jc, blocked)
        tout, tcells = _bloom_script(tc, blocked)
    finally:
        jc.shutdown()
        tc.shutdown()
    assert tout == jout
    for name, (otype, host, meta) in jcells.items():
        t_otype, t_host, t_meta = tcells[name]
        assert t_otype == otype and t_meta == meta
        np.testing.assert_array_equal(t_host, host, err_msg=name)
    results = {}
    for kind, *value in tout:
        results.setdefault(kind, []).append(value[0])
    # Fresh keys into a filter filling up to 45% of capacity: nearly all new.
    assert np.mean(np.concatenate(results["add_ints"])) > 0.99
    assert not any(results["re-add"][0])
    assert all(results["contains_ints"][0][:2000])


def test_client_device_keys_and_errors():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        f = c.get_bloom_filter("f")
        with pytest.raises(RuntimeError, match="not initialized"):
            f.add_ints(np.arange(10, dtype=np.uint64))
        assert f.try_init(100_000, 0.01)
        keys = np.arange(50_000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        assert f.add_ints(keys).all()
        on_device = torch.from_numpy(keys.view(np.int64).copy())
        assert f.contains_count_device_async(on_device).result() == 50_000
        fresh = on_device | torch.tensor(-(1 << 63), dtype=torch.int64)
        hits = f.contains_count_device_async(fresh).result()
        assert hits == f.contains_count_ints(fresh.numpy().view(np.uint64))
        # A derived size above 2^31 that is not a power of two fails fast.
        with pytest.raises(ValueError, match="2\\^31"):
            c.get_bloom_filter("huge").try_init(300_000_000, 0.01)
        c.get_hyper_log_log("h").add("x")
        with pytest.raises(TypeError):
            c.get_bloom_filter("h").try_init(10, 0.1)
    finally:
        c.shutdown()


def test_planner_keeps_segment_off_filters_past_2_31():
    from redisson_tpu_torch.backend_torch import TorchBackend
    from redisson_tpu_torch.ingest.planner import IngestPlanner
    from redisson_tpu_torch.store import SketchStore

    planner = IngestPlanner("cpu", measure=lambda s, n, d: {"scatter": 2.0,
                                                            "segment": 1.0})
    b = TorchBackend(SketchStore("cpu"), ingest="auto", planner=planner)
    try:
        assert b._plan_bits(1 << 20, M_FULL) == "segment"
        assert b._plan_bits(1 << 20, 1 << 32) == "scatter"
    finally:
        b.completer.shutdown()
