"""The pod tier of the port (parallel/mesh.py, sharded.py, sharded_bits.py,
backend_pod.py and the client's pod mode) on the CPU: the JAX package's
corpora run against the port, then the port held against the JAX package.

The corpora tests/test_parallel.py and tests/test_topology.py run unchanged
through `port_corpus` (tests/test_torch_interop.py). JAX's run on 8 virtual
CPU devices, so their fixtures are redefined here on 8 logical CPU shards:
`mesh` is `build_mesh(8, device="cpu")`, `podc` / `pod_client` are pod
clients on `use_pod(device="cpu", num_shards=8)`. A test that reads JAX's
`addressable_shards`, calls jax, or builds its client with a bare
`use_pod()` / `RedissonTPU.create()` (which ask for the card in the port)
is in `EXCLUDED` with its reason and has a counterpart here.

Against the JAX package (8 virtual devices against 8 logical shards,
seeded with numpy): `sharded.bank_insert` registers and per-row flags,
`bank_merge_all`; `sharded_bits` set / clear / get old values, BITCOUNT,
LENGTH, set_range, NOT and BITOP; the pod Bloom's cells and flags in both
layouts; a seeded 300-op mixed sequence through a JAX pod client and a port
pod client, results and final state equal; the JAX pod backend's state
carried into a port pod client. Exact everywhere but PFCOUNT (rel 1e-5).

The port's own rules: the pod Bloom's shard-size rule (the segment-OR
under 2^31 cells per shard, `scatter_` at or above, pinned by patching the
cap constant here); the mesh data plane takes a mesh spanning two cards
(its bank blocked, one block per entry) when its home is the backend's
device, and refuses it otherwise;
a pod without `device="cpu"` asks for the card and raises without one.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.parallel import sharded as jsharded
from redisson_tpu.parallel import sharded_bits as jsbits
from redisson_tpu.parallel.mesh import build_mesh as jbuild_mesh
from redisson_tpu_torch import engine
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ops import bloom_math, hashing, hll
from redisson_tpu_torch.parallel import mesh as mesh_mod
from redisson_tpu_torch.parallel import sharded, sharded_bits
from redisson_tpu_torch.parallel.mesh import Mesh, build_mesh
from tests import test_parallel, test_topology
from tests.test_torch_interop import CLIENT_ALIASES, corpus_tests, port_corpus

_EXTRA = ("redisson_tpu.client", "redisson_tpu.config",
          "redisson_tpu.parallel")

_POD = ("builds its client with a bare use_pod() or RedissonTPU.create(), "
        "which ask for the card in the port")

#: tests of tests/test_parallel.py with no counterpart run unchanged, and
#: why
EXCLUDED_PARALLEL = {
    "test_bank_is_sharded":
        "reads JAX's addressable_shards; see test_port_bank_is_sharded",
    "test_insert_routes_to_correct_rows":
        "indexes with jnp.int32; see test_port_insert_routes_to_correct_rows",
    "test_sharded_matches_single_device_semantics":
        "hashes through JAX's U64 lanes; see "
        "test_port_sharded_matches_single_device_semantics",
    "test_dryrun_multichip_entry":
        "drives JAX's __graft_entry__; see test_port_full_step_on_8_shards",
    "test_single_chip_entry":
        "jits JAX's __graft_entry__ step; see test_port_single_device_step",
    "test_pod_byte_keys_match_local_mode_exactly":
        _POD + "; see test_port_pod_byte_keys_match_local_mode_exactly",
    "test_pod_int_and_byte_key_groups_coalesce":
        _POD + "; see test_port_pod_int_and_byte_key_groups_coalesce",
    "test_pod_bitset_is_mesh_sharded":
        "reads JAX's addressable_shards; see test_port_pod_bitset_is_mesh_sharded",
    "test_pod_bits_checkpoint_roundtrip":
        _POD + "; see test_port_pod_bits_checkpoint_roundtrip",
}

#: tests of tests/test_topology.py with no counterpart run unchanged, and
#: why
EXCLUDED_TOPOLOGY = {
    "test_client_topology_manager_facade":
        _POD + "; see test_port_client_topology_manager_facade",
}

_CORPUS = {
    **port_corpus(test_parallel, EXCLUDED_PARALLEL, "parallel", _EXTRA,
                  CLIENT_ALIASES),
    **port_corpus(test_topology, EXCLUDED_TOPOLOGY, "topology", _EXTRA,
                  CLIENT_ALIASES),
}
globals().update(_CORPUS)


def pod_config(num_shards=8, bank_capacity=16, **kw) -> Config:
    cfg = Config()
    cfg.use_pod(device="cpu", num_shards=num_shards,
                bank_capacity=bank_capacity, **kw)
    return cfg


def cpu_config() -> Config:
    cfg = Config()
    cfg.use_cuda(device="cpu")
    return cfg


# -- the corpora's fixtures, on 8 logical CPU shards ---------------------------


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def podc():
    c = RedissonTorch.create(pod_config())
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def localc():
    c = RedissonTorch.create(cpu_config())
    yield c
    c.shutdown()


@pytest.fixture()
def pod_client():
    c = RedissonTorch.create(pod_config())
    yield c
    c.shutdown()


def test_corpora_were_imported():
    for mod, excluded, prefix, n in (
            (test_parallel, EXCLUDED_PARALLEL, "parallel", 19),
            (test_topology, EXCLUDED_TOPOLOGY, "topology", 10)):
        names = corpus_tests(mod)
        assert len(names) == n
        assert set(excluded) <= names
        assert ({f"test_{prefix}__{k[5:]}" for k in names - set(excluded)}
                <= set(_CORPUS))
    fn = _CORPUS["test_parallel__merge_all_is_ici_pmax"]
    assert fn.__globals__["sharded"] is sharded


# -- counterparts of the excluded corpus tests ---------------------------------


def _keys(n, seed=0):
    return (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(seed * 1_000_003 + 1))


def _split(keys):
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_port_bank_is_sharded(mesh):
    bank = sharded.make_bank(mesh, 64)
    assert bank.shape == (64, 16384)
    assert bank.ranges() == mesh_mod.row_blocks(64, mesh)
    # Each shard is an 8-row tensor of its own on its entry's device.
    assert {tuple(b.shape) for b in bank.blocks} == {(8, 16384)}
    assert len({b.untyped_storage().data_ptr() for b in bank.blocks}) == 8
    assert [b.device for b in bank.blocks] == list(mesh.devices)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}


def test_port_insert_routes_to_correct_rows(mesh):
    bank = sharded.make_bank(mesh, 16)
    n = 4096
    hi, lo = _split(_keys(n))
    row = (np.arange(n) % 16).astype(np.int32)
    bank, changed = sharded.bank_insert(bank, hi, lo, row, np.ones((n,), bool),
                                        mesh)
    assert np.asarray(changed).all()
    for r in (0, 7, 15):
        est = float(sharded.bank_count_row(bank, r))
        assert abs(est - 256) / 256 < 0.2, (r, est)
    assert abs(float(sharded.bank_count_all(bank, mesh)) - n) / n < 0.05


def test_port_sharded_matches_single_device_semantics(mesh):
    bank = sharded.make_bank(mesh, 8)
    n = 2048
    keys = _keys(n, 3)
    hi, lo = _split(keys)
    row = (np.arange(n) % 8).astype(np.int32)
    bank, changed = sharded.bank_insert(bank, hi, lo, row, np.ones((n,), bool),
                                        mesh)
    assert np.asarray(changed).any()
    h1, _ = hashing.murmur3_x64_128_u64(torch.from_numpy(keys.view(np.int64)))
    bucket, rank = hll.bucket_rank(h1)
    want = np.zeros((8, 16384), np.int32)
    np.maximum.at(want, (row, bucket.numpy()), rank.numpy())
    assert np.array_equal(np.asarray(bank), want)


def test_port_full_step_on_8_shards(mesh):
    num_sketches = 32
    bank = sharded.make_bank(mesh, num_sketches)
    n = 512
    keys = np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(7)
    hi, lo = _split(keys)
    row = (np.arange(n) % num_sketches).astype(np.int32)
    bank, est = sharded.full_step(bank, hi, lo, row, np.ones((n,), bool), mesh)
    assert abs(float(est) - n) / n < 0.1


def test_port_single_device_step():
    regs = hll.make()
    keys = np.arange(1024, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    regs, changed = engine.hll_add_packed(
        regs, torch.from_numpy(keys.view(np.int64)), 1024)
    assert bool(changed)
    assert abs(float(hll.count(regs)) - 1024) / 1024 < 0.1
    assert int(regs.max()) >= 1


def test_port_pod_byte_keys_match_local_mode_exactly():
    keys = [f"user:{i}:söme-bytes" for i in range(4096)]
    local = RedissonTorch.create(cpu_config())
    try:
        h = local.get_hyper_log_log("xmode")
        h.add_all(keys)
        local_est = h.count()
        local_regs = local._executor.execute_sync("xmode", "hll_export", None)[0]
    finally:
        local.shutdown()
    pod = RedissonTorch.create(pod_config(bank_capacity=64))
    try:
        h = pod.get_hyper_log_log("xmode")
        h.add_all(keys)
        pod_est = h.count()
        pod_regs = pod._executor.execute_sync("xmode", "hll_export", None)[0]
    finally:
        pod.shutdown()
    assert pod_est == local_est
    assert np.array_equal(pod_regs, local_regs)
    assert abs(pod_est - len(keys)) / len(keys) < 0.05


def test_port_pod_int_and_byte_key_groups_coalesce():
    pod = RedissonTorch.create(pod_config(bank_capacity=64))
    try:
        a = pod.get_hyper_log_log("grp:a")
        b = pod.get_hyper_log_log("grp:b")
        fa = a.add_ints_async(np.arange(2048, dtype=np.uint64))
        fb = b.add_all_async([f"k{i}" for i in range(2048)])
        assert fa.result() in (True, False)
        assert fb.result() in (True, False)
        assert abs(a.count() - 2048) / 2048 < 0.1
        assert abs(b.count() - 2048) / 2048 < 0.1
        dest = pod.get_hyper_log_log("grp:dest")
        got = dest.merge_with_and_count("grp:a", "grp:b")
        assert got == a.count_with("grp:b")
        assert dest.count() == got
    finally:
        pod.shutdown()


def test_port_pod_bitset_is_mesh_sharded(podc):
    bs = podc.get_bit_set("sb:shardcheck")
    bs.set(100_000)
    back = podc._routing.sketch
    obj = back._bits["sb:shardcheck"]
    ranges = mesh_mod.row_blocks(obj.state.shape[0], back.mesh)
    assert len(ranges) == back.mesh.size == 8
    assert len({hi - lo for lo, hi in ranges}) == 1
    assert back.store.get("sb:shardcheck") is None  # NOT delegated


def test_port_pod_bits_checkpoint_roundtrip(tmp_path, podc):
    bs = podc.get_bit_set("sb:ck")
    bs.set_bits([5, 17, 40_000])
    bf = podc.get_bloom_filter("sb:ckb")
    bf.try_init(1000, 0.01)
    keys = np.arange(500, dtype=np.uint64)
    bf.add_ints(keys)
    path = str(tmp_path / "podbits")
    podc.save_checkpoint(path, names=["sb:ck", "sb:ckb"])
    c2 = RedissonTorch.create(pod_config())
    try:
        assert c2.load_checkpoint(path) == 2
        assert list(c2.get_bit_set("sb:ck").get_bits([5, 17, 40_000, 6])) == [
            True, True, True, False]
        assert c2.get_bloom_filter("sb:ckb").contains_count_ints(keys) == 500
        assert "sb:ck" in c2._pod_backend()._bits
    finally:
        c2.shutdown()
    c3 = RedissonTorch.create(cpu_config())
    try:
        assert c3.load_checkpoint(path) == 2
        assert c3.get_bit_set("sb:ck").cardinality() == 3
        assert c3.get_bloom_filter("sb:ckb").contains_count_ints(keys) == 500
    finally:
        c3.shutdown()


def test_port_client_topology_manager_facade():
    c = RedissonTorch.create(pod_config())
    try:
        tm = c.get_topology_manager(scan_interval_s=0.1)
        assert tm.live_nodes()
        assert not tm.scan_once()
    finally:
        c.shutdown()


# -- the port's own rules -------------------------------------------------------


def test_pod_asks_for_the_card():
    cfg = Config()
    cfg.use_pod()
    assert cfg.pod.device == "cuda:0"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            RedissonTorch.create(cfg)
        with pytest.raises(RuntimeError):
            build_mesh(4)


def test_pod_config_modes():
    cfg = pod_config()
    assert cfg.mode() == "pod"
    assert Config.from_json(cfg.to_json()).pod == cfg.pod
    both = pod_config()
    both.use_cuda(device="cpu")
    with pytest.raises(ValueError, match="multiple backend modes"):
        both.mode()
    with pytest.raises(NotImplementedError, match="hll_hash"):
        RedissonTorch.create(pod_config(hll_hash="redis"))
    c = RedissonTorch.create(pod_config())
    try:
        assert c.info()["server"]["mode"] == "pod"
        assert c.memory_verify()["ok"]
    finally:
        c.shutdown()


def test_mesh_spanning_two_cards_raises():
    """A mesh naming two cards: the mesh data plane takes it (its bank is
    one block per entry, each on its entry's card: tests/test_torch_cuda.py
    runs it on several cards), and `attach_mesh` raises only for a backend
    that is not on the mesh's home. Without a card, the fields
    `attach_mesh` reads stand in for a backend on `cuda:0`."""
    import types

    from redisson_tpu_torch.backend_torch import RowAllocator, TorchBackend
    from redisson_tpu_torch.store import SketchStore

    cuda0 = torch.device("cuda", 0)
    two = Mesh(mesh_mod.SLOT_AXIS, (cuda0, torch.device("cuda", 1)))
    assert two.home == cuda0
    assert not hasattr(two, "device") and not hasattr(mesh_mod, "MULTI_CARD_ITEM")
    backend = TorchBackend(SketchStore(torch.device("cpu")))
    with pytest.raises(ValueError, match="home"):
        backend.attach_mesh(two, 2)
    assert backend.mesh is None
    card = types.SimpleNamespace(bank=None, device=cuda0,
                                 _alloc=RowAllocator(255, None))
    TorchBackend.attach_mesh(card, two, 2)
    sb = card._sharded_bank
    assert card.bank is None  # still lazy: made in blocks on first use
    assert sb.ndev == 2 and card.mesh.home == cuda0
    assert sb.capacity == card._alloc.capacity == 256
    assert sb.sharding.mesh is two and sb.sharding.axis == mesh_mod.SLOT_AXIS


def test_mesh_cache_keys_on_device_set():
    a = mesh_mod.get_mesh(4, device="cpu")
    assert mesh_mod.get_mesh(4, device="cpu") is a
    assert mesh_mod.get_mesh(4, axis=mesh_mod.SLOT_AXIS, device="cpu") is not a
    assert mesh_mod.get_mesh(0, device="cpu").size == 1


@pytest.mark.parametrize("cap_offset,segment", [(-1, False), (0, True)])
def test_pod_bloom_shard_size_rule(monkeypatch, mesh, cap_offset, segment):
    """A shard of more cells than the segment-OR's cap takes the plain
    scatter_, decided by size before any launch; both give the same
    cells."""
    m = bloom_math.optimal_num_of_bits(3000, 0.01)
    k = bloom_math.optimal_num_of_hash_functions(3000, m)
    bits = sharded_bits.make_bits(mesh, m)
    per_shard = bits.shape[0] // mesh.size
    monkeypatch.setattr(ingest_kernels, "MAX_SEGMENT_CELLS",
                        per_shard + cap_offset)
    calls = []
    real = ingest_kernels.bits_insert_segmented

    def spy(cells, idx):
        calls.append(cells.shape[0])
        return real(cells, idx)

    monkeypatch.setattr(ingest_kernels, "bits_insert_segmented", spy)
    keys = np.random.default_rng(5).integers(0, 2**63, 3000).astype(np.int64)
    bits, added = sharded_bits.bloom_add_packed(bits, keys, 3000, k, m, 0, mesh)
    assert calls == ([per_shard] * mesh.size if segment else [])
    want = torch.zeros(bits.shape[0], dtype=torch.uint8)
    h1, h2 = hashing.murmur3_x64_128_u64(torch.from_numpy(keys))
    from redisson_tpu_torch.ops import bloom

    want[bloom.indexes(h1, h2, k, m).reshape(-1)] = 1
    assert np.array_equal(np.asarray(bits), want.numpy())
    assert bool(added.all())


# -- against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def jmesh():
    return jbuild_mesh(8)


@pytest.mark.parametrize("pre_hashed", [False, True])
def test_bank_insert_equals_jax(mesh, jmesh, pre_hashed):
    rng = np.random.default_rng(11)
    n, s = 3000, 64
    keys = rng.integers(0, 2**63, n, dtype=np.int64).view(np.uint64)
    hi, lo = _split(keys)
    row = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    jbank = jsharded.make_bank(jmesh, s)
    bank = sharded.make_bank(mesh, s)
    for part in (slice(0, 1000), slice(1000, n)):
        jbank, jchanged = jsharded.bank_insert(
            jbank, hi[part], lo[part], row[part], valid[part], jmesh, 0,
            pre_hashed)
        bank, changed = sharded.bank_insert(
            bank, hi[part], lo[part], row[part], valid[part], mesh, 0,
            pre_hashed)
        assert np.array_equal(np.asarray(changed), np.asarray(jchanged))
    assert np.array_equal(np.asarray(bank), np.asarray(jbank))
    assert np.array_equal(sharded.bank_merge_all(bank, mesh).numpy(),
                          np.asarray(jsharded.bank_merge_all(jbank, jmesh)))
    got = float(sharded.bank_count_all(bank, mesh))
    exp = float(jsharded.bank_count_all(jbank, jmesh))
    assert abs(got - exp) <= 1e-5 * exp


def test_sharded_bits_equal_jax(mesh, jmesh):
    rng = np.random.default_rng(7)
    nbits = 200_000
    jbits = jsbits.make_bits(jmesh, nbits)
    bits = sharded_bits.make_bits(mesh, nbits)
    assert bits.shape[0] == jbits.shape[0]
    for step in range(4):
        idx = rng.integers(0, nbits, 2048).astype(np.uint32)
        valid = rng.random(2048) < 0.95
        fn, jfn = ((sharded_bits.set_bits, jsbits.set_bits) if step % 3 != 2
                   else (sharded_bits.clear_bits, jsbits.clear_bits))
        jbits, jold = jfn(jbits, idx, valid, jmesh)
        bits, old = fn(bits, idx.astype(np.int64), valid, mesh)
        assert np.array_equal(old.numpy(), np.asarray(jold))
    probe = rng.integers(0, nbits, 1024).astype(np.uint32)
    pvalid = np.ones(1024, bool)
    assert np.array_equal(
        sharded_bits.get_bits(bits, probe.astype(np.int64), pvalid, mesh).numpy(),
        np.asarray(jsbits.get_bits(jbits, probe, pvalid, jmesh)))
    assert sharded_bits.cardinality(bits, mesh) == jsbits.cardinality(jbits)
    assert sharded_bits.length(bits, mesh) == jsbits.length(jbits)
    jbits = jsbits.set_range(jbits, np.uint32(50_001), np.uint32(123_456), True)
    bits = sharded_bits.set_range(bits, 50_001, 123_456, True, mesh)
    jbits = jsbits.set_range(jbits, np.uint32(70_000), np.uint32(70_100), False)
    bits = sharded_bits.set_range(bits, 70_000, 70_100, False, mesh)
    assert np.array_equal(np.asarray(bits), np.asarray(jbits))
    jbits = jsbits.bitop_not(jbits, np.uint32(150_000 - 1))
    bits = sharded_bits.bitop_not(bits, 150_000 - 1, mesh)
    assert np.array_equal(np.asarray(bits), np.asarray(jbits))
    assert sharded_bits.length(bits, mesh) == jsbits.length(jbits)
    other = (rng.random(bits.shape[0]) < 0.3).astype(np.uint8)
    for op in ("and", "or", "xor"):
        got = sharded_bits.bitop(
            [bits, sharded_bits.bits_sharding(mesh).put(other)], op, mesh)
        exp = jsbits.bitop(jnp.stack([jbits, jnp.asarray(other)]), op)
        assert np.array_equal(np.asarray(got), np.asarray(exp)), op


def test_bitcount_and_length_at_the_top_index(mesh, jmesh):
    """Index 2^32 - 1 of a bit array reaches LENGTH 2^32 in Python ints
    (JAX's +1 on the host); shown on the combine, not on a 4 GiB array."""
    assert sharded_bits.combine_partials(
        [torch.full((2,), (1 << 31) - 1, dtype=torch.int32)] * 2) == 4 * ((1 << 31) - 1)
    bits = sharded_bits.make_bits(mesh, 1 << 16)
    bits.blocks[-1][-1] = 1
    assert sharded_bits.length(bits, mesh) == bits.shape[0]


@pytest.mark.parametrize("layout", ["classic", "blocked"])
def test_pod_bloom_equals_jax(mesh, jmesh, layout):
    rng = np.random.default_rng(3)
    m = bloom_math.optimal_num_of_bits(5000, 0.01)
    k = bloom_math.optimal_num_of_hash_functions(5000, m)
    if layout == "blocked":
        from redisson_tpu_torch.ops import bloom

        m = bloom.blocked_geometry(m)
    jbits = jsbits.make_bits(jmesh, m)
    bits = sharded_bits.make_bits(mesh, m)
    for _ in range(3):
        keys = rng.integers(0, 2**63, 1024, dtype=np.int64)
        packed = keys.view(np.uint32).reshape(-1, 2)
        count = 1000
        jbits, jadded = jsbits.bloom_add_packed(
            jbits, packed, np.int32(count), k, m, 0, jmesh, layout)
        bits, added = sharded_bits.bloom_add_packed(
            bits, keys, count, k, m, 0, mesh, layout)
        assert np.array_equal(added.numpy(), np.asarray(jadded))
    assert np.array_equal(np.asarray(bits), np.asarray(jbits))
    probe = rng.integers(0, 2**63, 1024, dtype=np.int64)
    got = sharded_bits.bloom_contains_packed(bits, probe, 1024, k, m, 0, mesh, layout)
    exp = jsbits.bloom_contains_packed(
        jbits, probe.view(np.uint32).reshape(-1, 2), np.int32(1024), k, m, 0,
        jmesh, layout)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    data = rng.integers(0, 256, (1024, 16), dtype=np.uint8)
    lengths = rng.integers(0, 17, 1024).astype(np.int32)
    valid = np.ones(1024, bool)
    jbits, jadded = jsbits.bloom_add_bytes(jbits, data, lengths, valid, k, m,
                                           0, jmesh, layout)
    bits, added = sharded_bits.bloom_add_bytes(bits, data, lengths, valid, k, m,
                                               0, mesh, layout)
    assert np.array_equal(added.numpy(), np.asarray(jadded))
    assert np.array_equal(np.asarray(bits), np.asarray(jbits))


def _pod_sequence(c, seed, n_ops=300):
    """A seeded mixed op stream over the pod tier; (kind, value) replies,
    kind 'count' for PFCOUNT-valued ones."""
    rng = random.Random(seed)
    out = []

    def plain(v):
        if isinstance(v, np.ndarray):
            return [bool(x) for x in v.tolist()]
        if isinstance(v, (np.bool_, np.integer)):
            return v.item()
        return v

    bf = c.get_bloom_filter("ps:bloom")
    out.append(("v", bf.try_init(4000, 0.01)))
    bb = c.get_bloom_filter("ps:blk")
    out.append(("v", bb.try_init(2000, 0.02, blocked=True)))
    for i in range(n_ops):
        k = rng.randrange(14)
        x = rng.randrange(1 << 16)
        h = c.get_hyper_log_log(f"ps:h{x % 6}")
        if k == 0:
            out.append(("v", h.add_all([b"h%d:%d" % (i, j) for j in range(x % 64 + 1)])))
        elif k == 1:
            out.append(("v", h.add_ints(np.arange(x, x + 500, dtype=np.uint64))))
        elif k == 2:
            out.append(("count", h.count()))
        elif k == 3:
            out.append(("count", h.count_with(f"ps:h{(x + 1) % 6}", f"ps:h{(x + 2) % 6}")))
        elif k == 4:
            out.append(("count", h.merge_with_and_count(f"ps:h{(x + 3) % 6}")))
        elif k == 5:
            bs = c.get_bit_set(f"ps:b{x % 3}")
            out.append(("v", plain(bs.set_bits([x, x * 7 % 90_000, 5]))))
        elif k == 6:
            bs = c.get_bit_set(f"ps:b{x % 3}")
            out.append(("v", plain(bs.clear_bits([x, 5]))))
        elif k == 7:
            bs = c.get_bit_set(f"ps:b{x % 3}")
            out.append(("v", (bs.cardinality(), bs.length(), bs.size())))
        elif k == 8:
            bs = c.get_bit_set(f"ps:b{x % 3}")
            bs.set_range(x % 500, x % 500 + x % 3000, value=bool(x & 1))
            out.append(("v", bs.cardinality()))
        elif k == 9:
            d = c.get_bit_set("ps:dst")
            op = ("or_", "and_", "xor")[x % 3]
            getattr(d, op)(f"ps:b{x % 3}")
            out.append(("v", d.cardinality()))
        elif k == 10:
            c.get_bit_set(f"ps:b{x % 3}").not_()
            out.append(("v", c.get_bit_set(f"ps:b{x % 3}").cardinality()))
        elif k == 11:
            out.append(("v", plain(bf.add_ints(np.arange(x, x + 64, dtype=np.uint64)))))
        elif k == 12:
            out.append(("v", bf.contains_count_ints(np.arange(x, x + 256, dtype=np.uint64))))
        else:
            keys = [b"b%d" % (x + j) for j in range(20)]
            bb.add_all(keys)
            out.append(("v", plain(bb.contains_all(keys))))
    out.append(("count", bf.count()))
    out.append(("v", sorted(c.keys("ps:*"))))
    return out


def _pod_state(c, names):
    state = {}
    for n in names:
        if n.startswith("ps:h"):
            exported = c._executor.execute_sync(n, "hll_export", None)
            state[n] = None if exported is None else np.asarray(exported[0]).tobytes()
        else:
            exported = c._executor.execute_sync(n, "bits_export", None)
            state[n] = None if exported is None else (
                exported[0], np.asarray(exported[1]).tobytes())
    return state


def _assert_same_replies(res, jres):
    assert len(res) == len(jres)
    for i, ((kind, v), (_, jv)) in enumerate(zip(res, jres)):
        if kind == "count":
            assert abs(v - jv) <= 1e-5 * max(jv, 1), (i, v, jv)
        else:
            assert v == jv, (i, v, jv)


@pytest.mark.parametrize("seed", [1, 2])
def test_pod_sequence_equals_jax(seed):
    jcfg = JConfig()
    jcfg.use_pod().bank_capacity = 64
    jc = RedissonTPU.create(jcfg)
    try:
        jres = _pod_sequence(jc, seed)
        names = sorted(jc.keys("ps:*"))
        jstate = _pod_state(jc, names)
    finally:
        jc.shutdown()
    c = RedissonTorch.create(pod_config(bank_capacity=64))
    try:
        res = _pod_sequence(c, seed)
        state = _pod_state(c, names)
    finally:
        c.shutdown()
    _assert_same_replies(res, jres)
    assert state == jstate


def test_jax_pod_state_carried_into_the_port():
    jcfg = JConfig()
    jcfg.use_pod().bank_capacity = 16
    jc = RedissonTPU.create(jcfg)
    try:
        _pod_sequence(jc, 5, n_ops=80)
        jback = jc._routing.sketch
        objects = {n: jc._executor.execute_sync(n, "bits_export", None)
                   for n in jback.sharded_bits_names()}
        bank, rows = np.asarray(jback.bank), dict(jback._rows)
        more = _pod_sequence(jc, 6, n_ops=80)
        names = sorted(jc.keys("ps:*"))
        jstate = _pod_state(jc, names)
    finally:
        jc.shutdown()
    c = RedissonTorch.create(pod_config())
    try:
        c.from_jax_state(bank, rows, objects)
        got = _pod_sequence(c, 6, n_ops=80)
        state = _pod_state(c, names)
        nb, nrows = c.to_numpy_state()
        assert nrows == {n: r for n, r in c._pod_backend()._rows.items()}
    finally:
        c.shutdown()
    _assert_same_replies(got, more)
    assert state == jstate
