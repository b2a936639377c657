"""Multi-card placement of the pod tier, on the CPU against the JAX pod.

The port keeps each mesh entry's rows of the HLL bank and each entry's
cell range of every BitSet and Bloom filter as a tensor of its own on the
entry's device (`parallel.mesh.Sharded`); on the CPU every entry is the
CPU, so these tests run the layout several cards run. Each is held
against the JAX pod on the virtual CPU devices (tests/conftest.py), bit
for bit, PFCOUNT within rel 1e-5:

  * every block is its own tensor, with S/D rows or n/D cells, equal to
    JAX's addressable shard of the same entry;
  * growth across a block boundary (rows and cells change entries);
  * reshard 4 -> 2 -> 4 -> 1 and on_device_loss(2), for the bank, a BitSet
    and a Bloom filter;
  * PFMERGE / countWith over rows of three blocks into a fourth's row;
  * BITOP over BitSets of different sizes; hll_export / hll_import of a
    row of the last block; the memstat ledger against the blocks' bytes;
  * a JAX pod's state carried into the blocked layout.

Also the public names the port gained beside it, each against its JAX
counterpart: the placement names, `native.hll_fold_u64_rows` feeding the
blocked `bank_absorb_host`, `JournalCorruption` and
`Journal.segment_count`, `PersistenceManager.sync`, `WindowTape.n_entries`,
and `engine.bitset_cardinality` / `bitset_length`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from redisson_tpu import engine as jengine
from redisson_tpu import native as jnative
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.ingest import tape as jtape
from redisson_tpu.ingest.delta import encode as jencode
from redisson_tpu.parallel import mesh as jmesh_mod
from redisson_tpu.parallel import sharded as jsharded
from redisson_tpu.parallel import sharded_bits as jsbits
from redisson_tpu.persist import journal as jjournal
from redisson_tpu_torch import engine, native
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ingest import tape
from redisson_tpu_torch.ingest.delta import encode
from redisson_tpu_torch.memstat.accounting import BANK_ENTRY
from redisson_tpu_torch.parallel import mesh as mesh_mod
from redisson_tpu_torch.parallel import sharded, sharded_bits
from redisson_tpu_torch.persist import journal

M = 16384


def _mesh(n):
    return mesh_mod.build_mesh(n, device="cpu")


def _shards(arr):
    """JAX's addressable shards of a 1-D mesh array, in entry order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


def _same_blocks(got, jarr):
    """The port's blocks equal JAX's shards one for one, each a tensor of
    its own on its entry's device."""
    want = _shards(jarr)
    assert len(got.blocks) == len(want) == got.mesh.size
    for block, dev, w in zip(got.blocks, got.mesh.devices, want):
        assert block.device == dev
        assert np.array_equal(block.numpy(), w)
    assert len({b.untyped_storage().data_ptr() for b in got.blocks}) == len(want)


def _split(keys):
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _fill_bank(bank, jbank, mesh, jmesh, s, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**63, 4000, dtype=np.int64).view(np.uint64)
    hi, lo = _split(keys)
    row = rng.integers(0, s, 4000).astype(np.int32)
    valid = np.ones(4000, bool)
    jbank, jchanged = jsharded.bank_insert(jbank, hi, lo, row, valid, jmesh)
    bank, changed = sharded.bank_insert(bank, hi, lo, row, valid, mesh)
    assert np.array_equal(np.asarray(changed), np.asarray(jchanged))
    return bank, jbank


def pod_config(num_shards=4, bank_capacity=16) -> Config:
    cfg = Config()
    cfg.use_pod(device="cpu", num_shards=num_shards, bank_capacity=bank_capacity)
    return cfg


def jpod_config(num_shards=4, bank_capacity=16) -> JConfig:
    cfg = JConfig()
    pod = cfg.use_pod()
    pod.num_shards = num_shards
    pod.bank_capacity = bank_capacity
    return cfg


# -- the blocks ----------------------------------------------------------------


def test_every_block_is_a_tensor_of_its_own():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    bank = sharded.make_bank(mesh, 16)
    assert bank.shape == (16, M) and bank.per == 4
    assert [tuple(b.shape) for b in bank.blocks] == [(4, M)] * 4
    _same_blocks(bank, jsharded.make_bank(jmesh, 16))
    bits = sharded_bits.make_bits(mesh, 100_000)
    jbits = jsbits.make_bits(jmesh, 100_000)
    assert len(bits) == jbits.shape[0]
    assert {b.shape[0] for b in bits.blocks} == {len(bits) // 4}
    _same_blocks(bits, jbits)
    assert bank.locate(5) == (1, 1) and bank.locate(15) == (3, 3)
    with pytest.raises(IndexError):
        bank.locate(16)


def test_pod_client_state_is_blocked():
    c = RedissonTorch.create(pod_config())
    try:
        c.get_hyper_log_log("h").add_all([b"a", b"b"])
        c.get_bit_set("bs").set(70_000)
        c.get_bloom_filter("bf").try_init(1000, 0.01)
        be = c._pod_backend()
        assert be.device == be.mesh.home == torch.device("cpu")
        for arr in [be.bank] + [o.state for o in be._bits.values()]:
            assert len(arr.blocks) == 4
            assert len({b.untyped_storage().data_ptr() for b in arr.blocks}) == 4
            assert len({b.shape[0] for b in arr.blocks}) == 1
    finally:
        c.shutdown()


def test_pressure_snapshot_reads_each_device_of_the_pod():
    """The pressure snapshot's `devices` holds one `device_memory` section
    per distinct device of the pod's mesh, home first, and `device` is the
    home's (a deliberate difference: JAX's snapshot reads no device). On
    the CPU the four entries are one device; the card tests cover four
    cards."""
    from redisson_tpu_torch.memstat.pressure import device_memory

    cfg = pod_config()
    cfg.use_memstat(high_watermark_bytes=1 << 30)
    c = RedissonTorch.create(cfg)
    try:
        want = device_memory("cpu", 1 << 30)
        for n in (None, 2):
            if n is not None:
                be = c._pod_backend()
                c._executor.execute_barrier(lambda: be.reshard(n)).result()
            snap = c._pressure.snapshot()
            assert snap["devices"] == {"cpu": want} and snap["device"] == want
    finally:
        c.shutdown()


# -- growth across a block boundary --------------------------------------------


def test_grow_bank_across_a_block_boundary_equals_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    bank, jbank = _fill_bank(sharded.make_bank(mesh, 8),
                             jsharded.make_bank(jmesh, 8), mesh, jmesh, 8, 1)
    assert bank.locate(2) == (1, 0)
    bank = sharded.grow_bank(bank, 16, mesh)
    jbank = jsharded.grow_bank(jbank, 16, jmesh)
    # Row 2 moved from entry 1 to entry 0, as in JAX.
    assert bank.locate(2) == (0, 2)
    _same_blocks(bank, jbank)
    bank, jbank = _fill_bank(bank, jbank, mesh, jmesh, 16, 2)
    _same_blocks(bank, jbank)


def test_grow_bits_across_a_block_boundary_equals_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    bits = sharded_bits.make_bits(mesh, 4096)
    jbits = jsbits.make_bits(jmesh, 4096)
    idx = np.array([0, 1500, 3000, 4095], np.uint32)
    valid = np.ones(4, bool)
    bits, _ = sharded_bits.set_bits(bits, idx.astype(np.int64), valid, mesh)
    jbits, _ = jsbits.set_bits(jbits, idx, valid, jmesh)
    assert [bits.locate(int(i))[0] for i in idx] == [0, 1, 2, 3]
    bits = sharded_bits.grow_bits(bits, 3 * 4096, mesh)
    jbits = jsbits.grow_bits(jbits, 3 * 4096, jmesh)
    assert [bits.locate(int(i))[0] for i in idx] == [0, 0, 0, 1]
    _same_blocks(bits, jbits)
    idx2 = np.array([3071, 3072, 12_000], np.uint32)
    bits, old = sharded_bits.set_bits(bits, idx2.astype(np.int64), np.ones(3, bool), mesh)
    jbits, jold = jsbits.set_bits(jbits, idx2, np.ones(3, bool), jmesh)
    assert np.array_equal(old.numpy(), np.asarray(jold))
    _same_blocks(bits, jbits)


# -- reshard and device loss ---------------------------------------------------


def test_migrate_functions_equal_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    bank, jbank = _fill_bank(sharded.make_bank(mesh, 16),
                             jsharded.make_bank(jmesh, 16), mesh, jmesh, 16, 3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 50_000, 3000).astype(np.uint32)
    bits = sharded_bits.make_bits(mesh, 50_000)
    jbits = jsbits.make_bits(jmesh, 50_000)
    bits, _ = sharded_bits.set_bits(bits, idx.astype(np.int64), np.ones(3000, bool), mesh)
    jbits, _ = jsbits.set_bits(jbits, idx, np.ones(3000, bool), jmesh)
    for n in (2, 4, 1):
        mesh, jmesh = _mesh(n), jmesh_mod.build_mesh(n)
        bank = sharded.migrate_bank(bank, mesh)
        jbank = jsharded.migrate_bank(jbank, jmesh)
        bits = sharded_bits.migrate_bits(bits, mesh)
        jbits = jsbits.migrate_bits(jbits, jmesh)
        _same_blocks(bank, jbank)
        _same_blocks(bits, jbits)


def _pod_write(c, i):
    rng = np.random.default_rng(i)
    for j in range(12):
        c.get_hyper_log_log(f"r:h{j}").add_ints(
            rng.integers(0, 2**62, 300).astype(np.uint64))
    c.get_bit_set("r:bits").set_bits([int(x) for x in rng.integers(0, 90_000, 200)])
    bf = c.get_bloom_filter("r:bloom")
    bf.try_init(3000, 0.01)
    bf.add_ints(rng.integers(0, 2**62, 500).astype(np.uint64))


def _pod_view(c):
    state = {}
    for n in sorted(c.keys("r:*")):
        kind = "hll_export" if n.startswith("r:h") else "bits_export"
        got = c._executor.execute_sync(n, kind, None)
        state[n] = np.asarray(got[0] if kind == "hll_export" else got[1]).tobytes()
    counts = [c.get_hyper_log_log(f"r:h{j}").count() for j in range(12)]
    return state, counts


def _same_view(view, jview):
    assert view[0] == jview[0]
    assert all(abs(a - b) <= 1e-5 * max(b, 1) for a, b in zip(view[1], jview[1]))


def test_reshard_and_device_loss_equal_jax():
    jc = RedissonTPU.create(jpod_config())
    c = RedissonTorch.create(pod_config())
    try:
        jbe, be = jc._routing.sketch, c._pod_backend()
        _pod_write(jc, 0)
        _pod_write(c, 0)
        _same_view(_pod_view(c), _pod_view(jc))
        steps = [("reshard", 2), ("reshard", 4), ("reshard", 1),
                 ("reshard", 4), ("on_device_loss", 2)]
        for i, (how, n) in enumerate(steps, start=1):
            getattr(jbe, how)(n)
            c._executor.execute_barrier(lambda how=how, n=n: getattr(be, how)(n)).result()
            assert be.mesh.size == jbe.mesh.devices.size == n
            assert len(be.bank.blocks) == n
            assert np.array_equal(c.to_numpy_state()[0], np.asarray(jbe.bank))
            _same_blocks(be.bank, jbe.bank)
            for name, obj in be._bits.items():
                _same_blocks(obj.state, jbe._bits[name].state)
            _same_view(_pod_view(c), _pod_view(jc))
            _pod_write(jc, i)  # and they keep serving writes
            _pod_write(c, i)
            _same_view(_pod_view(c), _pod_view(jc))
        assert c.memory_verify()["ok"]
    finally:
        c.shutdown()
        jc.shutdown()


# -- cross-block merges, BITOP, export / import ----------------------------------


def test_merge_rows_across_blocks_equal_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    host = np.random.default_rng(6).integers(0, 30, (16, M)).astype(np.int32)
    rows = np.array([1, 5, 9, 5, 13], np.int32)  # blocks 0, 1, 2 and the target's
    target = 13
    bank = mesh_mod.bank_sharding(mesh).put(host)
    jplace = jmesh_mod.bank_sharding(jmesh)
    got = float(sharded.bank_count_rows_merged(bank, rows, mesh))
    want = float(jsharded.bank_count_rows_merged(jax.device_put(host, jplace),
                                                 jnp.asarray(rows), jmesh))
    assert abs(got - want) <= 1e-5 * want
    bank = sharded.bank_merge_rows(bank, rows, target)
    jbank = jsharded.bank_merge_rows(jax.device_put(host, jplace), jnp.asarray(rows),
                                     jnp.int32(target))
    _same_blocks(bank, jbank)
    bank = mesh_mod.bank_sharding(mesh).put(host)
    bank, est = sharded.bank_merge_count_rows(bank, rows, target)
    jbank, jest = jsharded.bank_merge_count_rows(
        jax.device_put(host, jplace), jnp.asarray(rows), jnp.int32(target))
    _same_blocks(bank, jbank)
    assert abs(float(est) - float(jest)) <= 1e-5 * float(jest)
    # The client's PFMERGE / countWith over names in three blocks.
    out = []
    for c in (RedissonTorch.create(pod_config()), RedissonTPU.create(jpod_config())):
        try:
            for j in range(16):
                c.get_hyper_log_log(f"m:{j}").add_ints(
                    np.arange(j * 500, j * 500 + 2000, dtype=np.uint64))
            dst = c.get_hyper_log_log("m:15")
            out.append((dst.count_with("m:1", "m:5", "m:9"),
                        dst.merge_with_and_count("m:1", "m:5", "m:9"),
                        c._executor.execute_sync("m:15", "hll_export", None)[0].tobytes()))
        finally:
            c.shutdown()
    (a, b, regs), (ja, jb, jregs) = out
    assert abs(a - ja) <= 1e-5 * ja and abs(b - jb) <= 1e-5 * jb and regs == jregs


def test_bitop_of_different_sizes_equals_jax():
    out = []
    for c in (RedissonTorch.create(pod_config()), RedissonTPU.create(jpod_config())):
        try:
            c.get_bit_set("b:small").set_bits(list(range(0, 1000, 3)))
            c.get_bit_set("b:mid").set_bits(list(range(0, 100_000, 7)))
            c.get_bit_set("b:big").set_bits(list(range(0, 300_000, 11)))
            res = []
            for op in ("or_", "and_", "xor"):
                dst = c.get_bit_set(f"b:{op}")
                dst.or_("b:small")
                getattr(dst, op)("b:mid", "b:big")
                cells = c._executor.execute_sync(f"b:{op}", "bits_export", None)[1]
                res.append((dst.cardinality(), dst.length(), dst.size(),
                            np.asarray(cells).tobytes()))
            out.append(res)
        finally:
            c.shutdown()
    assert out[0] == out[1]


def test_hll_export_import_in_the_last_block_equals_jax():
    regs = np.random.default_rng(8).integers(0, 20, M).astype(np.uint8)
    out = []
    for c in (RedissonTorch.create(pod_config()), RedissonTPU.create(jpod_config())):
        try:
            for j in range(16):
                c.get_hyper_log_log(f"e:{j}").add_all([b"k%d" % j])
            last = "e:15"
            if isinstance(c, RedissonTorch):
                be = c._pod_backend()
                assert be.bank.locate(be._rows[last])[0] == 3
            before = c._executor.execute_sync(last, "hll_export", None)[0]
            c._executor.execute_sync(last, "hll_import", {"regs": regs})
            after = c._executor.execute_sync(last, "hll_export", None)[0]
            out.append((before.tobytes(), after.tobytes(),
                        c.get_hyper_log_log(last).count()))
        finally:
            c.shutdown()
    assert out[0][:2] == out[1][:2] and out[0][1] == regs.tobytes()
    assert abs(out[0][2] - out[1][2]) <= 1e-5 * out[1][2]


def test_memstat_ledger_is_the_blocks_bytes():
    c = RedissonTorch.create(pod_config())
    try:
        be = c._pod_backend()
        for j in range(40):  # past the capacity: the bank grows
            c.get_hyper_log_log(f"g:{j}").add_all([b"x"])
        for n in (None, 2, 4):
            if n is not None:
                c._executor.execute_barrier(lambda n=n: be.reshard(n)).result()
            blocks = sum(b.nbytes for b in be.bank.blocks)
            assert be.accounting.entry(BANK_ENTRY)["nbytes"] == blocks
            assert blocks == len(be.bank) * M * 4
            assert c.memory_verify()["ok"]
    finally:
        c.shutdown()


def test_jax_pod_state_carries_into_the_blocks():
    jc = RedissonTPU.create(jpod_config())
    try:
        _pod_write(jc, 9)
        jbe = jc._routing.sketch
        objects = {n: jc._executor.execute_sync(n, "bits_export", None)
                   for n in jbe.sharded_bits_names()}
        jbank, rows = np.asarray(jbe.bank), dict(jbe._rows)
        jview = _pod_view(jc)
        jshards = {n: o.state for n, o in jbe._bits.items()}
        c = RedissonTorch.create(pod_config())
        try:
            c._executor.execute_barrier(
                lambda: c._pod_backend().from_jax_state(jbank, rows, objects)).result()
            be = c._pod_backend()
            _same_blocks(be.bank, jbe.bank)
            for name, obj in be._bits.items():
                _same_blocks(obj.state, jshards[name])
            _same_view(_pod_view(c), jview)
        finally:
            c.shutdown()
    finally:
        jc.shutdown()


# -- the public names ----------------------------------------------------------


def test_placement_names_equal_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    host = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    _same_blocks(mesh_mod.bank_sharding(mesh).put(host),
                 jax.device_put(host, jmesh_mod.bank_sharding(jmesh)))
    cells = (np.arange(4096) % 3 == 0).astype(np.uint8)
    _same_blocks(sharded_bits.bits_sharding(mesh).put(cells),
                 jax.device_put(cells, jsbits.bits_sharding(jmesh)))
    slots = mesh_mod.build_mesh(4, mesh_mod.SLOT_AXIS, device="cpu")
    jslots = jmesh_mod.build_mesh(4, jmesh_mod.SLOT_AXIS)
    _same_blocks(mesh_mod.slot_sharding(slots).put(host),
                 jax.device_put(host, jmesh_mod.slot_sharding(jslots)))
    with pytest.raises(ValueError, match="axis"):
        mesh_mod.slot_sharding(mesh)
    copies = mesh_mod.replicated(mesh)(host)
    jcopy = jax.device_put(host, jmesh_mod.replicated(jmesh))
    assert len(copies) == len(jcopy.addressable_shards) == 4
    for t, s in zip(copies, jcopy.addressable_shards):
        assert np.array_equal(t.numpy(), np.asarray(s.data))
    assert all(t is copies[0] for t in copies)  # entries of one device share it
    sb = mesh_mod.ShardedBank(slots, 10, 3)
    jsb = jmesh_mod.ShardedBank(jslots, 10, 3)
    assert sb.ndev == jsb.ndev == 4 and sb.capacity == jsb.capacity == 12


def test_hll_fold_u64_rows_feeds_the_blocked_absorb_equals_jax():
    mesh, jmesh = _mesh(4), jmesh_mod.build_mesh(4)
    rng = np.random.default_rng(10)
    keys = rng.integers(0, 2**63, 20_000, dtype=np.int64).view(np.uint64)
    rows = rng.integers(-1, 17, 20_000).astype(np.int32)  # -1 and 16 are skipped
    host = native.hll_fold_u64_rows(keys, rows, np.zeros((16, M), np.uint8), seed=3)
    jhost = jnative.hll_fold_u64_rows(keys, rows, np.zeros((16, M), np.uint8), seed=3)
    assert np.array_equal(host, jhost)
    with pytest.raises(ValueError):
        native.hll_fold_u64_rows(keys, rows[:5], np.zeros((16, M), np.uint8))
    bank, jbank = _fill_bank(sharded.make_bank(mesh, 16),
                             jsharded.make_bank(jmesh, 16), mesh, jmesh, 16, 11)
    bank = sharded.bank_absorb_host(bank, host, mesh)
    jbank = jsharded.bank_absorb_host(jbank, jhost, jmesh)
    _same_blocks(bank, jbank)


class _Op:
    def __init__(self, target, kind, payload):
        self.target, self.kind, self.payload = target, kind, payload


def test_journal_corruption_and_segment_count_equal_jax(tmp_path):
    assert issubclass(journal.JournalCorruption, RuntimeError)
    assert (journal.JournalCorruption.__mro__[1:]
            == jjournal.JournalCorruption.__mro__[1:])
    counts = []
    for mod, sub in ((journal, "port"), (jjournal, "jax")):
        j = mod.Journal(str(tmp_path / sub), fsync="always", segment_max_bytes=1 << 16)
        seen = [j.segment_count()]
        for i in range(40):
            j.append_run("set", [_Op(f"k{i}", "set", {"value": b"x" * 4000})])
            seen.append(j.segment_count())
        j.rotate()
        seen.append(j.segment_count())
        j.remove_segments_below(j.last_seq)
        seen.append(j.segment_count())
        j.close()
        counts.append(seen)
    assert counts[0] == counts[1] and max(counts[0]) > 1


def test_persistence_manager_sync_equals_jax(tmp_path):
    out = []
    for sub in ("port", "jax"):
        if sub == "port":
            cfg = Config()
            cfg.use_cuda(device="cpu")
            cfg.use_persist(str(tmp_path / sub), fsync="off")
            c = RedissonTorch.create(cfg)
        else:
            cfg = JConfig()
            p = cfg.use_persist(str(tmp_path / sub))
            p.fsync = "off"
            c = RedissonTPU.create(cfg)
        try:
            for i in range(5):
                c.get_hyper_log_log("s:h").add_all([b"k%d" % i])
            j = c.persist.journal
            before = j.durable_seq
            c.persist.sync()
            out.append((before, j.durable_seq, j.last_seq))
        finally:
            c.shutdown()
    assert out[0] == out[1] and out[0][1] == out[0][2] == 5


def test_window_tape_n_entries_equals_jax():
    rng = np.random.default_rng(12)
    planes, jplanes = [], []
    for i in range(6):
        plane = rng.integers(0, 30, M).astype(np.uint8)
        planes.append(encode("hll_add", f"t{i}", plane, cells=M, packed=False,
                             nkeys=10, raw_bytes=80))
        jplanes.append(jencode("hll_add", f"t{i}", plane, cells=M, packed=False,
                               nkeys=10, raw_bytes=80))
    rows = {f"t{i}": i for i in range(6)}.get
    for n in (0, 1, 6):
        assert (tape.encode_window(planes[:n], rows).n_entries
                == jtape.encode_window(jplanes[:n], rows).n_entries == n)


@pytest.mark.parametrize("n,top", [(4096, 4095), (1 << 20, 777_777), (1 << 19, None)])
def test_engine_bitset_cardinality_and_length_equal_jax(n, top):
    cells = (np.random.default_rng(n).random(n) < 0.01).astype(np.uint8)
    if top is None:
        cells[:] = 0
    else:
        cells[top + 1:] = 0
        cells[top] = 1
    got = (engine.bitset_cardinality(torch.from_numpy(cells)),
           engine.bitset_length(torch.from_numpy(cells)))
    want = (jengine.bitset_cardinality(jnp.asarray(cells)),
            jengine.bitset_length(jnp.asarray(cells)))
    assert got == want
    assert got == (int(cells.sum()), 0 if top is None else top + 1)
