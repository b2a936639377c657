"""The mesh data plane's blocked bank, on the CPU against the JAX mesh plane.

On the cluster's mesh data plane (`data_plane="mesh"`) the one shared HLL
bank is a `parallel.mesh.Sharded`: one block of S/D rows per mesh entry, a
tensor of its own on the entry's device (four CPU tensors here, four
tensors of `cuda:0` on one card, one block per card on four), as JAX places
it with `slot_sharding(mesh)`. Each test drives a port mesh plane and a JAX
mesh plane (4 logical shards on the virtual CPU devices of
tests/conftest.py) through the same sequence and holds registers, flags and
replies bit-identical, PFCOUNT within rel 1e-5:

  * the blocks after the first HLL op, growth past a block boundary, and
    a JAX mesh plane's state installed in blocks;
  * a tape window whose HLL rows span all four blocks, mixed with a SETBIT
    and a Bloom add (one launch, the tape counters equal JAX's), and a
    window over the cell budget through the chunked delta merge;
  * device inserts (the plane's `device` ingest) with targets in every
    block, PFMERGE / countWith / merge+count of three blocks' rows into a
    fourth's, hll_export / hll_import, DEL, FLUSHALL;
  * `migrate_slots` of shard 0's range into shard 3 (rows copied across
    blocks);
  * a snapshot of the blocked bank read by the JAX package's loader, and
    its recovery; the memstat ledger against the blocks' bytes;
  * the host fold and the geo planes, which take the blocked bank.
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from redisson_tpu import checkpoint as jcheckpoint
from redisson_tpu import native as jnative
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu_torch import checkpoint, native
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ingest import delta as delta_mod
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.parallel.mesh import SLOT_AXIS, Sharded
from tests.test_torch_tape import _hold

M = 16384
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _fold_libraries():
    """Both host fold libraries (the mesh plane pins `tape` with them),
    asked for when the module's first test runs, not at import."""
    if not (native.available() and jnative.available()):
        pytest.skip("a host fold library failed to build")


def _port(path):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_cluster(num_shards=SHARDS, dir=str(path), data_plane="mesh")
    return RedissonTorch.create(cfg)


def _jax(path):
    cfg = JConfig()
    cfg.use_cluster(num_shards=SHARDS, dir=str(path), data_plane="mesh")
    return RedissonTPU.create(cfg)


@contextlib.contextmanager
def _planes(tmp_path, sub="mp"):
    """(port, jax) mesh-plane clusters of 4 logical shards."""
    tc = _port(tmp_path / f"{sub}-port")
    try:
        jc = _jax(tmp_path / f"{sub}-jax")
        try:
            yield tc, jc
        finally:
            jc.shutdown()
    finally:
        tc.shutdown()


def _mc(c):
    return c.cluster.mesh_client


def _be(c):
    return c.cluster.mesh_client._routing.sketch


def _names(c, prefix, per_shard):
    """`per_shard` names owned by each logical shard, shard by shard."""
    table = c.cluster.router.slot_table()
    out = {s: [] for s in range(SHARDS)}
    i = 0
    while min(len(v) for v in out.values()) < per_shard:
        name = f"{prefix}{i}"
        owner = out[table[key_slot(name)]]
        if len(owner) < per_shard:
            owner.append(name)
        i += 1
    return [n for s in range(SHARDS) for n in out[s]]


def _keys(i, n=2000):
    return np.random.default_rng(1000 + i).integers(0, 2**64, n, dtype=np.uint64)


def _state(c):
    """(bank [S, m], name -> row) of a mesh plane."""
    be = _be(c)
    if isinstance(be.bank, Sharded):
        return be.to_numpy_state()
    return np.asarray(be.bank), dict(be._rows)


def _jax_shards(arr):
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


def _same_banks(tc, jc):
    """Bank and row map equal JAX's; each port block holds its range of
    rows on its entry's device. (JAX's plane spans every device, 8 virtual
    ones here; the port's has an entry per logical shard, 4: on a host of
    four cards both have 4 blocks. Each port block is then two JAX shards.)"""
    bank, rows = _state(tc)
    jbank, jrows = _state(jc)
    assert rows == jrows
    assert np.array_equal(bank, jbank)
    assert np.array_equal(np.concatenate(_jax_shards(_be(jc).bank)), jbank)
    blocks = _be(tc).bank
    assert len(blocks.blocks) == SHARDS
    for (lo, hi), block, dev in zip(blocks.ranges(), blocks.blocks,
                                    blocks.mesh.devices):
        assert block.device == dev
        assert np.array_equal(block.numpy(), jbank[lo:hi])


def _exports(client, names):
    return {n: np.asarray(client._executor.execute_sync(n, "hll_export", None)[0])
            for n in names}


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * max(w, 1), (got, want)


# -- the blocks ----------------------------------------------------------------


def test_bank_is_one_block_per_entry(tmp_path):
    with _planes(tmp_path) as (tc, jc):
        be = _be(tc)
        assert be.bank is None  # lazy until the first HLL op
        for c in (tc, jc):
            c.get_hyper_log_log("b:first").add(b"x")
        bank = be.bank
        assert isinstance(bank, Sharded) and bank.mesh is be.mesh
        assert be.mesh.axis == SLOT_AXIS and be.mesh.home == be.device
        assert [b.device for b in bank.blocks] == list(be.mesh.devices)
        assert len({b.untyped_storage().data_ptr() for b in bank.blocks}) == SHARDS
        per = be.bank_capacity // SHARDS
        assert [tuple(b.shape) for b in bank.blocks] == [(per, M)] * SHARDS
        assert be._sharded_bank.block(0) == (0, per)
        _same_banks(tc, jc)


def test_growth_across_a_block_boundary_equals_jax(tmp_path):
    """Past 256 sketches the allocator doubles the bank: the blocks follow
    the new capacity (S'/D rows each), so rows change entries."""
    with _planes(tmp_path) as (tc, jc):
        cap0 = _be(tc).bank_capacity
        names = _names(tc, "g:", cap0 // SHARDS + 8)  # every shard overflows
        for c in (tc, jc):
            release, fut = _hold(_mc(c)._executor)
            futs = [_mc(c).get_hyper_log_log(n).add_ints_async(_keys(i, 50))
                    for i, n in enumerate(names)]
            release.set()
            fut.result(60)
            assert all(f.result(60) for f in futs)
        be = _be(tc)
        assert be.bank_capacity == _be(jc).bank_capacity == 2 * cap0
        assert {b.shape[0] for b in be.bank.blocks} == {2 * cap0 // SHARDS}
        _same_banks(tc, jc)
        probe = names[:: len(names) // 7]
        _close([tc.get_hyper_log_log(n).count() for n in probe],
               [jc.get_hyper_log_log(n).count() for n in probe])


def test_jax_state_installs_in_blocks(tmp_path):
    """`from_jax_state` on the mesh plane places the JAX mesh plane's bank
    in blocks (a bank whose rows do not divide by the mesh size is padded
    with zero rows), and every sketch reads back as JAX's."""
    with _planes(tmp_path) as (tc, jc):
        names = _names(tc, "j:", 3)
        for i, n in enumerate(names):
            jc.get_hyper_log_log(n).add_ints(_keys(i, 500))
        jbank, jrows = _state(jc)
        be = _be(tc)
        for rows in (jbank.shape[0], jbank.shape[0] - 2):
            _mc(tc)._executor.execute_barrier(
                lambda rows=rows: be.from_jax_state(jbank[:rows], jrows)).result(60)
            bank = be.bank
            assert isinstance(bank, Sharded) and len(bank.blocks) == SHARDS
            assert len(bank) == be.bank_capacity == jbank.shape[0]
            assert [b.device for b in bank.blocks] == list(be.mesh.devices)
            got, got_rows = _state(tc)
            assert got_rows == jrows
            assert np.array_equal(got[:rows], jbank[:rows]) and not got[rows:].any()
            want = _exports(_mc(jc), names)
            for n, regs in _exports(_mc(tc), names).items():
                assert np.array_equal(regs, want[n]), n


# -- tape windows and chunked merges ---------------------------------------------


def _window(mc, names, bloom, seed):
    """One held window on a client (a mesh plane's shared one): a PFADD
    per name, a Bloom add and a SETBIT -> (replies, registers and cells
    after it)."""
    rng = np.random.default_rng(seed)
    release, fut = _hold(mc._executor)
    futs = [mc.get_hyper_log_log(n).add_ints_async(_keys(seed + i))
            for i, n in enumerate(names)]
    futs.append(mc.get_bloom_filter(bloom).add_ints_async(
        rng.integers(0, 2**63, 3000, dtype=np.uint64)))
    futs.append(mc.get_bit_set("w:bs").set_bits_async(rng.integers(0, 40_000, 2000)))
    release.set()
    fut.result(60)
    replies = [f.result(60) for f in futs]
    mc._executor.execute_sync(bloom, "bloom_sync", None)
    cells = {n: np.asarray(mc._executor.execute_sync(n, "bits_export", None)[1])
             for n in (bloom, "w:bs")}
    return replies, _exports(mc, names), cells


def _same_window(got, want):
    (rg, eg, cg), (rw, ew, cw) = got, want
    assert len(rg) == len(rw)
    for g, w in zip(rg, rw):
        if isinstance(w, np.ndarray):
            assert np.array_equal(np.asarray(g), w)
        else:
            assert g == w
    for n, w in ew.items():
        assert np.array_equal(eg[n], w), n
    for n, w in cw.items():
        assert np.array_equal(cg[n], w), n


COUNTERS = ("multi_shard_windows", "tape_runs", "window_launches",
            "merge_launches", "delta_runs")


def test_tape_window_across_every_block_equals_jax(tmp_path):
    with _planes(tmp_path) as (tc, jc):
        names = _names(tc, "w:", 2)
        for c in (tc, jc):
            _mc(c).get_bloom_filter("w:bf").try_init(5000, 0.01)
        got = _window(_mc(tc), names, "w:bf", 1)
        want = _window(_mc(jc), names, "w:bf", 1)
        be = _be(tc)
        rows = be._rows
        assert {be.bank.locate(rows[n])[0] for n in names} == set(range(SHARDS))
        _same_window(got, want)
        for k in COUNTERS:
            assert be.counters[k] == _be(jc).counters[k], k
        assert be.counters["multi_shard_windows"] == 1
        assert be.counters["tape_runs"] == 1 and be.counters["window_launches"] == 1
        _same_banks(tc, jc)


def test_window_over_the_cell_budget_takes_chunked_merges(tmp_path):
    """A Bloom filter of just over 2^25 cells pads to 2^26 lanes, so with
    the window's other entries the stack passes DELTA_STACK_CELLS (2^26):
    the window retires through `_delta_merge_chunk`, its HLL rows gathered
    from the four blocks and written back to them. The JAX mesh plane
    cannot run this window (its chunked merge gathers from the sharded
    bank with a row vector on one device and raises: incompatible devices),
    so the reference is a JAX single engine under `tape` on the same
    sequence: replies, registers, cells and the window counters."""
    n = 3_600_000  # m = 34,505,696 > 2^25 at p = 0.01
    tc = _port(tmp_path / "over")
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "tape"
    jc = RedissonTPU.create(jcfg)
    try:
        names = _names(tc, "o:", 1)
        for c in (_mc(tc), jc):
            c.get_bloom_filter("o:bf").try_init(n, 0.01)
        be = _be(tc)
        m = be.store.get("o:bf").meta["size"]
        assert m > 1 << 25 and 8 * be._pad_cells(m) > be.DELTA_STACK_CELLS
        got = _window(_mc(tc), names, "o:bf", 2)
        want = _window(jc, names, "o:bf", 2)
        _same_window(got, want)
        for k in ("tape_runs", "delta_runs", "merge_launches", "window_launches"):
            assert be.counters[k] == jc._routing.sketch.counters[k], k
        assert be.counters["tape_runs"] == 0 and be.counters["delta_runs"] == 1
        rows = be._rows
        assert {be.bank.locate(rows[n])[0] for n in names} == set(range(SHARDS))
    finally:
        jc.shutdown()
        tc.shutdown()


# -- device inserts, collectives, rows ------------------------------------------


def _device_ops(c, names):
    """The plane under its other pinned ingest, `device` (what the manager
    picks without the host fold library): held multi-target PFADDs into
    every block, a single-target one, the collectives, export / import,
    DEL, FLUSHALL and a re-create -> (replies, state after each stage)."""
    mc = _mc(c)
    _be(c).ingest = "device"
    out, states = [], []
    release, fut = _hold(mc._executor)
    futs = [mc.get_hyper_log_log(n).add_ints_async(_keys(i)) for i, n in enumerate(names)]
    futs.append(mc.get_hyper_log_log(names[0]).add_all_async(
        [b"byte:%d" % i for i in range(500)]))
    release.set()
    fut.result(60)
    out.append([f.result(60) for f in futs])
    out.append(mc.get_hyper_log_log(names[-1]).add_ints(_keys(99, 5000)))
    states.append(_state(c))
    # sources in shards 0-2, the target in shard 3
    src, tgt = [names[0], names[2], names[4]], names[6]
    counts = [mc.get_hyper_log_log(tgt).count_with(*src)]
    counts.append(mc.get_hyper_log_log(names[7]).merge_with_and_count(*src))
    mc.get_hyper_log_log(tgt).merge_with(*src)
    counts.append(mc.get_hyper_log_log(tgt).count())
    regs, version = mc._executor.execute_sync(names[7], "hll_export", None)
    out.append(version)
    mc._executor.execute_sync("i:copy", "hll_import", {"regs": np.asarray(regs)})
    counts.append(mc.get_hyper_log_log("i:copy").count())
    out.append(mc.delete(names[2]))
    counts.append(mc.get_hyper_log_log(names[2]).count())
    states.append(_state(c))
    mc.flushall()
    out.append(mc.get_hyper_log_log(names[5]).add_ints(_keys(5)))
    states.append(_state(c))
    return out, counts, states, _be(c).counters["collective_merges"]


def test_device_inserts_and_collectives_across_blocks_equal_jax(tmp_path):
    with _planes(tmp_path) as (tc, jc):
        names = _names(tc, "d:", 2)
        got, want = _device_ops(tc, names), _device_ops(jc, names)
        assert got[0] == want[0]
        _close(got[1], want[1])
        for (bank, rows), (jbank, jrows) in zip(got[2], want[2]):
            assert rows == jrows
            assert np.array_equal(bank, jbank)
        assert got[3] == want[3] == 3
        assert isinstance(_be(tc).bank, Sharded)
        _same_banks(tc, jc)


def test_migrate_shard_0_into_shard_3_keeps_every_register(tmp_path):
    with _planes(tmp_path) as (tc, jc):
        names = _names(tc, "m:", 3)
        table = tc.cluster.router.slot_table()
        slots = [s for s in range(16384) if table[s] == 0]
        stats = []
        for c in (tc, jc):
            for i, n in enumerate(names):
                c.get_hyper_log_log(n).add_ints(_keys(i, 300))
            before = _exports(_mc(c), names)
            stats.append(c.cluster.migrate_slots(slots, 3, timeout_s=120))
            after = _exports(_mc(c), names)
            for n in names:
                assert np.array_equal(after[n], before[n]), n
        assert stats[0]["bank_rows_relocated"] == stats[1]["bank_rows_relocated"] == 3
        be = _be(tc)
        lo, hi = be._sharded_bank.block(3)
        moved = [be._rows[n] for n in names[:3]]
        assert all(lo <= r < hi for r in moved)
        assert {be.bank.locate(r)[0] for r in moved} == {3}
        _same_banks(tc, jc)


# -- durability and accounting ---------------------------------------------------


def test_snapshot_and_recovery_of_the_blocked_bank(tmp_path):
    names = [f"s:{i}" for i in range(24)]
    c = _port(tmp_path / "snap")
    try:
        mc = _mc(c)
        for i, n in enumerate(names):
            c.get_hyper_log_log(n).add_ints(_keys(i, 400))
        want_bank, want_rows = mc.to_numpy_state()
        cut = mc._executor.execute_barrier(_be(c).snapshot_cut).result(60)
        assert isinstance(cut["bank"], Sharded)
        assert np.array_equal(checkpoint.host_copy(cut["bank"]), want_bank)
        snap = mc.snapshot_now()
    finally:
        c.shutdown()
    # The JAX package's loader reads the snapshot: every bank row, in its
    # format (uint8 registers per name).
    got = {}

    def collect(name, otype, host, meta):
        got[name] = (otype, host)
        return True

    jcheckpoint.load(None, snap, put=collect)
    assert set(got) == set(names)
    for n in names:
        otype, host = got[n]
        assert otype == "hll" and host.dtype == np.uint8
        assert np.array_equal(host, want_bank[want_rows[n]])
    # Recovery: the port, and the JAX mesh plane on a copy of the same
    # directory, restore every register under the same row map (recovery
    # imports the names in snapshot order, so rows may move).
    shutil.copytree(tmp_path / "snap", tmp_path / "snap-jax")
    c = _port(tmp_path / "snap")
    try:
        jc = _jax(tmp_path / "snap-jax")
        try:
            bank, rows = _mc(c).to_numpy_state()
            assert isinstance(_be(c).bank, Sharded)
            jbank, jrows = _state(jc)
            assert rows == jrows and set(rows) == set(names)
            assert np.array_equal(bank, jbank)
            for n in names:
                assert np.array_equal(bank[rows[n]], want_bank[want_rows[n]]), n
        finally:
            jc.shutdown()
    finally:
        c.shutdown()


def test_memstat_ledger_equals_the_blocks(tmp_path):
    with _planes(tmp_path) as (tc, jc):
        names = _names(tc, "l:", 4)
        for c in (tc, jc):
            for i, n in enumerate(names):
                c.get_hyper_log_log(n).add_ints(_keys(i, 100))
            c.delete(names[0])
        mc = _mc(tc)
        blocks = _be(tc).bank
        total = sum(int(b.nbytes) for b in blocks.blocks)
        assert mc.memstat.bank_bytes() == total == int(_be(jc).bank.nbytes)
        assert mc.memstat.bank_bytes() == _mc(jc).memstat.bank_bytes()
        assert mc.memory_stats()["bank.bytes"] == total
        v = mc.memory_verify()
        assert v["ok"] and v["drift_bytes"] == 0, v


# -- the host fold and geo planes on the blocked bank -----------------------------


def _hostfold_and_geo(mc, be, names):
    """PFADDs through the host fold (absorbed block by block on a blocked
    bank), then a remote site's planes: merged through the chunked delta
    merge, merged by the classic fallback, and a full-state replace ->
    (replies, registers after the fold, registers at the end, counters)."""
    be.ingest = "hostfold"
    release, fut = _hold(mc._executor)
    futs = [mc.get_hyper_log_log(n).add_ints_async(_keys(i)) for i, n in enumerate(names)]
    release.set()
    fut.result(60)
    replies = [f.result(60) for f in futs]
    folded = _exports(mc, names)
    rng = np.random.default_rng(7)
    plane = lambda: rng.integers(0, 30, delta_mod.HLL_M).astype(np.uint8)  # noqa: E731
    be.ingest = "tape"
    for n in names[::2]:
        mc._executor.execute_sync(n, "geo_merge", {
            "inner": "hll_add", "cells": delta_mod.HLL_M, "plane": plane(),
            "stamp": (1, "R")})
    be.ingest = "device"
    for n in names[1::2]:
        mc._executor.execute_sync(n, "geo_merge", {
            "inner": "hll_add", "cells": delta_mod.HLL_M, "plane": plane(),
            "stamp": (2, "R")})
    mc._executor.execute_sync(names[-1], "geo_replace", {
        "inner": "hll_add", "cells": delta_mod.HLL_M, "plane": plane(),
        "stamp": (3, "R")})
    return (replies, folded, _exports(mc, names),
            (be.counters["geo_planes"], be.counters["geo_classic"]))


def test_hostfold_and_geo_planes_take_the_blocked_bank(tmp_path):
    """The mesh plane pins `tape` or `device` and carries no geo section,
    so neither path is reached through its config: switched to them, both
    take the blocked bank. The JAX mesh plane cannot merge a geo plane (its
    chunked merge raises on the sharded bank, as in the over-budget test):
    the reference is a JAX single engine on the same sequence, name by
    name."""
    tc = _port(tmp_path / "hg")
    jc = RedissonTPU.create(JConfig())
    try:
        names = _names(tc, "h:", 2)
        got = _hostfold_and_geo(_mc(tc), _be(tc), names)
        want = _hostfold_and_geo(jc, jc._routing.sketch, names)
        be = _be(tc)
        assert isinstance(be.bank, Sharded)
        assert {be.bank.locate(be._rows[n])[0] for n in names} == set(range(SHARDS))
    finally:
        jc.shutdown()
        tc.shutdown()
    assert got[0] == want[0]
    for g, w in zip(got[1:3], want[1:3]):
        for n in names:
            assert np.array_equal(g[n], w[n]), n
    assert got[3] == want[3] == (4, 4)
