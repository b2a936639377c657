"""cluster/ and parallel/topology.py of the port on the CPU: the counterpart
of every test of tests/test_cluster.py, then the port held against the JAX
package.

Counterparts (every facade on `Config().use_cuda(device="cpu")` with
`use_cluster(...)`; each shard is a full engine stack on the CPU):

1. CLUSTER KEYSLOT vectors and hashtag rules (the port's ops/crc16);
2. the splitter and the initial assignment;
3. a 4-shard facade: routing per slot, MGET / MSET / MSETNX fan-out, the
   CROSSSLOT check, KEYS / DEL fan-out, execute_many split per owner,
   RBatch through the router, cross-shard PFMERGE against a one-shard
   oracle, the guard's MOVED rejection and the redirect retry across a
   flip, the stats surface, topology quarantine;
4. persisted shards: a live migration under concurrent writes, add_shard,
   and the slot table recovered after a restart.

Against the JAX package:

5. the splitter, the assignment and the slot ranges equal JAX's on seeded
   tables; `slots_record_filter` keeps and rewrites the same records of a
   seeded journal stream (the port's int64 `add_device` records pass
   whole); TopologyManager fires the same event sequence for a seeded
   pinger schedule;
6. one seeded op stream (HLL add_ints and byte keys, Bloom adds, SETBIT,
   map and bucket ops, MSET across shards, cross-shard PFMERGE, then a
   migration under a writer) through a JAX cluster facade (local mode on
   the CPU) and a port facade, 4 shards each: equal slot tables, CLUSTER
   SLOTS and INFO, equal CROSSSLOT errors; every shard's registers, Bloom
   cells and bitmaps bit for bit and its structures digest equal; PFCOUNT
   within rel 1e-5 (the float32 sum order of the Ertl estimator);
7. the port's own rules: with no compute section every shard asks for the
   card (`cuda:<shard % cards>`) and raises without one; `device="cpu"`
   keeps every shard on the CPU (the mesh data plane is
   tests/test_torch_mesh.py's); a snapshot re-seeds
   the slot table into the new journal segment; get_topology_manager on a
   plain client.
"""

import hashlib
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.cluster import split as jsplit
from redisson_tpu.config import Config as JConfig
from redisson_tpu.parallel.topology import TopologyManager as JTopologyManager
from redisson_tpu.persist.follower import slots_record_filter as jslots_filter
from redisson_tpu.persist.journal import JournalRecord as JRecord
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.cluster import (
    ClusterCrossSlotError,
    SlotMovedError,
    contiguous_assignment,
    slot_ranges,
    split_by_owner,
)
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ops.crc16 import MAX_SLOT, crc16, key_slot
from redisson_tpu_torch.parallel.topology import TopologyManager
from redisson_tpu_torch.persist.follower import slots_record_filter
from redisson_tpu_torch.persist.journal import JournalRecord
from redisson_tpu.structures.engine import filter_state_dump as jfilter_dump
from redisson_tpu_torch.structures.engine import filter_state_dump
from tests.test_torch_persist import _canon

#: tests of tests/test_cluster.py with no counterpart here, and why (none)
EXCLUDED = {}


def cpu_cluster(num_shards=4, dir="", **cluster_kw):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_cluster(num_shards=num_shards, dir=dir, **cluster_kw)
    return RedissonTorch.create(cfg)


def _key_on_shard(client, sid, prefix="k", start=0):
    table = client.cluster.router.slot_table()
    i = start
    while True:
        k = f"{prefix}{i}"
        if table[key_slot(k)] == sid:
            return k
        i += 1


# ---------------------------------------------------------------------------
# 1. CLUSTER KEYSLOT vectors (redis-cli golden) + hashtag semantics
# ---------------------------------------------------------------------------


def test_crc16_known_vector():
    # The check value of redis's crc16.c: CRC-CCITT (XModem) of the
    # standard test string.
    assert crc16(b"123456789") == 0x31C3


@pytest.mark.parametrize("key,slot", [
    ("foo", 12182),
    ("hello", 866),
    ("somekey", 11058),
    ("foo{hash_tag}", 2515),
    ("bar{hash_tag}", 2515),
])
def test_cluster_keyslot_vectors(key, slot):
    assert key_slot(key) == slot


def test_hashtag_routes_to_tag_slot():
    assert key_slot("{user1000}.following") == key_slot("user1000")
    assert key_slot("{user1000}.followers") == key_slot("user1000")


def test_empty_hashtag_falls_back_to_whole_key():
    assert key_slot("foo{}{bar}") == crc16(b"foo{}{bar}") % MAX_SLOT
    assert key_slot("foo{}{bar}") != key_slot("bar")


def test_first_brace_pair_wins():
    assert key_slot("foo{bar}{zap}") == key_slot("bar")
    assert key_slot("foo{{bar}}zap") == crc16(b"{bar") % MAX_SLOT


def test_unclosed_brace_hashes_whole_key():
    assert key_slot("foo{bar") == crc16(b"foo{bar") % MAX_SLOT


# ---------------------------------------------------------------------------
# 2. splitter + assignment helpers
# ---------------------------------------------------------------------------


def test_split_by_owner_preserves_order():
    items = ["a", "b", "c", "d", "e"]
    groups = split_by_owner(items, lambda i, it: i % 2)
    assert groups == {0: [0, 2, 4], 1: [1, 3]}


def test_contiguous_assignment_covers_all_slots():
    table = contiguous_assignment(MAX_SLOT, 4)
    assert len(table) == MAX_SLOT
    assert set(table) == {0, 1, 2, 3}
    ranges = slot_ranges(table)
    assert ranges[0][0] == 0 and ranges[-1][1] == MAX_SLOT - 1
    for (s0, e0, _), (s1, _, _) in zip(ranges, ranges[1:]):
        assert s1 == e0 + 1


# ---------------------------------------------------------------------------
# 3. 4-shard cluster (no persist) — routing, fan-out, redirects
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster4():
    c = cpu_cluster(4)
    yield c
    c.shutdown()


def test_cluster_mode_facade(cluster4):
    c = cluster4
    assert c.cluster_keyslot("foo") == 12182
    ranges = c.cluster_slots()
    assert ranges[0][0] == 0 and ranges[-1][1] == MAX_SLOT - 1
    assert {r[2] for r in ranges} == {0, 1, 2, 3}
    info = c.cluster_info()
    assert info["cluster_enabled"] == 1
    assert info["cluster_state"] == "ok"
    assert info["cluster_slots_assigned"] == MAX_SLOT
    assert info["cluster_known_nodes"] == 4
    assert "cluster" in c.info()
    assert c.info()["server"]["mode"] == "cluster"


def test_keyed_ops_route_per_slot(cluster4):
    c = cluster4
    for sid in range(4):
        k = _key_on_shard(c, sid, prefix=f"route{sid}:")
        c.get_bucket(k).set(f"v{sid}")
        assert c.get_bucket(k).get() == f"v{sid}"
    assert all(s.guard.rejected_ops == 0 for s in c.cluster.shards.values())


def test_atomic_long_and_map_route(cluster4):
    c = cluster4
    al = c.get_atomic_long("cl:counter")
    al.set(10)
    assert al.add_and_get(5) == 15
    m = c.get_map("cl:map")
    m.put("f", "x")
    assert m.get("f") == "x"


def test_cross_shard_buckets_mget_mset(cluster4):
    c = cluster4
    keys = [_key_on_shard(c, sid, prefix=f"mg{sid}:") for sid in range(4)]
    c.get_buckets().set({k: f"mv{i}" for i, k in enumerate(keys)})
    got = c.get_buckets().get(*keys)
    assert got == {k: f"mv{i}" for i, k in enumerate(keys)}


def test_msetnx_cross_shard_rejected(cluster4):
    c = cluster4
    k0 = _key_on_shard(c, 0, prefix="nx0:")
    k1 = _key_on_shard(c, 1, prefix="nx1:")
    with pytest.raises(ClusterCrossSlotError):
        c.get_buckets().try_set({k0: "a", k1: "b"})
    k0b = _key_on_shard(c, 0, prefix="nx0b:")
    assert c.get_buckets().try_set({k0: "a", k0b: "b"}) is True


def test_cokey_crossslot_check(cluster4):
    c = cluster4
    src = _key_on_shard(c, 0, prefix="rn:")
    dst = _key_on_shard(c, 1, prefix="rnd:")
    c.get_bucket(src).set("x")
    fut = c.cluster.router.execute_async(src, "rename", {"newkey": dst})
    with pytest.raises(ClusterCrossSlotError):
        fut.result(10)
    c.get_bucket("{rnt}a").set("y")
    c.cluster.router.execute_sync("{rnt}a", "rename", {"newkey": "{rnt}b"})
    assert c.get_bucket("{rnt}b").get() == "y"


def test_keys_and_delete_fan_out(cluster4):
    c = cluster4
    keys = [_key_on_shard(c, sid, prefix=f"fan{sid}:") for sid in range(4)]
    for k in keys:
        c.get_bucket(k).set("1")
    found = c.cluster.router.execute_sync("", "keys", {"pattern": "fan*"})
    assert sorted(found) == sorted(keys)
    for k in keys:
        c.get_bucket(k).set(None)  # DEL
    assert c.cluster.router.execute_sync("", "keys", {"pattern": "fan*"}) == []


def test_execute_many_splits_per_owner(cluster4):
    c = cluster4
    keys = [_key_on_shard(c, i % 4, prefix=f"em{i}:") for i in range(12)]
    staged = [(k, "set", {"value": b"b%d" % i}, 0)
              for i, k in enumerate(keys)]
    futs = c.cluster.router.execute_many(staged)
    for f in futs:
        f.result(30)
    for i, k in enumerate(keys):
        assert c.cluster.router.execute_sync(k, "get", None) == b"b%d" % i


def test_batch_collector_via_router(cluster4):
    c = cluster4
    b = c.create_batch()
    k0 = _key_on_shard(c, 0, prefix="bat0:")
    k3 = _key_on_shard(c, 3, prefix="bat3:")
    b.get_bucket(k0).set_async("p")
    b.get_bucket(k3).set_async("q")
    b.execute()
    assert c.get_bucket(k0).get() == "p"
    assert c.get_bucket(k3).get() == "q"


def test_cross_shard_pfmerge_matches_single_shard_oracle(cluster4):
    c = cluster4
    names = [_key_on_shard(c, sid, prefix=f"pf{sid}:") for sid in range(3)]
    vals = [[b"a%d" % i for i in range(300)],
            [b"b%d" % i for i in range(300)],
            [b"a%d" % i for i in range(150)]]
    for n, vs in zip(names, vals):
        c.get_hyper_log_log(n).add_all(vs)
    merged = c.get_hyper_log_log(names[0]).merge_with_and_count(*names[1:])
    oracle = c.get_hyper_log_log("{pforacle}")
    for vs in vals:
        oracle.add_all(vs)
    assert merged == oracle.count()
    assert c.cluster.router.cross_shard_merges > 0
    before = c.get_hyper_log_log(names[1]).count()
    c.get_hyper_log_log(names[1]).count_with(names[2])
    assert c.get_hyper_log_log(names[1]).count() == before


def test_guard_rejects_foreign_slot_with_moved(cluster4):
    c = cluster4
    k = _key_on_shard(c, 1, prefix="rej:")
    shard0 = c.cluster.shards[0]
    fut = shard0.dispatch.execute_async(k, "set", {"value": b"x"})
    with pytest.raises(SlotMovedError):
        fut.result(10)
    assert shard0.guard.rejected_ops > 0


def test_moved_retry_lands_on_new_owner(cluster4):
    """Hold shard 0's dispatcher, enqueue a flip and then keyed writes (they
    pass the router while the table still says shard 0), open the ASK
    window, release: the writes are rejected after the flip, the redirect
    worker parks on the window and lands them on the new owner after the
    table commit. Zero lost acks."""
    c = cluster4
    router = c.cluster.router
    src, tgt = c.cluster.shards[0], c.cluster.shards[1]
    keys = [_key_on_shard(c, 0, prefix=f"mvd{i}:") for i in range(8)]
    slots = sorted({key_slot(k) for k in keys})

    entered, release = threading.Event(), threading.Event()

    def hold():
        entered.set()
        release.wait(30)

    redirects0 = router.redirects
    bfut = src.executor.execute_barrier(hold)
    assert entered.wait(10)
    fflip = src.executor.execute_async("", "migrate_flip", {"slots": slots})
    wfuts = [router.execute_async(k, "set", {"value": b"mv%d" % i})
             for i, k in enumerate(keys)]
    tgt.adopt(slots)
    router.begin_cutover(slots)
    release.set()
    bfut.result(30)
    fflip.result(30)
    # the writes are rejected on the source (its guard flipped) and parked
    # on the ASK window: wait for the redirects, not a time
    deadline = time.monotonic() + 30
    while router.redirects < redirects0 + len(keys):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    router.commit_cutover(slots, tgt.shard_id)
    for f in wfuts:
        f.result(30)
    assert router.redirects > redirects0
    for i, k in enumerate(keys):
        assert router.execute_sync(k, "get", None) == b"mv%d" % i
        assert router.slot_table()[key_slot(k)] == tgt.shard_id


def test_shard_stats_surface(cluster4):
    stats = cluster4.cluster.stats()
    assert set(stats["shards"]) == {0, 1, 2, 3}
    for s in stats["shards"].values():
        assert s["owned_slots"] > 0
        assert not s["quarantined"]
        assert s["live_bytes"] >= 0


def test_topology_quarantine_round_trip():
    c = cpu_cluster(2, auto_heal=False)  # no journal: a drain is refused
    try:
        mgr = c.cluster
        down = {"ok": True}
        mgr.set_pinger(1, lambda: down["ok"])
        down["ok"] = False
        for _ in range(mgr.topology.failed_attempts):
            mgr.topology.scan_once()
        assert mgr.shards[1].quarantined
        assert c.cluster_info()["cluster_state"] == "degraded"
        down["ok"] = True
        mgr.topology.scan_once()
        assert not mgr.shards[1].quarantined
        assert c.cluster_info()["cluster_state"] == "ok"
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 4. live migration (persisted shards) + recovery
# ---------------------------------------------------------------------------


def test_live_migration_under_concurrent_writes(tmp_path):
    c = cpu_cluster(3, dir=str(tmp_path / "cl"))
    try:
        mgr = c.cluster
        table = mgr.router.slot_table()
        keys = []
        i = 0
        while len(keys) < 60:
            k = f"lm{i}"
            if table[key_slot(k)] == 0:
                keys.append(k)
            i += 1
        for k in keys:
            c.get_bucket(k).set("v0")
        move_slots = sorted({key_slot(k) for k in keys})
        hll_key = keys[0]
        h = c.get_hyper_log_log("{%s}hll" % hll_key)
        h.add_all([b"h%d" % j for j in range(500)])
        est0 = h.count()

        errs, acked = [], {}
        stop = threading.Event()
        started = threading.Barrier(2)

        def writer():
            started.wait(30)
            n = 0
            while not stop.is_set():
                k = keys[n % len(keys)]
                v = f"w{n}"
                try:
                    c.get_bucket(k).set(v)
                    acked[k] = v
                except Exception as e:  # noqa: BLE001 — a lost ack fails below
                    errs.append((k, repr(e)))
                n += 1

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        started.wait(30)
        stats = mgr.migrate_slots(move_slots, 2, timeout_s=60)
        stop.set()
        t.join(10)

        assert errs == []  # zero lost acks
        assert stats["apply_errors"] == 0
        for k, v in acked.items():
            assert c.get_bucket(k).get() == v
        post = mgr.router.slot_table()
        assert all(post[s] == 2 for s in move_slots)
        assert c.get_hyper_log_log("{%s}hll" % hll_key).count() == est0
        assert mgr.migrations == 1
    finally:
        c.shutdown()


def test_add_shard_and_migrate_into_it(tmp_path):
    c = cpu_cluster(2, dir=str(tmp_path / "cl"))
    try:
        mgr = c.cluster
        k = _key_on_shard(c, 0, prefix="grow:")
        c.get_bucket(k).set("here")
        new_id = mgr.add_shard()
        assert new_id == 2
        assert mgr.shards[new_id].owned_count() == 0
        mgr.migrate_slots([key_slot(k)], new_id, timeout_s=60)
        assert mgr.router.slot_table()[key_slot(k)] == new_id
        assert c.get_bucket(k).get() == "here"
        assert c.cluster_info()["cluster_known_nodes"] == 3
    finally:
        c.shutdown()


def test_slot_table_recovers_after_restart(tmp_path):
    c = cpu_cluster(2, dir=str(tmp_path / "cl"))
    k = _key_on_shard(c, 0, prefix="rec:")
    slot = key_slot(k)
    try:
        c.get_bucket(k).set("durable")
        c.cluster.migrate_slots([slot], 1, timeout_s=60)
        assert c.cluster.router.slot_table()[slot] == 1
        table_before = c.cluster.router.slot_table()
    finally:
        c.shutdown()

    c2 = cpu_cluster(2, dir=str(tmp_path / "cl"))
    try:
        assert c2.cluster.router.slot_table() == table_before
        assert c2.cluster.router.slot_table()[slot] == 1
        assert c2.get_bucket(k).get() == "durable"
    finally:
        c2.shutdown()


# ---------------------------------------------------------------------------
# 5. helpers against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    assert contiguous_assignment(MAX_SLOT, n) == jsplit.contiguous_assignment(
        MAX_SLOT, n)
    table = contiguous_assignment(MAX_SLOT, n)
    for s in rng.integers(0, MAX_SLOT, 200):
        table[int(s)] = int(rng.integers(0, n))
    assert slot_ranges(table) == jsplit.slot_ranges(table)
    keys = [f"k{seed}:{i}" for i in range(300)]
    owner = lambda _i, k: table[key_slot(k)]  # noqa: E731
    assert split_by_owner(keys, owner) == jsplit.split_by_owner(keys, owner)


def _records(rng, layout):
    """A seeded journal stream: keyed writes (HLL add_ints in JAX's packed
    uint32 layout or the port's int64 `device_packed` layout, sets), MSETs
    across slots, a flushall and cluster bookkeeping."""
    out = []
    for seq in range(1, 121):
        r = int(rng.integers(0, 5))
        name = f"rk{int(rng.integers(0, 40))}"
        if r == 0:
            keys = rng.integers(0, 2**63, 16, dtype=np.int64)
            payload = ({"keys": keys.view(np.uint32).reshape(-1, 2)}
                       if layout == "jax" else
                       {"device_packed": torch.from_numpy(keys)})
            out.append((seq, name, "hll_add", payload))
        elif r == 1:
            out.append((seq, name, "set", {"value": b"v%d" % seq}))
        elif r == 2:
            pairs = {f"mk{int(x)}": b"%d" % seq for x in rng.integers(0, 60, 5)}
            out.append((seq, "", "mset", {"pairs": pairs}))
        elif r == 3:
            out.append((seq, "", "flushall", None))
        else:
            out.append((seq, "", "migrate_adopt", {"slots": [1, 2]}))
    return out


@pytest.mark.parametrize("layout", ["jax", "port"])
def test_slots_record_filter_equals_jax(layout):
    rng = np.random.default_rng(7)
    stream = _records(rng, layout)
    slots = sorted({key_slot(f"rk{i}") for i in range(0, 40, 3)}
                   | {key_slot(f"mk{i}") for i in range(0, 60, 4)})
    mine, theirs = slots_record_filter(slots), jslots_filter(slots)
    kept = 0
    for seq, target, kind, payload in stream:
        got = mine(JournalRecord(seq, target, kind, payload))
        want = theirs(JRecord(seq, target, kind, payload))
        assert (got is None) == (want is None), (seq, kind, target)
        if got is None:
            continue
        kept += 1
        assert (got.seq, got.target, got.kind) == (want.seq, want.target, want.kind)
        if kind == "mset":
            assert got.payload == want.payload
        else:
            assert got.payload is payload  # keyed payloads pass untouched
    assert kept > 10


def _topology_events(tm_cls, schedule):
    events, changes = [], []
    tm = tm_cls(scan_interval_s=60.0, failed_attempts=2)
    state = {}
    for node in ("a", "b", "c"):
        tm.add_node(node, lambda n=node: state[n])
    tm.add_listener(lambda ev, ident: events.append((ev, ident)))
    tm.on_change(lambda live: changes.append(sorted(live)))
    for row in schedule:
        state.update(row)
        events.append(("changed", tm.scan_once()))
    return events, changes, tm.scans, sorted(tm.live_nodes())


def test_topology_events_equal_jax():
    rng = np.random.default_rng(3)
    schedule = [{n: bool(rng.random() < 0.6) for n in ("a", "b", "c")}
                for _ in range(40)]
    assert _topology_events(TopologyManager, schedule) == _topology_events(
        JTopologyManager, schedule)


# ---------------------------------------------------------------------------
# 6. one op stream through a JAX and a port cluster facade
# ---------------------------------------------------------------------------


def _jax_cluster(num_shards, dir=""):
    cfg = JConfig()
    cfg.use_cluster(num_shards=num_shards, dir=dir)
    return RedissonTPU.create(cfg)


def _stream(c, seed):
    rng = np.random.default_rng(seed)
    bf = c.get_bloom_filter("bf")
    bf.try_init(5000, 0.01)
    for i in range(6):
        for j in range(8):
            c.get_hyper_log_log(f"h{j}").add_ints(
                rng.integers(0, 2**64, 400, dtype=np.uint64, endpoint=False))
        c.get_hyper_log_log(f"hb{i % 3}").add_all(
            [f"u:{i}:{k}" for k in range(40)])
        bf.add_ints(rng.integers(0, 2**64, 300, dtype=np.uint64, endpoint=False))
        bits = c.get_bit_set(f"bits{i % 2}")
        bits.set_bits(rng.integers(0, 5000, 50))
        bits.set(int(rng.integers(0, 5000)), False)
        c.get_map(f"m{i % 4}").put(f"f{i}", i * 7)
        c.get_bucket(f"b{i}").set(i)
    c.get_buckets().set({f"ms{k}": k for k in range(12)})
    c.get_hyper_log_log("h0").merge_with("h1", "h2", "h3")


def _crossslot(c):
    out = []
    for call in (lambda: c.get_buckets().try_set({"ms0": 1, "ms1": 2, "ms2": 3}),
                 lambda: c._dispatch.execute_sync("b0", "rename", {"newkey": "b1"}),
                 lambda: c._dispatch.execute_sync("{t}x", "rename",
                                                  {"newkey": "{t}y"})):
        try:
            out.append(("ok", call()))
        except Exception as exc:  # noqa: BLE001 — both facades must fail alike
            out.append((type(exc).__name__, str(exc)))
    return out


def _shard_state(shard):
    """The shard's sketches whose slots it owns (a migrated slot's old copy
    stays behind on the source, refused by its guard) and every key it
    holds."""
    ex = shard.executor
    keys = sorted(ex.execute_sync("", "keys", {"pattern": "*"}))
    owned = shard.guard.owned_slots()
    mine = [k for k in keys if key_slot(k) in owned]
    out = {"keys": keys}
    for name in mine:
        try:
            exported = ex.execute_sync(name, "hll_export", None)
        except TypeError:  # WRONGTYPE: a BitSet or a Bloom
            exported = None
        if exported is not None:
            out[name] = np.asarray(exported[0], np.uint8).tobytes()
            continue
        exported = ex.execute_sync(name, "bits_export", None)
        if exported is not None:
            out[name] = (str(exported[0]),
                         np.asarray(exported[1], np.uint8).tobytes())
    return out


def _owned_structures(shard, filter_dump):
    """Digest of the shard's structure keys in the slots it owns (the old
    copy of a migrated key stays behind on the source, at whatever value
    it held when the flip cut the writer's stream)."""
    owned = shard.guard.owned_slots()
    blob = shard.executor.execute_barrier(
        shard.client._routing.structures.dump_state).result()
    kept, _ = filter_dump(blob, lambda name: key_slot(name) in owned)
    h = hashlib.sha256()
    _canon(pickle.loads(kept), h)
    return h.hexdigest()


def _migrate_under_writer(c, seed):
    """Move every slot of shard 0 that holds a stream key to shard 1 while
    a writer thread PFADDs into and SETs those keys; the writer's sequence
    is fixed, so the final state does not depend on the interleaving."""
    table = c.cluster.router.slot_table()
    hot = [n for n in [f"h{j}" for j in range(8)] + [f"b{i}" for i in range(6)]
           + [f"hb{i}" for i in range(3)] if table[key_slot(n)] == 0]
    assert hot
    slots = sorted({key_slot(n) for n in hot})
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, 2**64, 200, dtype=np.uint64, endpoint=False)
               for _ in range(30)]
    started = threading.Barrier(2)
    errs = []

    def writer():
        started.wait(30)
        for i, b in enumerate(batches):
            n = hot[i % len(hot)]
            try:
                if n.startswith("b"):
                    c.get_bucket(n).set(1000 + i)
                else:
                    c.get_hyper_log_log(n).add_ints(b)
            except Exception as exc:  # noqa: BLE001 — a lost ack fails below
                errs.append(repr(exc))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    started.wait(30)
    stats = c.cluster.migrate_slots(slots, 1, timeout_s=60)
    t.join(60)
    assert not t.is_alive() and errs == []
    assert stats["apply_errors"] == 0
    return slots


def test_cluster_stream_equals_jax(tmp_path):
    jc = _jax_cluster(4, str(tmp_path / "jax"))
    tc = cpu_cluster(4, dir=str(tmp_path / "port"))
    try:
        for c in (jc, tc):
            _stream(c, 11)
        assert tc.cluster.router.slot_table() == jc.cluster.router.slot_table()
        assert tc.cluster_slots() == jc.cluster_slots()
        assert _crossslot(tc) == _crossslot(jc)
        assert tc.cluster.router.cross_shard_merges == \
            jc.cluster.router.cross_shard_merges == 1
        moved = [_migrate_under_writer(c, 12) for c in (jc, tc)]
        assert moved[0] == moved[1]
        assert tc.cluster.router.slot_table() == jc.cluster.router.slot_table()
        assert tc.cluster_slots() == jc.cluster_slots()
        jinfo, tinfo = jc.cluster_info(), tc.cluster_info()
        for k in ("redirects",):  # a redirect depends on the interleaving
            jinfo.pop(k), tinfo.pop(k)
        assert tinfo == jinfo
        for sid in range(4):
            js, ts = jc.cluster.shards[sid], tc.cluster.shards[sid]
            assert _shard_state(ts) == _shard_state(js), sid
            assert _owned_structures(ts, filter_state_dump) == \
                _owned_structures(js, jfilter_dump), sid
            assert ts.guard.owned_slots() == js.guard.owned_slots()
        names = [f"h{j}" for j in range(8)] + [f"hb{i}" for i in range(3)]
        for n in names:
            got = tc.get_hyper_log_log(n).count()
            exp = jc.get_hyper_log_log(n).count()
            assert abs(got - exp) <= 1e-5 * exp, n
        got = tc.get_hyper_log_log("h4").count_with("h5", "hb1")
        exp = jc.get_hyper_log_log("h4").count_with("h5", "hb1")
        assert abs(got - exp) <= 1e-5 * exp
        for b in ("bits0", "bits1"):
            assert tc.get_bit_set(b).cardinality() == jc.get_bit_set(b).cardinality()
        assert tc.get_buckets().get(*[f"b{i}" for i in range(6)]) == \
            jc.get_buckets().get(*[f"b{i}" for i in range(6)])
    finally:
        tc.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# 7. the port's own rules
# ---------------------------------------------------------------------------


def test_shards_ask_for_the_card_by_default(monkeypatch):
    from redisson_tpu_torch.cluster.manager import ClusterManager

    cfg = Config()
    cfg.use_cluster(num_shards=4)
    mgr = ClusterManager.__new__(ClusterManager)
    mgr.config = cfg
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [mgr._shard_config(i).cuda.device for i in range(4)] == ["cuda:0"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [mgr._shard_config(i).cuda.device for i in range(4)] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert all(mgr._shard_config(i).cluster.shard_id == i for i in range(4))
    cfg.use_cuda(device="cpu", ingest="segment")
    sc = mgr._shard_config(3)
    assert sc.cuda.device == "cpu" and sc.cuda.ingest == "segment"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    no_compute = Config()
    no_compute.use_cluster(num_shards=2)
    with pytest.raises(RuntimeError):
        RedissonTorch.create(no_compute)  # the card, never the CPU


def test_cpu_cluster_runs_every_shard_on_the_cpu(cluster4):
    for shard in cluster4.cluster.shards.values():
        assert shard.client.device == torch.device("cpu")
        assert shard.client.sketch.bank.device.type == "cpu"


def test_snapshot_reseeds_the_slot_table(tmp_path):
    """A shard's ownership lives only in journal records: after a migration
    and a snapshot that drops the older segments, a restart still finds the
    same table (the snapshot re-seeds it into the new segment)."""
    c = cpu_cluster(2, dir=str(tmp_path / "cl"))
    k = _key_on_shard(c, 0, prefix="snap:")
    try:
        c.get_bucket(k).set("kept")
        c.cluster.migrate_slots([key_slot(k)], 1, timeout_s=60)
        table = c.cluster.router.slot_table()
        for shard in c.cluster.shards.values():
            shard.persist.snapshot()
    finally:
        c.shutdown()
    c2 = cpu_cluster(2, dir=str(tmp_path / "cl"))
    try:
        assert c2.cluster.router.slot_table() == table
        assert c2.get_bucket(k).get() == "kept"
    finally:
        c2.shutdown()


def test_topology_manager_of_a_plain_client():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        tm = c.get_topology_manager(scan_interval_s=60.0, failed_attempts=1)
        assert tm.live_nodes() == ["cpu"]
        assert tm.scan_once() is False and tm.is_up("cpu")
    finally:
        c.shutdown()
