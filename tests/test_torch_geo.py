"""geo/ of the port on the CPU: the counterpart of every test of
tests/test_geo.py, then the port held against the JAX package.

Counterparts (all sites on `Config().use_cuda(device="cpu")`):

1. Wiring — geo requires persist, the config round-trips, the kind sets
   agree with OP_TABLE, a site id collision is refused.
2. Convergence — two sites converge bit-identical through the stacked
   delta_merge path (geo_planes > 0, geo_classic == 0), with fewer link
   bytes than raw journal bytes; INFO replication and staleness, over the
   wire too.
3. Destructive LWW — DEL wins when newer and loses (add-wins resurrection)
   when older; rename, bitset_clear and FLUSHALL settle alike everywhere.
4. Repair — partition and heal, site kill and rejoin, journal-gap
   snapshot repair.
5. The seeded chaos test, with histcheck's geo verdict.

Against the JAX package:

6. GeoConfig's fields and defaults, the kind sets and register_geo's gauge
   names equal JAX's;
7. `SiteLink._build_msgs` over one seeded record list gives JAX's
   messages, array for array; one seeded message sequence leaves the
   port's GeoApplier in JAX's state;
8. one seeded two-site op stream through a JAX pair and a port pair:
   registers, Bloom cells and bitmaps equal bit for bit, PFCOUNT within
   rel 1e-5, and the appliers' state equal;
9. a site directory the JAX package wrote (journal and geo_state.json)
   reopens in the port with JAX's applier state.

The port's own rules: a geo site with the default config asks for the
card; a replica strips the geo section (JAX keeps it and fails); a local
write and a remote plane of one target in one run both land.
"""

import os
import shutil
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from redisson_tpu import geo as jgeo
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.config import GeoConfig as JGeoConfig
from redisson_tpu.geo.applier import GeoApplier as JGeoApplier
from redisson_tpu.geo.link import SiteLink as JSiteLink
from redisson_tpu.observability import MetricsRegistry as JMetricsRegistry
from redisson_tpu.observability import register_geo as jregister_geo
from redisson_tpu.persist.journal import JournalRecord as JRecord
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.commands import OP_TABLE
from redisson_tpu_torch.config import Config, GeoConfig
from redisson_tpu_torch.fault import inject
from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan, FaultRule
from redisson_tpu_torch.geo import (DESTRUCTIVE_KINDS, NEG_STAMP,
                                    SEMILATTICE_KINDS, SHIP_KINDS,
                                    connect_sites, converge, stamp_of)
from redisson_tpu_torch.geo.applier import GeoApplier
from redisson_tpu_torch.geo.link import SiteLink
from redisson_tpu_torch.ingest import delta as delta_mod
from redisson_tpu_torch.observability import MetricsRegistry, register_geo
from redisson_tpu_torch.persist.journal import JournalRecord
from tools.histcheck import check_geo

#: tests of tests/test_geo.py with no counterpart here, and why (none)
EXCLUDED = {}


def make_site(root, sid):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_persist(os.path.join(str(root), sid), fsync="always")
    cfg.use_geo(sid, poll_interval_s=0.005, anti_entropy_interval_s=0.05)
    return RedissonTorch.create(cfg)


def make_jsite(root, sid):
    cfg = JConfig()
    cfg.use_local()
    cfg.use_persist(os.path.join(str(root), sid)).fsync = "always"
    g = cfg.use_geo(sid)
    g.poll_interval_s = 0.005
    g.anti_entropy_interval_s = 0.05
    return RedissonTPU.create(cfg)


def _shutdown(clients):
    for c in clients:
        try:
            c.shutdown()
        except Exception:
            pass


@pytest.fixture
def pair(tmp_path):
    a, b = make_site(tmp_path, "A"), make_site(tmp_path, "B")
    connect_sites([a, b])
    sites = [a, b]
    yield sites
    inject.uninstall()
    _shutdown(sites)


def _partition(*targets, times=10_000):
    """Drop every geo_link tick toward the named peer site ids."""
    inject.install(FaultInjector(FaultPlan(rules=[
        FaultRule(seam="geo_link", target=t, nth=1, times=times)
        for t in targets])))


def _digest(client, keys):
    """Per-key state digest (type tag and raw cells) through the export the
    links ship."""
    out = {}
    for k in keys:
        ex = client.geo._export(k)
        if ex is None:
            out[k] = None
        else:
            otype, cells, _meta = ex
            out[k] = (str(otype), np.asarray(cells, np.uint8).tobytes())
    return out


# ---------------------------------------------------------------------------
# 1. wiring
# ---------------------------------------------------------------------------

def test_geo_requires_persist():
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_geo("lonely")
    with pytest.raises(ValueError, match="persist"):
        RedissonTorch.create(cfg)


def test_geo_config_roundtrip():
    cfg = Config.from_dict({
        "geo": {"site_id": "eu-west", "poll_interval_s": 0.5,
                "batch_records": 128, "anti_entropy_interval_s": 2.0},
    })
    assert isinstance(cfg.geo, GeoConfig)
    assert cfg.geo.site_id == "eu-west"
    assert cfg.geo.poll_interval_s == 0.5
    assert cfg.geo.batch_records == 128
    assert cfg.geo.anti_entropy_interval_s == 2.0
    assert Config.from_json(cfg.to_json()).geo == cfg.geo


def test_ship_kind_sets_against_op_table():
    for kind in SHIP_KINDS:
        assert OP_TABLE[kind].write, kind
    assert SEMILATTICE_KINDS == {"hll_add", "bloom_add", "bitset_set"}
    assert "bitset_clear" in DESTRUCTIVE_KINDS  # SETBIT 0 is not a join
    for kind in ("geo_merge", "geo_replace", "geo_delete", "geo_flush"):
        assert OP_TABLE[kind].write, kind
        assert kind not in SHIP_KINDS  # the echo-loop cut
    assert stamp_of([3, "A"]) == (3, "A") > NEG_STAMP


def test_site_id_collision_rejected(tmp_path):
    a = make_site(tmp_path, "A")
    b = make_site(os.path.join(tmp_path, "other"), "A")
    try:
        with pytest.raises(ValueError, match="collides"):
            a.geo.connect(b.geo)
    finally:
        _shutdown([a, b])


# ---------------------------------------------------------------------------
# 2. convergence through the stacked delta_merge path
# ---------------------------------------------------------------------------

def test_two_sites_converge_bit_identical(pair):
    a, b = pair
    a.get_hyper_log_log("h").add_all([f"a{i}" for i in range(800)])
    b.get_hyper_log_log("h").add_all([f"b{i}" for i in range(800)])
    a.get_bit_set("bits").set_bits(range(0, 400, 3))
    b.get_bit_set("bits").set_bits(range(1, 400, 3))
    fa = a.get_bloom_filter("blm")
    fa.try_init(10_000, 0.01)
    fa.add_all([f"x{i}" for i in range(200)])
    fb = b.get_bloom_filter("blm")
    fb.try_init(10_000, 0.01)
    fb.add_all([f"y{i}" for i in range(200)])

    assert converge(pair, 30), "two-site mesh never settled"
    assert a.get_hyper_log_log("h").count() == b.get_hyper_log_log("h").count()
    want = len(set(range(0, 400, 3)) | set(range(1, 400, 3)))
    assert a.get_bit_set("bits").cardinality() == want
    assert b.get_bit_set("bits").cardinality() == want
    assert all(fb.contains(f"x{i}") for i in range(200))
    assert all(fa.contains(f"y{i}") for i in range(200))

    keys = ["h", "bits", "blm"]
    assert _digest(a, keys) == _digest(b, keys)
    for c in pair:
        assert c.sketch.counters["geo_planes"] > 0
        assert c.sketch.counters["geo_classic"] == 0
    for c in pair:
        for link in c.geo.links.values():
            assert 0 < link.stats["link_bytes"] < link.stats["raw_bytes"]


def test_info_replication_and_staleness(pair):
    a, b = pair
    a.get_bit_set("k").set_bits([1, 2, 3])
    assert converge(pair, 30)
    rep = a.info()["replication"]
    assert rep["role"] == "active"
    assert rep["site_id"] == "A"
    assert rep["version_vector"]["A"] == a.geo.journal_last_seq()
    peer = rep["peers"]["B"]
    assert peer["acked_seq"] == a.geo.journal_last_seq()
    assert peer["lag_records"] == 0
    for field in ("lag_seconds", "link_bytes", "raw_bytes",
                  "partitions", "repairs"):
        assert field in peer
    st = a.geo.staleness()
    assert set(st) == {"B"} and st["B"] >= 0.0
    assert b.info()["replication"]["peers"]["A"]["acked_seq"] == \
        b.geo.journal_last_seq()


def test_wire_info_replication_section(tmp_path):
    """INFO replication over the port's RESP server renders the geo
    section of client.info()."""
    from redisson_tpu.interop.resp_client import SyncRespClient

    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_persist(os.path.join(str(tmp_path), "A"), fsync="always")
    cfg.use_geo("A", poll_interval_s=0.005)
    cfg.use_serve()
    cfg.use_wire()
    a = make_site(tmp_path, "B")
    c = RedissonTorch.create(cfg)
    try:
        connect_sites([a, c])
        c.get_bit_set("wk").set_bits([1, 2])
        assert converge([a, c], 30)
        cli = SyncRespClient("127.0.0.1", c.wire.port, retry_attempts=1)
        try:
            text = cli.execute("INFO", "replication")
            if isinstance(text, bytes):
                text = text.decode()
        finally:
            cli.close()
        assert "# replication" in text
        assert "role:active" in text
        assert "site_id:A" in text
        assert "version_vector" in text
        assert "peers_B_acked_seq" in text or "acked_seq" in text
    finally:
        _shutdown([c, a])


# ---------------------------------------------------------------------------
# 3. destructive LWW contract
# ---------------------------------------------------------------------------

def test_delete_wins_when_newer(pair):
    a, b = pair
    a.get_hyper_log_log("h").add_all(["x1", "x2", "x3"])
    assert converge(pair, 30)
    a.get_keys().delete("h")
    assert converge(pair, 30)
    assert a.get_hyper_log_log("h").count() == 0
    assert b.get_hyper_log_log("h").count() == 0
    assert _digest(a, ["h"]) == _digest(b, ["h"]) == {"h": None}


def test_delete_loses_to_newer_write_resurrects(pair):
    a, b = pair
    pump = b.get_bit_set("pump")
    for i in range(20):
        pump.set_bits([i])  # B's stamps outrun A's
    a.get_hyper_log_log("h").add_all(["x1", "x2"])
    assert converge(pair, 30)

    _partition("A", "B")
    b.get_hyper_log_log("h").add_all(["y1", "y2", "y3"])  # high stamp
    a.get_keys().delete("h")                              # low stamp: loses
    time.sleep(0.05)
    inject.uninstall()
    assert converge(pair, 30)

    ca, cb = a.get_hyper_log_log("h").count(), b.get_hyper_log_log("h").count()
    assert ca == cb == 5, (ca, cb)
    assert (a.geo.applier.resurrections + b.geo.applier.resurrections) >= 1
    assert (a.geo.applier.suppressed + b.geo.applier.suppressed) >= 1


def test_rename_replicates_as_delete_plus_replace(pair):
    a, b = pair
    src = a.get_bit_set("src")
    src.set_bits([1, 5, 9])
    assert converge(pair, 30)
    src.rename("dst")
    assert converge(pair, 30)
    assert b.get_bit_set("dst").cardinality() == 3
    assert b.get_bit_set("src").cardinality() == 0
    assert _digest(a, ["src", "dst"]) == _digest(b, ["src", "dst"])


def test_bitset_clear_is_lww_replace(pair):
    a, b = pair
    ba = a.get_bit_set("c")
    ba.set_bits(range(10))
    assert converge(pair, 30)
    ba.clear_bits([3, 4])
    assert converge(pair, 30)
    assert b.get_bit_set("c").cardinality() == 8
    assert _digest(a, ["c"]) == _digest(b, ["c"])


def test_flushall_replicates(pair):
    a, b = pair
    a.get_hyper_log_log("h").add_all(["x1", "x2"])
    b.get_bit_set("bits").set_bits(range(16))
    assert converge(pair, 30)
    a.get_keys().flushall()
    assert converge(pair, 30)
    assert b.get_hyper_log_log("h").count() == 0
    assert b.get_bit_set("bits").cardinality() == 0
    assert a.get_bit_set("bits").cardinality() == 0


def test_flushall_loses_to_newer_write_resurrects(pair):
    a, b = pair
    pump = b.get_bit_set("pump")
    for i in range(25):
        pump.set_bits([i])
    a.get_hyper_log_log("old").add_all(["o1", "o2"])
    assert converge(pair, 30)

    _partition("A", "B")
    b.get_hyper_log_log("survivor").add_all(["s1", "s2", "s3"])  # high stamp
    a.get_keys().flushall()                                      # low stamp
    time.sleep(0.05)
    inject.uninstall()
    assert converge(pair, 30)

    assert a.get_hyper_log_log("survivor").count() == 3
    assert b.get_hyper_log_log("survivor").count() == 3
    assert a.get_hyper_log_log("old").count() == 0
    assert b.get_hyper_log_log("old").count() == 0
    keys = ["survivor", "old", "pump"]
    assert _digest(a, keys) == _digest(b, keys)


# ---------------------------------------------------------------------------
# 4. repair paths
# ---------------------------------------------------------------------------

def test_partition_heal_converges(pair):
    a, b = pair
    _partition("B", times=200)
    a.get_hyper_log_log("h").add_all([f"p{i}" for i in range(400)])
    b.get_hyper_log_log("h").add_all([f"q{i}" for i in range(400)])
    time.sleep(0.1)
    inject.uninstall()
    assert converge(pair, 30), "no convergence after heal"
    assert a.get_hyper_log_log("h").count() == b.get_hyper_log_log("h").count()
    assert a.geo.links["B"].stats["partitions"] > 0


def test_site_kill_and_rejoin(pair, tmp_path):
    a, b = pair
    ha = a.get_hyper_log_log("h")
    ha.add_all([f"r{i}" for i in range(300)])
    assert converge(pair, 30)
    b.shutdown()
    ha.add_all([f"s{i}" for i in range(300)])  # writes while B is down
    b2 = make_site(tmp_path, "B")  # same dir: journal + sidecar recovery
    pair[1] = b2
    connect_sites([a, b2])
    assert converge([a, b2], 30), "no convergence after rejoin"
    assert a.get_hyper_log_log("h").count() == b2.get_hyper_log_log("h").count()
    assert _digest(a, ["h"]) == _digest(b2, ["h"])


def test_journal_gap_snapshot_repair(pair):
    a, b = pair
    ha = a.get_hyper_log_log("h")
    ha.add_all(["seed1", "seed2"])
    assert converge(pair, 30)

    _partition("B")
    ha.add_all([f"z{i}" for i in range(200)])
    a.snapshot_now()
    j = a._executor.journal
    j.rotate()
    j.remove_segments_below(j.last_seq)
    inject.uninstall()
    assert converge(pair, 30), "no convergence after gap repair"
    assert a.geo.links["B"].stats["gaps"] >= 1, "snapshot path not exercised"
    assert ha.count() == b.get_hyper_log_log("h").count()
    assert _digest(a, ["h"]) == _digest(b, ["h"])


# ---------------------------------------------------------------------------
# 5. seeded chaos property test
# ---------------------------------------------------------------------------

def test_two_site_chaos_convergence(pair, tmp_path):
    a, b = pair
    rng = np.random.default_rng(0xC0FFEE)
    keys = ["chaos:h", "chaos:bits"]
    writes = {"A": [], "B": []}
    reads = {"A": [], "B": []}
    site_seeds = {sid: rng.integers(lo, lo + 1_000_000, size=120)
                  for sid, lo in (("A", 0), ("B", 1 << 20))}

    def writer(client, sid):
        hll = client.get_hyper_log_log("chaos:h")
        bits = client.get_bit_set("chaos:bits")
        for i, s in enumerate(site_seeds[sid]):
            vals = [f"{sid}:{s}:{j}" for j in range(5)]
            hll.add_all(vals)
            writes[sid].append(("hll", vals))
            idx = [int(s) % 2048 + j for j in range(4)]
            bits.set_bits(idx)
            writes[sid].append(("bits", idx))
            if i % 10 == 0:
                reads[sid].append(
                    (sid, "chaos:bits", bits.cardinality(), 0))

    t1 = threading.Thread(target=writer, args=(a, "A"))
    t2 = threading.Thread(target=writer, args=(b, "B"))
    t1.start()
    t2.start()
    time.sleep(0.05)
    _partition("B", times=40)
    t1.join(120)
    t2.join(120)
    assert not t1.is_alive() and not t2.is_alive()
    inject.uninstall()

    a.get_bit_set("chaos:del").set_bits([1, 2, 3])
    assert converge(pair, 30)
    a.get_keys().delete("chaos:del")

    b.shutdown()
    a.get_hyper_log_log("chaos:h").add_all(["post-kill-1", "post-kill-2"])
    writes["A"].append(("hll", ["post-kill-1", "post-kill-2"]))
    b2 = make_site(tmp_path, "B")
    pair[1] = b2
    connect_sites([a, b2])
    assert converge([a, b2], 60), "chaos mesh never settled"

    oracle = make_site(tmp_path, "oracle")
    try:
        oh = oracle.get_hyper_log_log("chaos:h")
        ob = oracle.get_bit_set("chaos:bits")
        for site in ("A", "B"):
            for kind, payload in writes[site]:
                if kind == "hll":
                    oh.add_all(payload)
                else:
                    ob.set_bits(payload)
        digests = {"A": _digest(a, keys), "B": _digest(b2, keys),
                   "oracle": _digest(oracle, keys)}
        for sid, client in (("A", a), ("B", b2)):
            digests[sid]["chaos:del"] = _digest(client, ["chaos:del"])[
                "chaos:del"]
            assert digests[sid]["chaos:del"] is None, sid
        digests["oracle"]["chaos:del"] = None
        verdict = check_geo(digests, acked_keys=keys, site_reads=reads)
        assert verdict.ok, verdict.summary() + "\n" + "\n".join(verdict.issues)
        assert verdict.keys_checked == 3
        assert verdict.reads_checked > 0
    finally:
        oracle.shutdown()

    for c in (a, b2):
        assert c.sketch.counters["geo_planes"] > 0
        assert c.sketch.counters["geo_classic"] == 0


# ---------------------------------------------------------------------------
# 6. constants against JAX
# ---------------------------------------------------------------------------

def test_config_kind_sets_and_gauges_equal_jax():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(GeoConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JGeoConfig)])
    assert Config().use_geo("s").site_id == JConfig().use_geo("s").site_id
    assert SHIP_KINDS == jgeo.SHIP_KINDS
    assert SEMILATTICE_KINDS == jgeo.SEMILATTICE_KINDS
    assert DESTRUCTIVE_KINDS == jgeo.DESTRUCTIVE_KINDS
    assert NEG_STAMP == jgeo.NEG_STAMP
    stub = SimpleNamespace(links={}, applier=SimpleNamespace(
        applied=0, suppressed=0, resurrections=0))
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    register_geo(reg, stub)
    jregister_geo(jreg, stub)
    assert sorted(reg.snapshot()["gauges"]) == sorted(
        jreg.snapshot()["gauges"])
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]


# ---------------------------------------------------------------------------
# 7. link and applier logic against JAX, on stub managers
# ---------------------------------------------------------------------------

def _same(a, b, where="msg"):
    """Deep equality with numpy arrays compared by dtype and element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _byte_keys(rng, n):
    lengths = rng.integers(1, 17, size=n).astype(np.int32)
    data = np.zeros((n, 16), np.uint8)
    for i, ln in enumerate(lengths):
        data[i, :ln] = rng.integers(0, 256, size=ln)
    return data, lengths


def _seeded_records(seed, record_cls, device_layout):
    """One fixed record list: every ship kind, the fold-group cuts, a
    device-resident batch (`device_layout` gives its keys in the package's
    own add_device layout) and kinds the link must skip."""
    rng = np.random.default_rng(seed)

    def ints(n):
        return rng.integers(0, 1 << 62, size=n, dtype=np.int64).astype(np.uint64)

    def packed(n):
        return ints(n).view(np.uint32).reshape(-1, 2)

    def bits(n, hi):
        idx = rng.integers(0, hi, size=n).astype(np.int64)
        return {"idx": idx, "max_idx": int(idx.max())}

    recs = []

    def add(kind, target, payload):
        recs.append(record_cls(len(recs) + 1, target, kind, payload))

    for _ in range(3):
        add("hll_add", "h1", {"packed": packed(500)})
    d, ln = _byte_keys(rng, 300)
    add("hll_add", "h1", {"data": d, "lengths": ln})
    add("hll_add", "h2", {"packed": packed(7)})  # sparse plane
    add("bloom_add", "bf", {"packed": packed(400)})
    d, ln = _byte_keys(rng, 200)
    add("bloom_add", "bf", {"data": d, "lengths": ln})
    add("bitset_set", "bs", bits(50, 5000))
    add("bitset_set", "bs", bits(3000, 100_000))
    add("bloom_init", "bf2", {"expected_insertions": 10, "false_probability": 0.1})
    add("hll_count", "h1", None)
    add("geo_merge", "h1", {"inner": "hll_add", "plane": np.zeros(16, np.uint8),
                            "stamp": [1, "X"]})
    add("delete", "h1", None)               # cuts h1's group
    add("hll_add", "h1", {"packed": packed(100)})
    add("bitset_set", "bs", bits(10, 64))
    add("bitset_clear", "bs", bits(2, 64))  # full-state replace
    add("rename", "bs", {"newkey": "bs2"})
    add("hll_add", "h3", {"device_packed": device_layout(ints(64))})
    add("bloom_add", "nobloom", {"packed": packed(10)})  # no meta: export
    add("hll_add", "h2", {"packed": packed(9)})
    add("flushall", "", None)
    add("bitset_set", "bs3", bits(20, 300))
    return recs


def _stub_export(key):
    """A deterministic full-state body per key (what export_state returns)."""
    if key in ("gone", "nobloom"):
        return None
    rng = np.random.default_rng(sum(map(ord, key)))
    plane = rng.integers(0, 2, size=64).astype(np.uint8)
    return {"inner": "bitset_set", "cells": 512, "plane_bytes": 64,
            "_link_bytes": 64, "meta": {"max_idx": 511, "extent_bits": 512},
            "plane": plane}


def _stub_link(link_cls):
    bloom = {"size": 9585, "hash_iterations": 7,
             "expected_insertions": 1000, "false_probability": 0.01,
             "blocked": False}
    manager = SimpleNamespace(
        site_id="A", seed=0, cfg=SimpleNamespace(poll_interval_s=1.0),
        journal_path="/nonexistent", monotonic=time.monotonic,
        export_state=_stub_export,
        bloom_meta=lambda t: dict(bloom) if t == "bf" else None)
    peer = SimpleNamespace(site_id="B", applier=SimpleNamespace(vv={}))
    return link_cls(manager, peer)


def test_build_msgs_equal_jax():
    port_recs = _seeded_records(7, JournalRecord, lambda u: u.view(np.int64))
    jax_recs = _seeded_records(
        7, JRecord, lambda u: u.view(np.uint32).reshape(-1, 2))
    link, jlink = _stub_link(SiteLink), _stub_link(JSiteLink)
    msgs = link._build_msgs(port_recs)
    jmsgs = jlink._build_msgs(jax_recs)
    kinds = [m["kind"] for m in msgs]
    assert "flush" in kinds and "replace" in kinds and "delete" in kinds
    assert any("idx" in m for m in msgs) and any("plane" in m for m in msgs)
    _same(msgs, jmsgs)
    assert link.stats == jlink.stats
    assert 0 < link.stats["link_bytes"] < link.stats["raw_bytes"]


class _StubSite:
    """The manager surface GeoApplier calls, recording every dispatch."""

    def __init__(self):
        self.site_id = "L"
        self.cfg = SimpleNamespace(apply_window=4)
        self.dispatched = []
        self.repairs = []

    def execute_async(self, target, kind, payload, nkeys=0):
        self.dispatched.append((target, kind, tuple(payload.get("stamp", ())),
                                sorted(payload.get("keys", ())), nkeys))
        fut = Future()
        fut.set_result(True)
        return fut

    def local_keys(self):
        return {f"k{i}" for i in range(6)}

    def broadcast_repair(self, key):
        self.repairs.append(key)
        return key != "k5"


def _applier_script(seed, record_cls):
    """A seeded interleaving of remote batches, local records and a
    restart's rebuild."""
    rng = np.random.default_rng(seed)
    steps = []
    seqs = {"P": 0, "Q": 0}
    local_seq = 0
    for _ in range(120):
        r = rng.random()
        if r < 0.25:
            local_seq += 1
            kind = str(rng.choice(["hll_add", "delete", "rename", "bitset_clear",
                                   "flushall", "geo_merge", "bloom_add"]))
            target = f"k{rng.integers(0, 6)}"
            payload = ({"newkey": f"k{rng.integers(0, 6)}"} if kind == "rename"
                       else {"stamp": [int(rng.integers(1, 50)), "P"]}
                       if kind == "geo_merge" else {})
            steps.append(("local", [record_cls(local_seq, target, kind, payload)]))
            continue
        origin = str(rng.choice(["P", "Q"]))
        msgs = []
        for _ in range(int(rng.integers(1, 5))):
            seqs[origin] += int(rng.integers(1, 4))
            kind = str(rng.choice(["merge", "merge", "delete", "replace", "flush"]))
            stamp = [seqs[origin], origin]
            if rng.random() < 0.15:  # an old or foreign stamp, or a repair
                stamp = [int(rng.integers(1, seqs[origin] + 1)),
                         str(rng.choice(["P", "Q", "L"]))]
            msg = {"kind": kind, "target": "" if kind == "flush"
                   else f"k{rng.integers(0, 6)}", "stamp": stamp,
                   "nkeys": int(rng.integers(0, 9)), "inner": "hll_add"}
            if rng.random() < 0.2:
                msg["repair"] = True
            msgs.append(msg)
        steps.append(("apply", (msgs, origin, seqs[origin])))
    rebuild = [record_cls(local_seq + 1, "k1", "geo_merge", {"stamp": [999, "Q"]}),
               record_cls(local_seq + 2, "k2", "geo_delete", {"stamp": (998, "P")}),
               record_cls(local_seq + 3, "k3", "geo_replace", {"stamp": [997, "Q"]}),
               record_cls(local_seq + 4, "", "geo_flush", {"stamp": [3, "P"]}),
               record_cls(local_seq + 5, "k4", "delete", {})]
    steps.append(("rebuild", rebuild))
    return steps


def _drive_applier(applier_cls, record_cls):
    site = _StubSite()
    ap = applier_cls(site)
    for what, arg in _applier_script(11, record_cls):
        if what == "local":
            ap.note_local(arg)
        elif what == "apply":
            ap.apply(*arg)
        else:
            ap.rebuild(arg)
    return ap, site


def test_applier_state_equals_jax():
    ap, site = _drive_applier(GeoApplier, JournalRecord)
    jap, jsite = _drive_applier(JGeoApplier, JRecord)
    for name in ("vv", "lw", "floor", "flush_floor", "suppressed",
                 "resurrections", "applied"):
        assert getattr(ap, name) == getattr(jap, name), name
    assert ap.suppressed > 0 and ap.resurrections > 0 and ap.floor
    assert site.dispatched == jsite.dispatched
    assert site.repairs == jsite.repairs
    assert ap.state() == jap.state()
    assert ap.pending() == jap.pending() == 0
    fresh = GeoApplier(_StubSite())
    fresh.load_state(jap.state())
    assert fresh.state() == jap.state()


# ---------------------------------------------------------------------------
# 8. one seeded two-site op stream: the JAX pair against the port pair
# ---------------------------------------------------------------------------

STREAM_BLOOM = (5_000, 0.01)


def _stream(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(24):
        site = int(rng.integers(0, 2))
        kind = str(rng.choice(["hll_ints", "hll_bytes", "bloom_ints",
                               "bloom_bytes", "setbit"]))
        if kind == "hll_ints":
            arg = rng.integers(0, 1 << 62, size=int(rng.integers(1, 3000)),
                               dtype=np.int64).astype(np.uint64)
            ops.append((site, kind, f"h{rng.integers(0, 3)}", arg))
        elif kind == "hll_bytes":
            ops.append((site, kind, f"h{rng.integers(0, 3)}",
                        [f"s{step}:{i}" for i in range(int(rng.integers(1, 300)))]))
        elif kind == "bloom_ints":
            arg = rng.integers(0, 1 << 62, size=int(rng.integers(1, 2000)),
                               dtype=np.int64).astype(np.uint64)
            ops.append((site, kind, "bf", arg))
        elif kind == "bloom_bytes":
            ops.append((site, kind, "bf",
                        [f"b{step}:{i}" for i in range(int(rng.integers(1, 200)))]))
        else:
            idx = rng.integers(0, 1 << int(rng.integers(6, 16)),
                               size=int(rng.integers(1, 500)))
            ops.append((site, kind, f"s{rng.integers(0, 2)}",
                        [int(i) for i in idx]))
        if step == 12:
            ops.append((1, "del", "h1", None))
        if step == 18:
            ops.append((0, "flushall", "", None))
    return ops


def _apply_op(c, kind, target, arg):
    if kind == "hll_ints":
        c.get_hyper_log_log(target).add_ints(arg)
    elif kind == "hll_bytes":
        c.get_hyper_log_log(target).add_all(arg)
    elif kind in ("bloom_ints", "bloom_bytes"):
        f = c.get_bloom_filter(target)
        f.try_init(*STREAM_BLOOM)
        (f.add_ints if kind == "bloom_ints" else f.add_all)(arg)
    elif kind == "setbit":
        c.get_bit_set(target).set_bits(arg)
    elif kind == "del":
        c.get_keys().delete(target)
    else:
        c.get_keys().flushall()


def _run_stream(sites, conv, ops):
    for site, kind, target, arg in ops:
        _apply_op(sites[site], kind, target, arg)
        assert conv(sites, 30)


STREAM_KEYS = ["h0", "h1", "h2", "bf", "s0", "s1"]


def test_two_site_stream_equals_jax(tmp_path):
    ops = _stream(2024)
    jsites = [make_jsite(tmp_path / "jax", s) for s in ("A", "B")]
    sites = [make_site(tmp_path / "port", s) for s in ("A", "B")]
    try:
        jgeo.connect_sites(jsites)
        connect_sites(sites)
        _run_stream(jsites, jgeo.converge, ops)
        _run_stream(sites, converge, ops)
        digests = [_digest(c, STREAM_KEYS) for c in sites]
        jdigests = [_digest(c, STREAM_KEYS) for c in jsites]
        # Where the JAX pair's sites disagree, the port's do too, and
        # nowhere else (the write after a higher-stamped FLUSHALL, a fault
        # both packages share: test_write_after_a_higher_stamped_flush_*).
        assert ({k for k in STREAM_KEYS if digests[0][k] != digests[1][k]}
                == {k for k in STREAM_KEYS if jdigests[0][k] != jdigests[1][k]})
        for i in range(2):
            assert digests[i] == jdigests[i], i
            assert sites[i].geo.applier.state() == jsites[i].geo.applier.state()
            for name in ("h0", "h1", "h2"):
                n = sites[i].get_hyper_log_log(name).count()
                jn = jsites[i].get_hyper_log_log(name).count()
                assert abs(n - jn) <= 1e-5 * max(jn, 1), (name, n, jn)
        assert any(v is not None for v in _digest(sites[0], STREAM_KEYS).values())
        for c in sites:
            assert c.sketch.counters["geo_planes"] > 0
            assert c.sketch.counters["geo_classic"] == 0
    finally:
        _shutdown(sites + jsites)


def _flush_then_lower_stamped_write(sites, conv, fault):
    a, b = sites
    # A's link toward B holds its cursor while A writes 20 records, which
    # then ship folded into one message: B's journal falls 19 records
    # behind A's.
    fault.install(fault.FaultInjector(fault.FaultPlan(rules=[
        fault.FaultRule(seam="geo_link", target="B", nth=1, times=10_000)])))
    try:
        for i in range(20):
            a.get_bit_set("pump").set_bits([i])
    finally:
        fault.uninstall()
    assert conv(sites, 30)
    a.get_keys().flushall()
    assert conv(sites, 30)
    b.get_hyper_log_log("h").add_all(["y1", "y2"])  # after the flush
    assert conv(sites, 30)
    return [_digest(c, ["h", "pump"]) for c in sites]


def test_write_after_a_higher_stamped_flush_diverges_in_both(tmp_path):
    """A fault both packages share, pinned, not copied away: stamps are
    (origin journal seq, site id), not causal clocks. A FLUSHALL at A
    stamped (sA, A) reaches B, then B writes with a stamp (sB, B) < (sA,
    A) although the write came after the flush: A suppresses the merge
    (at or below its flush floor), B keeps it, and the sites stay apart
    after converge."""
    from redisson_tpu.fault import inject as jinject

    jsites = [make_jsite(tmp_path / "jax", s) for s in ("A", "B")]
    sites = [make_site(tmp_path / "port", s) for s in ("A", "B")]
    try:
        jgeo.connect_sites(jsites)
        connect_sites(sites)
        want = _flush_then_lower_stamped_write(jsites, jgeo.converge, jinject)
        got = _flush_then_lower_stamped_write(sites, converge, inject)
        assert got == want
        assert got[0] == {"h": None, "pump": None}
        assert got[1]["h"] is not None and got[1]["pump"] is None
        assert sites[0].geo.applier.suppressed >= 1
    finally:
        _shutdown(sites + jsites)


# ---------------------------------------------------------------------------
# 9. a site directory written by the JAX package reopens in the port
# ---------------------------------------------------------------------------

def test_jax_site_directory_reopens_in_the_port(tmp_path):
    jsites = [make_jsite(tmp_path, s) for s in ("A", "B")]
    try:
        jgeo.connect_sites(jsites)
        ja, jb = jsites
        ja.get_hyper_log_log("h").add_all([f"a{i}" for i in range(500)])
        jb.get_hyper_log_log("h").add_all([f"b{i}" for i in range(500)])
        jb.get_bit_set("bits").set_bits(range(0, 300, 7))
        f = jb.get_bloom_filter("bf")
        f.try_init(*STREAM_BLOOM)
        f.add_all([f"x{i}" for i in range(100)])
        jb.get_bit_set("gone").set_bits([1])
        assert jgeo.converge(jsites, 30)
        jb.get_keys().delete("gone")
        assert jgeo.converge(jsites, 30)
        keys = ["h", "bits", "bf", "gone"]
        want_state = _digest(ja, keys)
    finally:
        _shutdown(jsites)
    want = JGeoApplier(SimpleNamespace(site_id="A"))
    import json

    with open(tmp_path / "A" / "geo_state.json") as fh:
        want.load_state(json.load(fh))
    # A copy without the sidecar rebuilds the LWW maps from the journal.
    shutil.copytree(tmp_path / "A", tmp_path / "A2")
    os.remove(tmp_path / "A2" / "geo_state.json")
    jre = make_jsite(tmp_path, "A2")
    try:
        rebuilt = jre.geo.applier.state()
    finally:
        jre.shutdown()
    shutil.rmtree(tmp_path / "A2")
    shutil.copytree(tmp_path / "A", tmp_path / "A2")
    os.remove(tmp_path / "A2" / "geo_state.json")

    a = make_site(tmp_path, "A")
    a2 = make_site(tmp_path, "A2")
    try:
        assert a.geo.applier.state() == want.state()
        assert a.geo.applier.floor.get("gone") == want.floor["gone"]
        assert _digest(a, keys) == want_state
        assert a2.geo.applier.state() == rebuilt
        assert _digest(a2, keys) == want_state
    finally:
        _shutdown([a, a2])


# ---------------------------------------------------------------------------
# 10. the port's own rules
# ---------------------------------------------------------------------------

def test_default_config_asks_for_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.use_persist(str(tmp_path / "A"))
    cfg.use_geo("A")
    with pytest.raises(RuntimeError, match="cuda"):
        RedissonTorch.create(cfg)


def test_replicas_of_a_site_carry_no_geo_section(tmp_path):
    """A deliberate difference: JAX's replica_engine_config keeps the geo
    section, so each replica of a JAX geo site refuses to start (a geo
    section without persist); the port's strips it."""
    def build(cfg, root):
        cfg.use_persist(str(root))
        cfg.persist.fsync = "always"
        cfg.use_geo("A")
        r = cfg.use_replicas(1)
        r.health_interval_s = 0.0
        return cfg

    jcfg = JConfig()
    jcfg.use_local()
    with pytest.raises(ValueError, match="persist"):
        RedissonTPU.create(build(jcfg, tmp_path / "jax"))
    cfg = Config()
    cfg.use_cuda(device="cpu")
    c = RedissonTorch.create(build(cfg, tmp_path / "port"))
    try:
        assert c.geo is not None and c.geo.site_id == "A"
        (rep,) = c.replicas.replicas
        assert rep.client.config.geo is None and rep.client.geo is None
        c.get_hyper_log_log("h").add_all(["x"])
        assert c.wait_for_replicas(1, timeout_s=10) == 1
        info = c.info()["replication"]
        assert info["role"] == "active" and info["connected_replicas"] == 1
    finally:
        c.shutdown()


def test_remote_plane_needs_no_fold_library(monkeypatch):
    from redisson_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    assert delta_mod.foldable("geo_merge", {"plane": np.zeros(4, np.uint8)})
    assert delta_mod.foldable("geo_merge", {"idx": np.zeros(1, np.int64)})
    assert not delta_mod.foldable("geo_merge", {"stamp": [1, "A"]})
    assert not delta_mod.foldable("hll_add", {"packed": np.zeros((1, 2), np.uint32)})


def _hold(c):
    release, entered = threading.Event(), threading.Event()

    def block():
        entered.set()
        release.wait(30)

    fut = c._executor.execute_barrier(block)
    assert entered.wait(30)
    return release, fut


@pytest.mark.parametrize("inner", ["hll_add", "bitset_set"])
def test_local_and_remote_planes_of_one_target_in_one_run(inner):
    """A run that steals a target's local write and a remote plane of the
    same target (different kinds of one steal group) merges both: the geo
    plane retires in a window of its own after the local one. In one
    stack the later row's writeback would drop the earlier row's bits."""
    c = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="delta"))
    try:
        rng = np.random.default_rng(5)
        if inner == "hll_add":
            remote = rng.integers(0, 20, size=delta_mod.HLL_M).astype(np.uint8)
            payload = {"inner": inner, "cells": delta_mod.HLL_M,
                       "plane": remote, "stamp": (1, "R")}
        else:
            cells = rng.integers(0, 2, size=4096).astype(np.uint8)
            payload = {"inner": inner, "cells": 4096, "plane": np.packbits(cells),
                       "meta": {"max_idx": 4095}, "stamp": (1, "R")}
        keys = rng.integers(0, 1 << 62, size=5000, dtype=np.int64).astype(np.uint64)
        release, barrier = _hold(c)
        futs = [c.get_hyper_log_log("x").add_ints_async(keys)]
        if inner == "hll_add":
            futs.append(c.get_hyper_log_log("t").add_ints_async(keys))
        else:
            futs.append(c.get_bit_set("t").set_bits_async(range(0, 8000, 3)))
        futs.append(c._executor.execute_async("t", "geo_merge", payload))
        before = c._executor.runs_dispatched()
        release.set()
        barrier.result(30)
        for f in futs:
            f.result(30)
        assert c._executor.runs_dispatched() - before == 1  # one stolen run
        assert c.sketch.counters["geo_planes"] == 1
        assert c.sketch.counters["geo_classic"] == 0
        if inner == "hll_add":
            ref = RedissonTorch.create(Config().use_cuda(device="cpu"))
            try:
                ref.get_hyper_log_log("t").add_ints(keys)
                local = ref.to_numpy_state()
                want = np.maximum(local[0][local[1]["t"]], remote)
            finally:
                ref.shutdown()
            bank, rows = c.to_numpy_state()
            assert np.array_equal(bank[rows["t"]], want)
        else:
            want = cells.copy()
            want[np.arange(0, 8000, 3)[np.arange(0, 8000, 3) < 4096]] = 1
            got = c._executor.execute_sync("t", "bits_export", None)[1]
            assert np.array_equal(got[:4096], want)
            assert got[4096:].sum() == len(range(4098, 8000, 3))
    finally:
        c.shutdown()
