"""The runtime witnesses of the port on the CPU: the op-contract witness
(`redisson_tpu_torch.contractwitness`) and the lock-order witness
(`redisson_tpu_torch.concurrency`).

1. The counterpart of tests/test_review_regressions.py's
   `test_contract_witness_tags_replay_and_facade_surfaces`, then the
   `replica`, `wire` and `geo` surfaces, each tagged by its seam (the
   follower's replay, the RESP server's window flush, the geo applier);
   the disarmed witness records nothing.
2. Unarmed, the lock factories return the plain `threading` primitives
   (no per-acquire cost); the executor re-exports them.
3. Armed (`REDISSON_TPU_LOCK_WITNESS=1`, in a subprocess), a geo pair's
   converge, a replica's follower replay and a wire window run with
   witnessed locks, and the witnessed order graph is acyclic.
4. The witness's own logic against JAX's: cycle search, snapshots merged
   across processes.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from redisson_tpu import concurrency as jconcurrency
from redisson_tpu_torch import concurrency, contractwitness as cw, executor
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_config():
    cfg = Config()
    cfg.use_cuda(device="cpu")
    return cfg


@pytest.fixture
def armed():
    cw.arm(force=True)
    cw.contract_witness_reset()
    try:
        yield cw
    finally:
        cw.uninstall()


# ---------------------------------------------------------------------------
# 1. contract witness surfaces
# ---------------------------------------------------------------------------

def test_contract_witness_tags_replay_and_facade_surfaces(tmp_path, armed):
    def make(jdir):
        cfg = cpu_config()
        cfg.use_persist(str(jdir), fsync="always")
        return RedissonTorch.create(cfg)

    c = make(tmp_path)
    try:
        c.get_hyper_log_log("cwpin").add_all([b"a", b"b"])
    finally:
        c.shutdown()
    facade = cw.contract_snapshot()["cells"].get("facade", {})
    assert facade.get("hll_add", 0) >= 1

    cw.contract_witness_reset()
    c2 = make(tmp_path)
    try:
        assert c2.get_hyper_log_log("cwpin").count() == 2
    finally:
        c2.shutdown()
    cells = cw.contract_snapshot()["cells"]
    assert cells.get("replay", {}).get("hll_add", 0) >= 1, cells


def test_replica_surface_tags_the_followers_replay(tmp_path, armed):
    cfg = cpu_config()
    cfg.use_persist(str(tmp_path / "p"), fsync="always")
    cfg.use_replicas(1, poll_interval_s=0.005, health_interval_s=0.0)
    c = RedissonTorch.create(cfg)
    try:
        c.get_bit_set("b").set_bits([1, 2, 3])
        assert c.wait_for_replicas(1, timeout_s=10) == 1
    finally:
        c.shutdown()
    cells = cw.contract_snapshot()["cells"]
    assert cells["replica"].get("bitset_set", 0) >= 1, cells
    assert cells["facade"].get("bitset_set", 0) >= 1, cells


def _pfadd_over_the_wire(c, key, *members):
    from redisson_tpu_torch.wire.proto import RespParser, resp_encode

    with socket.create_connection(("127.0.0.1", c.wire.port), timeout=5) as s:
        s.sendall(resp_encode(b"PFADD", key, *members))
        parser = RespParser()
        frames = []
        end = time.monotonic() + 10
        while not frames and time.monotonic() < end:
            frames = parser.feed(s.recv(65536))
    return frames


def test_wire_surface_tags_the_window_flush(armed):
    cfg = cpu_config()
    cfg.use_wire(port=0)
    c = RedissonTorch.create(cfg)
    try:
        assert _pfadd_over_the_wire(c, b"wk", b"a", b"b") == [1]
    finally:
        c.shutdown()
    cells = cw.contract_snapshot()["cells"]
    assert cells["wire"].get("hll_add", 0) == 1, cells
    assert "hll_add" not in cells.get("facade", {}), cells


def test_geo_surface_tags_remote_applies(tmp_path, armed):
    from redisson_tpu_torch.geo import connect_sites, converge

    sites = []
    for sid in ("A", "B"):
        cfg = cpu_config()
        cfg.use_persist(str(tmp_path / sid), fsync="always")
        cfg.use_geo(sid, poll_interval_s=0.005)
        sites.append(RedissonTorch.create(cfg))
    try:
        connect_sites(sites)
        sites[0].get_hyper_log_log("h").add_all(["x", "y"])
        sites[1].get_bit_set("b").set_bits([4])
        assert converge(sites, 30)
        sites[0].get_keys().delete("h")
        assert converge(sites, 30)
    finally:
        for c in sites:
            c.shutdown()
    cells = cw.contract_snapshot()["cells"]
    assert cells["geo"].get("geo_merge", 0) >= 2, cells
    assert cells["geo"].get("geo_delete", 0) == 1, cells
    assert "geo_merge" not in cells.get("facade", {}), cells


def test_disarmed_witness_records_nothing(tmp_path):
    cw.uninstall()
    assert cw.RECORD is None
    c = RedissonTorch.create(cpu_config())
    try:
        c.get_hyper_log_log("h").add_all(["x"])
    finally:
        c.shutdown()
    assert cw.contract_snapshot()["cells"] == {}


# ---------------------------------------------------------------------------
# 2. unarmed factories are the plain primitives
# ---------------------------------------------------------------------------

def test_unarmed_factories_return_plain_threading_primitives(monkeypatch):
    """Unarmed, a factory call is a module-flag test and the primitive: the
    environment is read once at import (a deliberate difference: JAX reads
    it at every call, an environment lookup on each run's lock), so setting
    the flag in a running process arms nothing."""
    assert not concurrency.witness_enabled()
    monkeypatch.setenv(concurrency.ENV_FLAG, "1")
    assert type(concurrency.make_lock("t.T._l")) is type(threading.Lock())
    assert type(concurrency.make_rlock("t.T._r")) is type(threading.RLock())
    lock = concurrency.make_lock("t.T._l")
    cond = concurrency.make_condition("t.T._l", lock)
    assert type(cond) is threading.Condition
    assert type(concurrency.make_condition("t.T._c")._lock) is type(threading.RLock())
    assert executor.make_lock is concurrency.make_lock
    assert executor.make_rlock is concurrency.make_rlock
    assert executor.make_condition is concurrency.make_condition
    c = RedissonTorch.create(cpu_config())
    try:
        assert type(c._executor._lock) is type(threading.Lock())
    finally:
        c.shutdown()


def test_armed_factories_witness_an_inversion(monkeypatch):
    monkeypatch.setattr(concurrency, "_ARMED", True)
    concurrency.witness_reset()
    a = concurrency.make_lock("t.T._a")
    b = concurrency.make_rlock("t.T._b")
    assert isinstance(a, concurrency.OrderedLock)
    with a:
        with b:
            with b:  # re-entrant: no self edge
                pass
    concurrency.assert_acyclic()
    done = threading.Event()

    def other():
        with b:
            with a:
                done.set()

    t = threading.Thread(target=other)
    t.start()
    t.join(10)
    assert done.is_set() and not t.is_alive()
    with pytest.raises(AssertionError, match="cycle"):
        concurrency.assert_acyclic()
    snap = concurrency.witness_snapshot()
    assert {(e["from"], e["to"]) for e in snap["edges"]} == {
        ("t.T._a", "t.T._b"), ("t.T._b", "t.T._a")}
    assert snap["sites"]["t.T._b"]["holds"] == 2
    concurrency.witness_reset()
    concurrency.assert_acyclic()


# ---------------------------------------------------------------------------
# 3. armed, across the threaded tiers, in a subprocess
# ---------------------------------------------------------------------------

_ARMED = textwrap.dedent("""
    import json, os, socket, sys, time
    from redisson_tpu_torch import concurrency
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.geo import connect_sites, converge
    from redisson_tpu_torch.wire.proto import RespParser, resp_encode

    assert concurrency.witness_enabled()
    root = sys.argv[1]

    def cfg_for(sub):
        cfg = Config()
        cfg.use_cuda(device="cpu")
        cfg.use_persist(os.path.join(root, sub), fsync="always")
        return cfg

    sites = []
    for sid in ("A", "B"):
        cfg = cfg_for(sid)
        cfg.use_geo(sid, poll_interval_s=0.005, anti_entropy_interval_s=0.02)
        if sid == "A":
            cfg.use_replicas(1, poll_interval_s=0.005, health_interval_s=0.0)
            cfg.use_serve()
            cfg.use_wire(port=0)
        sites.append(RedissonTorch.create(cfg))
    a, b = sites
    connect_sites(sites)
    a.get_hyper_log_log("h").add_all([f"a{i}" for i in range(300)])
    b.get_hyper_log_log("h").add_all([f"b{i}" for i in range(300)])
    f = b.get_bloom_filter("bf")
    f.try_init(1000, 0.01)
    f.add_all([f"x{i}" for i in range(50)])
    b.get_bit_set("s").set_bits(range(0, 90, 3))
    with socket.create_connection(("127.0.0.1", a.wire.port), timeout=5) as s:
        s.sendall(resp_encode(b"PFADD", b"w", b"1", b"2"))
        parser, frames = RespParser(), []
        while not frames:
            frames = parser.feed(s.recv(65536))
    assert frames == [1], frames
    assert converge(sites, 30)
    b.get_keys().delete("s")
    assert converge(sites, 30)
    assert a.wait_for_replicas(1, timeout_s=30) == 1
    assert a.get_hyper_log_log("h").count() == b.get_hyper_log_log("h").count()
    for c in sites:
        c.shutdown()
    concurrency.assert_acyclic()
    snap = concurrency.witness_snapshot()
    print("WITNESS", json.dumps({"sites": sorted(snap["sites"]),
                                 "edges": len(snap["edges"]),
                                 "threads": snap["threads"]}))
""")


def test_armed_geo_replica_and_wire_run_is_acyclic(tmp_path):
    out_path = tmp_path / "witness.json"
    env = dict(os.environ, PYTHONPATH=ROOT, REDISSON_TPU_LOCK_WITNESS="1",
               REDISSON_TPU_LOCK_WITNESS_OUT=str(out_path))
    out = subprocess.run([sys.executable, "-c", _ARMED, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("WITNESS")][-1]
    seen = json.loads(line.split(" ", 1)[1])
    # The sites of every tier the run crossed were witnessed (the port's
    # locks do not nest on these paths: the applier dispatches outside its
    # lock, so the graph may hold no edge at all).
    for site in ("executor.CommandExecutor._lock", "geo.GeoApplier._lock",
                 "geo.GeoManager._links_lock", "journal.Journal._io",
                 "follower.JournalFollower._applied_lock",
                 "router.ReplicaRouter._lock"):
        assert site in seen["sites"], (site, seen["sites"])
    for thread in ("redisson-torch-geo-A->B", "redisson-torch-geo-B->A",
                   "redisson-torch-follower", "redisson-torch-dispatcher"):
        assert thread in seen["threads"], (thread, seen["threads"])
    dumped = json.loads(out_path.read_text())  # the atexit dump
    assert dumped["enabled"] is True
    assert concurrency.find_cycle(
        [(e["from"], e["to"]) for e in dumped["edges"]]) is None


# ---------------------------------------------------------------------------
# 4. the witness's own logic against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edges", [
    [],
    [("a", "b"), ("b", "c")],
    [("a", "b"), ("b", "c"), ("c", "a")],
    [("x", "y"), ("a", "b"), ("b", "a"), ("y", "z")],
    [("a", "a")],
])
def test_find_cycle_equals_jax(edges):
    assert concurrency.find_cycle(edges) == jconcurrency.find_cycle(edges)


def test_merge_snapshots_equals_jax():
    snaps = [
        {"edges": [{"from": "a", "to": "b", "count": 2, "first_thread": "t1"}],
         "sites": {"a": {"holds": 3, "total_s": 0.5, "max_s": 0.2, "p99_s": 0.2}},
         "same_site_nesting": {"a": 1}, "threads": ["t1"]},
        {"edges": [{"from": "a", "to": "b", "count": 1, "first_thread": "t2"},
                   {"from": "b", "to": "c", "count": 4, "first_thread": "t2"}],
         "sites": {"a": {"holds": 1, "total_s": 0.1, "max_s": 0.3, "p99_s": 0.1},
                   "c": {"holds": 1, "total_s": 0.0, "max_s": 0.0, "p99_s": 0.0}},
         "same_site_nesting": {"a": 2}, "threads": ["t2"]},
    ]
    assert concurrency.merge_snapshots(snaps) == jconcurrency.merge_snapshots(snaps)
    cells = [{"cells": {"geo": {"geo_merge": 2}}},
             {"cells": {"geo": {"geo_merge": 1}, "wire": {"hll_add": 3}}}]
    from redisson_tpu import contractwitness as jcw

    assert cw.merge_contract_snapshots(cells) == jcw.merge_contract_snapshots(cells)
