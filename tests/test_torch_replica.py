"""replica/ of the port on the CPU: the counterpart of every test of
tests/test_replica.py, then the port held against the JAX package.

Counterparts (all clients on `Config().use_cuda(device="cpu")`):

1. READ_KINDS derivation — the routable read set comes from OP_TABLE, not
   a hand list; parked blocking kinds stay pinned to the primary.
2. Config plumbing — replicas section round-trips; replicas without
   persist is a construction-time error.
3. Routing — reads land on caught-up replicas, fall back to the primary
   when the staleness bound can't be met, and read-your-writes pins a
   tenant above its acked seq.
4. Failover — the highest-watermark replica is promoted with zero acked
   writes lost; survivors retarget (partial or full resync); the demoted
   slot rejoins; WAIT semantics via wait_for_replicas.

Against the JAX package:

5. READ_KINDS, the sections `replica_engine_config` strips and the gauge
   names of `register_replica` / `register_follower` equal JAX's;
6. one seeded op stream (HLL add_ints and byte keys, Bloom adds, SETBIT,
   map puts) through a JAX replicated client and a port replicated client:
   every replica's registers, Bloom cells and bitmaps equal JAX's bit for
   bit, the structures keyspace digests equal, and PFCOUNT served by a
   replica agrees within rel 1e-5;
7. the port's own rules: the default config asks for the card, a replica
   runs on the primary's device, and the unreplicated serve path leaves
   the ack sink unset; a raw-executor write's future resolves only once
   the tenant's pin covers it; the failover triggers (a fault at the
   `replica_tail` seam freezes a watermark, failed `health_probe`s and a
   retired DeviceLostFault promote a replica).
"""

import time

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.observability import MetricsRegistry as JMetricsRegistry
from redisson_tpu.observability import register_follower as jregister_follower
from redisson_tpu.observability import register_replica as jregister_replica
from redisson_tpu.replica import READ_KINDS as JREAD_KINDS
from redisson_tpu.replica.manager import replica_engine_config as jengine_config
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.commands import OP_TABLE
from redisson_tpu_torch.config import Config, ReplicaConfig
from redisson_tpu_torch.observability import (MetricsRegistry,
                                              register_follower,
                                              register_replica)
from redisson_tpu_torch.replica import READ_KINDS, ServingReplica
from redisson_tpu_torch.replica.manager import replica_engine_config
from tests.test_torch_persist import sketch_state, structures_canon

#: tests of tests/test_replica.py with no counterpart here, and why (none)
EXCLUDED = {}


def cpu_config():
    cfg = Config()
    cfg.use_cuda(device="cpu")
    return cfg


def make_replicated(tmp_path, n=2, **replica_kw):
    cfg = cpu_config()
    cfg.use_serve()
    cfg.use_persist(str(tmp_path / "primary"), fsync="always")
    rc = cfg.use_replicas(n)
    rc.poll_interval_s = 0.005
    rc.health_interval_s = 0.0  # deterministic tests drive failover manually
    for k, v in replica_kw.items():
        setattr(rc, k, v)
    return RedissonTorch.create(cfg)


def _wait_caught_up(c, n=2, timeout_s=10.0):
    assert c.wait_for_replicas(n, timeout_s=timeout_s) == n


# ---------------------------------------------------------------------------
# 1. read set derivation
# ---------------------------------------------------------------------------

def test_read_kinds_derived_from_op_table():
    assert READ_KINDS  # non-empty: the engine has read ops
    for kind in READ_KINDS:
        assert not OP_TABLE[kind].write
    # every write kind stays on the primary
    assert not any(OP_TABLE[k].write for k in READ_KINDS)
    # parked blocking reads (and their control ops) are pinned to the
    # primary: a bpop on a replica would wait on a frozen snapshot forever.
    assert "bpop" not in READ_KINDS
    assert "bpop_cancel" not in READ_KINDS


# ---------------------------------------------------------------------------
# 2. config plumbing
# ---------------------------------------------------------------------------

def test_config_replicas_roundtrip():
    cfg = Config()
    rc = cfg.use_replicas(3)
    rc.max_lag_seqs = 77
    rc.read_your_writes = False
    d = cfg.to_dict()
    back = Config.from_dict(d)
    assert isinstance(back.replicas, ReplicaConfig)
    assert back.replicas.num_replicas == 3
    assert back.replicas.max_lag_seqs == 77
    assert back.replicas.read_your_writes is False


def test_replicas_require_persist(tmp_path):
    cfg = cpu_config()
    cfg.use_replicas(1)  # no use_persist: nothing to tail
    with pytest.raises(ValueError, match="persist"):
        RedissonTorch.create(cfg)


# ---------------------------------------------------------------------------
# 3. routing
# ---------------------------------------------------------------------------

def test_reads_route_to_replicas_and_match(tmp_path):
    c = make_replicated(tmp_path, n=2)
    try:
        m = c.get_map("m")
        for i in range(30):
            m.put(f"k{i}", i)
        _wait_caught_up(c, 2)
        for i in range(10):
            assert m.get(f"k{i}") == i
        snap = c._dispatch.snapshot()
        assert snap["replica_reads"] >= 10  # reads left the primary
        assert snap["watermarks"] and all(
            w >= 30 for w in snap["watermarks"].values())
        # writes stayed on the primary journal
        assert c.persist.journal.last_seq >= 30
    finally:
        c.shutdown()


def test_stale_replica_falls_back_to_primary(tmp_path):
    c = make_replicated(tmp_path, n=1, max_lag_seqs=2, read_your_writes=False)
    try:
        m = c.get_map("m")
        m.put("k", 1)
        _wait_caught_up(c, 1)
        rep = c.replicas.replicas[0]
        rep._stop.set()  # freeze the tail loop: watermark stops advancing
        time.sleep(0.05)
        frozen = rep.applied_seq
        for i in range(10):  # push primary_seq > frozen + max_lag
            m.put(f"x{i}", i)
        assert c.persist.journal.last_seq - frozen > 2
        before = c._dispatch.primary_fallbacks
        fut, picked, _ = c._dispatch.routed_read("m", "hget",
                                                 {"field": b'"x9"'})
        fut.result(timeout=30)
        assert picked is None  # outside the bound -> primary served it
        assert c._dispatch.primary_fallbacks == before + 1
        # widening the bound makes the frozen replica eligible again
        _, picked, watermark = c._dispatch.routed_read(
            "m", "hget", {"field": b'"k"'}, max_lag=10_000)
        assert picked is rep and watermark == frozen
    finally:
        c.shutdown()


def test_read_your_writes_pins_above_acked_seq(tmp_path):
    c = make_replicated(tmp_path, n=1, max_lag_seqs=10_000)
    try:
        m = c.get_map("m")
        m.put("k", 1)
        _wait_caught_up(c, 1)
        rep = c.replicas.replicas[0]
        rep._stop.set()  # freeze; subsequent acked writes outrun it
        time.sleep(0.05)
        m.put("k", 2)  # acked (fsync=always) -> RYW pin rises above replica
        assert c._dispatch.acked_seq("") >= c.persist.journal.last_seq - 1
        _, picked, _ = c._dispatch.routed_read("m", "hget",
                                               {"field": b'"k"'})
        assert picked is None  # RYW: stale replica may not serve this tenant
        # the same read with RYW off happily takes the stale replica
        _, picked, _ = c._dispatch.routed_read(
            "m", "hget", {"field": b'"k"'}, read_your_writes=False)
        assert picked is rep
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 4. failover
# ---------------------------------------------------------------------------

def test_failover_promotes_highest_watermark_zero_loss(tmp_path):
    c = make_replicated(tmp_path, n=2)
    try:
        m = c.get_map("m")
        for i in range(10):
            m.put(f"k{i}", i)
        _wait_caught_up(c, 2)
        lagger = c.replicas.replicas[0]
        lagger._stop.set()  # replica-0 freezes; replica-1 keeps tailing
        time.sleep(0.05)
        for i in range(10, 25):
            m.put(f"k{i}", i)  # every one acked under fsync=always
        _wait_caught_up(c, 1)
        mgr = c.replicas
        c._executor.shutdown(wait=False)  # primary dies
        promoted = mgr.failover("test kill")
        assert promoted is not None
        assert mgr._promoted.name == "replica-1"  # highest watermark wins
        assert mgr.promotions == 1
        # a second trigger is a no-op: first one won
        assert mgr.failover("late trigger") is None
        # zero acked writes lost on the promoted primary
        pm = promoted.get_map("m")
        for i in range(25):
            assert pm.get(f"k{i}") == i
        # the promoted journal CONTINUES the global numbering
        assert promoted._persist.journal.last_seq >= 25
        # writes flow through the router to the new primary
        m2 = c.get_map("m")
        m2.put("post", 99)
        assert m2.get("post") == 99
        # the lagging survivor full-resynced from the new snapshot (its
        # suffix lives only in the fenced old journal)
        deadline = time.monotonic() + 10
        while lagger.lag() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lagger.applied_seq >= 25
        assert lagger._full_resyncs >= 2
        # the demoted slot rejoins as a fresh replica and catches up
        rejoined = mgr.rejoin()
        assert c.wait_for_replicas(2, timeout_s=10.0) == 2
        assert rejoined.applied_seq >= 26
    finally:
        c.shutdown()


def test_failover_fences_live_old_primary(tmp_path):
    # The DeviceLostFault trigger retires the fault but the executor keeps
    # running: without a fence, writes racing the failover would be acked
    # into the old journal and silently lost. The fence makes them fail.
    c = make_replicated(tmp_path, n=2)
    try:
        m = c.get_map("m")
        for i in range(10):
            m.put(f"k{i}", i)
        _wait_caught_up(c, 2)
        old_journal = c.persist.journal
        mgr = c.replicas
        promoted = mgr.failover("manual, primary still alive")
        assert promoted is not None
        # old journal is fenced: last_seq is final, appends are refused
        assert old_journal.stats()["fenced"]
        fenced_seq = old_journal.last_seq
        assert mgr.last_fence_seq == fenced_seq
        # the promotion watermark reached the fenced tip -> zero acked loss
        assert mgr._promoted.applied_seq == fenced_seq
        pm = promoted.get_map("m")
        for i in range(10):
            assert pm.get(f"k{i}") == i
        # a write straggling onto the OLD (live!) primary fails instead of
        # being acked into the abandoned journal
        with pytest.raises(Exception, match="fenced"):
            c._executor.execute_sync("m", "hput",
                                     {"field": b'"zz"', "value": b"1"})
        assert old_journal.last_seq == fenced_seq
        # router writes flow to the new primary (fence was lifted)
        m.put("post", 1)
        assert m.get("post") == 1
        assert promoted._persist.journal.last_seq > fenced_seq
    finally:
        c.shutdown()


def test_failover_with_empty_fleet_aborts_cleanly(tmp_path):
    c = make_replicated(tmp_path, n=1)
    try:
        mgr = c.replicas
        for rep in list(mgr.replicas):
            rep.close()
        mgr.replicas = []
        assert mgr.failover("nothing to promote") is None
        assert mgr._failed_over is False  # not wedged half-failed-over
        assert "no replicas" in mgr.last_failover_reason
        # the fleet was never fenced: the primary still accepts writes
        c.get_bucket("b").set(1)
        assert c.get_bucket("b").get() == 1
        # a retry after capacity returns can still promote
        mgr.rejoin()
        _wait_caught_up(c, 1)
        assert mgr.failover("retry") is not None
    finally:
        c.shutdown()


def test_batch_writes_advance_ryw_pin_inline_acks(tmp_path):
    # Raw-executor primary (no serve layer): the router itself must attach
    # ack callbacks on the execute_many/batch paths, or batched writes
    # never advance the tenant pin and a stale replica serves the read-back.
    cfg = cpu_config()
    cfg.use_persist(str(tmp_path / "primary"), fsync="always")
    rc = cfg.use_replicas(1)
    rc.poll_interval_s = 0.005
    rc.health_interval_s = 0.0
    rc.max_lag_seqs = 10_000
    c = RedissonTorch.create(cfg)
    try:
        router = c._dispatch
        assert router._inline_acks  # no serve layer on this primary
        c.get_map("m").put("k", 0)
        _wait_caught_up(c, 1)
        rep = c.replicas.replicas[0]
        rep._stop.set()  # freeze: batched writes must outrun it
        time.sleep(0.05)
        batch = c.create_batch()
        bm = batch.get_map("m")
        for i in range(5):
            bm.put_async(f"b{i}", i)
        batch.execute()
        assert router.acked_seq("") >= c.persist.journal.last_seq - 1
        _, picked, _ = router.routed_read("m", "hget", {"field": b'"b4"'})
        assert picked is None  # RYW pin: the frozen replica may not serve
    finally:
        c.shutdown()


def test_replicas_inherit_sanitized_primary_config(tmp_path):
    cfg = cpu_config()
    cfg.use_serve()
    cfg.codec = "pickle"
    cfg.use_persist(str(tmp_path / "primary"), fsync="always")
    rc = cfg.use_replicas(1)
    rc.health_interval_s = 0.0
    c = RedissonTorch.create(cfg)
    try:
        rep_cfg = c.replicas.replicas[0].client.config
        # engine-affecting settings carry over...
        assert rep_cfg.codec == "pickle"
        assert rep_cfg.serve is not None
        # ...subsystems a replica must not run are stripped
        assert rep_cfg.persist is None
        assert rep_cfg.replicas is None
        assert rep_cfg.faults is None
    finally:
        c.shutdown()


def test_replica_read_honors_deadline_kwarg(tmp_path):
    from redisson_tpu_torch.serve import DeadlineExceeded

    c = make_replicated(tmp_path, n=1, max_lag_seqs=10_000,
                        read_your_writes=False)
    try:
        c.get_map("m").put("k", 1)
        _wait_caught_up(c, 1)
        # an already-expired deadline must fail the read whether a replica
        # or the primary serves it
        fut, picked, _ = c._dispatch.routed_read(
            "m", "hget", {"field": b'"k"'}, deadline=time.monotonic() - 1.0)
        assert picked is not None  # a replica was chosen...
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)  # ...and it enforced the deadline
    finally:
        c.shutdown()


def test_wait_for_replicas_semantics(tmp_path):
    c = make_replicated(tmp_path, n=2)
    try:
        c.get_bucket("b").set(1)
        assert c.wait_for_replicas(2, timeout_s=10.0) == 2
        # asking for more replicas than exist times out with the true count
        assert c.wait_for_replicas(3, timeout_s=0.1) == 2
    finally:
        c.shutdown()


def test_replica_gauges_exported(tmp_path):
    c = make_replicated(tmp_path, n=2)
    try:
        c.get_bucket("b").set(1)
        _wait_caught_up(c, 2)
        gauges = c.metrics.snapshot()["gauges"]
        assert gauges["replica.count"] == 2
        assert gauges["replica.full_resyncs"] == 2  # one bootstrap each
        assert gauges["replica.min_watermark"] >= 1
        assert gauges["replica.max_lag"] >= 0
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 5. the registries against the JAX package
# ---------------------------------------------------------------------------

def test_read_kinds_equal_jax():
    assert READ_KINDS == JREAD_KINDS


@pytest.mark.parametrize("shard_id", [None, -1, 0, 3])
def test_engine_config_strips_the_sections_jax_strips(tmp_path, shard_id):
    """Of the sections both packages have, `replica_engine_config` clears
    the same ones (persist, replicas, faults, the redis durability tier and
    its flush interval, and the cluster section of a facade) and keeps the same ones (serve, trace, memory, the wire, codec,
    the pipeline depth, and the cluster section of a shard member, whose
    replicas replay its journaled slot ownership)."""
    def build(cfg):
        cfg.use_serve()
        cfg.use_trace()
        cfg.use_memstat()
        cfg.use_persist(str(tmp_path / "p"))
        cfg.use_faults()
        cfg.use_replicas(2)
        cfg.use_wire()
        if shard_id is not None:
            cfg.use_cluster(num_shards=4).shard_id = shard_id
        cfg.codec = "pickle"
        cfg.inflight_runs = 3
        cfg.use_redis().address = "redis://127.0.0.1:7000"
        cfg.flush_interval_s = 2.0
        return cfg

    jcfg = build(JConfig())
    jcfg.use_tpu()
    tcfg = build(cpu_config())
    jout, tout = jengine_config(jcfg), replica_engine_config(tcfg)
    shared = ("persist", "replicas", "faults", "serve", "trace", "memory",
              "cluster", "wire", "codec", "inflight_runs")
    for name in shared:
        assert (getattr(jout, name) is None) == (getattr(tout, name) is None), name
    for name in ("persist", "replicas", "faults", "redis"):
        assert getattr(tout, name) is None
    assert jout.redis is None and jout.flush_interval_s == tout.flush_interval_s == 0.0
    assert tcfg.redis is not None and tcfg.flush_interval_s == 2.0
    if shard_id is not None and shard_id >= 0:
        assert tout.cluster.shard_id == jout.cluster.shard_id == shard_id
    else:
        assert tout.cluster is None
    assert tout.codec == jout.codec == "pickle"
    assert tout.inflight_runs == jout.inflight_runs == 3
    # the card section survives (replay runs the primary's ingest, on its
    # device), and the primary's config is untouched
    assert tout.cuda.device == "cpu" and tcfg.persist is not None


class _StubFleet:
    replicas = []
    promotions = 0
    _epoch = 0
    _retired = []
    router = None

    def max_lag(self):
        return 0

    min_watermark = full_resyncs = partial_resyncs = max_lag


class _StubFollower:
    applied_seq = 0

    def lag(self):
        return 0


def test_replica_and_follower_gauge_names_equal_jax():
    names = []
    for reg, rf, rr in ((MetricsRegistry(), register_follower, register_replica),
                        (JMetricsRegistry(), jregister_follower,
                         jregister_replica)):
        rf(reg, _StubFollower())
        rr(reg, _StubFleet())
        names.append(sorted(reg.snapshot()["gauges"]))
    assert names[0] == names[1]
    assert "replica.primary_fallbacks" in names[0]
    assert "persist.follower_lag" in names[0]


# ---------------------------------------------------------------------------
# 6. one op stream through a JAX and a port replicated client
# ---------------------------------------------------------------------------

def _op_stream(client, seed: int) -> None:
    rng = np.random.default_rng(seed)
    bf = client.get_bloom_filter("bf")
    bf.try_init(5000, 0.01)
    bits = client.get_bit_set("bits")
    for i in range(6):
        client.get_hyper_log_log(f"h{i % 3}").add_ints(
            rng.integers(0, 2**64, 2000, dtype=np.uint64, endpoint=False))
        client.get_hyper_log_log("hb").add_all([f"u:{i}:{k}" for k in range(40)])
        bf.add_ints(rng.integers(0, 2**64, 300, dtype=np.uint64, endpoint=False))
        bits.set_bits(rng.integers(0, 5000, 50))
        bits.set(int(rng.integers(0, 5000)), False)
        client.get_map("m").put(f"f{i}", i * 7)
    client.get_hyper_log_log("h0").merge_with("h1", "h2")


def _jax_replicated(path):
    cfg = JConfig()
    cfg.use_tpu()
    cfg.use_persist(str(path)).fsync = "always"
    rc = cfg.use_replicas(2)
    rc.poll_interval_s = 0.005
    rc.health_interval_s = 0.0
    return RedissonTPU.create(cfg)


def test_replicas_equal_jax_replicas_bit_for_bit(tmp_path):
    jc = _jax_replicated(tmp_path / "jax")
    tc = make_replicated(tmp_path, n=2)
    try:
        _op_stream(jc, 31)
        _op_stream(tc, 31)
        assert jc.wait_for_replicas(2, timeout_s=30) == 2
        assert tc.wait_for_replicas(2, timeout_s=30) == 2
        want = sketch_state(jc)
        assert set(want) == {"bf", "bits", "h0", "h1", "h2", "hb"}
        assert sketch_state(tc) == want
        jstruct = structures_canon(jc)
        for jrep, trep in zip(jc.replicas.replicas, tc.replicas.replicas):
            assert sketch_state(jrep.client) == want
            assert sketch_state(trep.client) == want
            assert structures_canon(trep.client) == jstruct
        # PFCOUNT and countWith served by a replica
        reads0 = tc._dispatch.replica_reads
        for name in ("h0", "hb"):
            got = tc.get_hyper_log_log(name).count()
            exp = jc.get_hyper_log_log(name).count()
            assert abs(got - exp) <= 1e-5 * exp
        got = tc.get_hyper_log_log("h1").count_with("h2", "hb")
        exp = jc.get_hyper_log_log("h1").count_with("h2", "hb")
        assert abs(got - exp) <= 1e-5 * exp
        assert tc.get_bit_set("bits").cardinality() == \
            jc.get_bit_set("bits").cardinality()
        assert tc._dispatch.replica_reads >= reads0 + 4
    finally:
        tc.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# 7. the port's own rules
# ---------------------------------------------------------------------------

def test_default_config_asks_for_the_card(tmp_path, monkeypatch):
    """ServingReplica and ReplicaManager with no config run on cuda:0 (the
    JAX package's default is local mode on the CPU): without a card,
    construction raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingReplica(0, str(tmp_path / "lead"), ReplicaConfig())
    cfg = Config()
    cfg.use_persist(str(tmp_path / "p"))
    cfg.use_replicas(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RedissonTorch.create(cfg)


def test_replicas_run_on_the_primarys_device(tmp_path):
    c = make_replicated(tmp_path, n=2)
    try:
        for rep in c.replicas.replicas:
            assert rep.client.device == c.device
            assert rep.client.config.cuda.ingest == c.config.cuda.ingest
    finally:
        c.shutdown()


def test_unreplicated_serve_path_has_no_ack_sink():
    cfg = cpu_config()
    cfg.use_serve()
    c = RedissonTorch.create(cfg)
    try:
        assert c.serve._ack_sink is None and c.replicas is None
        assert c._dispatch is c.serve
        with pytest.raises(RuntimeError, match="no replica fleet"):
            c.wait_for_replicas(1)
        assert "replication" not in c.info()
    finally:
        c.shutdown()


def test_raw_executor_write_resolves_after_its_pin():
    """Without a serving layer the router pins the tenant itself; the
    caller's future resolves only once the pin covers the write, so a read
    issued right after result() can never be served below it."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cfg = cpu_config()
        cfg.use_persist(d, fsync="off")
        cfg.use_replicas(1, poll_interval_s=0.005, health_interval_s=0.0)
        c = RedissonTorch.create(cfg)
        try:
            router, journal = c._dispatch, c.persist.journal
            assert router._inline_acks
            record = router.record_ack

            def slow_record(tenant, seq):  # widen the window a race needs
                time.sleep(0.005)
                record(tenant, seq)

            router.record_ack = slow_record
            for i in range(40):
                c.get_bucket(f"b{i % 7}").set(i)
                assert router.acked_seq("") >= journal.last_seq
            batch = c.create_batch()
            for i in range(20):
                batch.get_map("m").put_async(f"k{i}", i)
            batch.execute()
            assert router.acked_seq("") >= journal.last_seq
        finally:
            c.shutdown()


def _poll(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def test_replica_tail_seam_freezes_a_watermark(tmp_path):
    from redisson_tpu_torch.fault import inject
    from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan

    c = make_replicated(tmp_path, n=2, max_lag_seqs=3, read_your_writes=False)
    injector = FaultInjector(FaultPlan.from_dicts(
        [{"seam": "replica_tail", "fault": "retryable", "target": "replica-0",
          "nth": 1, "times": 10**9}]))
    try:
        c.get_bucket("b").set(0)
        _wait_caught_up(c, 2)
        inject.install(injector)
        hits = lambda: injector.snapshot()["hits"][0]  # noqa: E731
        seen = hits()
        _poll(lambda: hits() >= seen + 2)  # a whole pass skipped since
        frozen_rep, live = c.replicas.replicas
        frozen = frozen_rep.applied_seq
        for i in range(10):
            c.get_bucket("b").set(i + 1)
        _poll(lambda: live.applied_seq >= c.persist.journal.last_seq)
        assert frozen_rep.applied_seq == frozen
        assert frozen_rep.lag() >= 10
        for _ in range(6):
            _, picked, _ = c._dispatch.routed_read("b", "get", None)
            assert picked is live  # the frozen replica is out of the bound
        inject.uninstall()
        _wait_caught_up(c, 2)
        assert c.get_bucket("b").get() == 10
    finally:
        inject.uninstall()
        c.shutdown()


def test_failed_health_probes_promote_a_replica(tmp_path):
    from redisson_tpu_torch.fault import inject
    from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan

    c = make_replicated(tmp_path, n=2, health_interval_s=0.01,
                        health_failures=2)
    try:
        c.get_map("m").put("k", 1)
        _wait_caught_up(c, 2)
        inject.install(FaultInjector(FaultPlan.from_dicts(
            [{"seam": "health_probe", "fault": "retryable", "nth": 1,
              "times": 2}])))
        _poll(lambda: c.replicas.promotions == 1)
        assert "health probe failed" in c.replicas.last_failover_reason
        c.get_map("m").put("after", 2)
        assert c.get_map("m").get("after") == 2
        assert c.replicas.primary_client.get_map("m").get("k") == 1
    finally:
        inject.uninstall()
        c.shutdown()


def test_device_lost_fault_triggers_failover(tmp_path):
    from redisson_tpu_torch.fault.taxonomy import DeviceLostFault

    cfg = cpu_config()
    cfg.use_serve()
    cfg.use_persist(str(tmp_path / "primary"), fsync="always")
    cfg.use_faults(rebuild=False)
    cfg.use_replicas(1, poll_interval_s=0.005, health_interval_s=0.0)
    c = RedissonTorch.create(cfg)
    try:
        c.get_bucket("b").set(1)
        _wait_caught_up(c, 1)
        assert c.fault._extra_listeners  # the fleet observes retired faults
        c.fault._on_fault("set", ["b"], DeviceLostFault("card gone"))
        _poll(lambda: c.replicas.promotions == 1)
        assert c.replicas.last_failover_reason == "DeviceLostFault on set"
        assert c.replicas.primary_client.get_bucket("b").get() == 1
    finally:
        c.shutdown()

