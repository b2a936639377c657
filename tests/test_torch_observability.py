"""observability.py of the port on the CPU: the counterpart of every test
of tests/test_observability.py that needs nothing outside this slice
(metrics registry, executor instrumentation, the profiler hook, the nodes
API), then the registry held against the JAX package's after the same
workload.

All port clients run on `Config().use_cuda(device="cpu")`.
"""

import json
import os

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
import redisson_tpu.observability as jobs
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.observability import (ExecutorMetrics, Histogram, MetricsRegistry,
                                              NodesGroup, profile)

#: tests of tests/test_observability.py with no counterpart here, and why
EXCLUDED = {}


def cpu_client(cfg=None):
    """A port client on the CPU (`device="cpu"`), other sections as given."""
    cfg = cfg or Config()
    cfg.use_cuda(device="cpu")
    return RedissonTorch.create(cfg)


@pytest.fixture()
def client():
    c = cpu_client()
    yield c
    c.shutdown()


def test_registry_counters_and_gauges():
    r = MetricsRegistry()
    r.inc("a.b")
    r.inc("a.b", 4)
    assert r.counter("a.b") == 5
    r.gauge("g", lambda: 7.5)
    snap = r.snapshot()
    assert snap["counters"]["a.b"] == 5
    assert snap["gauges"]["g"] == 7.5


def test_histogram_stats():
    h = Histogram()
    for v in (0.001, 0.01, 0.01, 1.0):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 4
    assert s["min"] == 0.001 and s["max"] == 1.0
    assert abs(s["mean"] - (0.001 + 0.01 + 0.01 + 1.0) / 4) < 1e-9


def test_prometheus_rendering():
    r = MetricsRegistry()
    r.inc("ops.total", 3)
    r.gauge("queue.depth", lambda: 2)
    r.observe("lat", 0.005)
    text = r.render_prometheus()
    assert "ops_total 3" in text
    assert "queue_depth 2" in text
    assert "lat_count 1" in text
    assert 'lat_bucket{le="0.01"}' in text


def test_prometheus_histogram_exposition():
    r = MetricsRegistry()
    r.observe("lat", 0.005)
    r.observe("lat", 2.0)
    text = r.render_prometheus()
    assert "# TYPE lat histogram" in text
    # The overflow bucket must be spelled +Inf, never Python's "inf".
    assert 'lat_bucket{le="+Inf"} 2' in text
    assert 'le="inf"' not in text
    counts = [int(line.rsplit(" ", 1)[1])
              for line in text.splitlines() if line.startswith("lat_bucket")]
    assert counts == sorted(counts)  # cumulative => non-decreasing
    assert counts[-1] == 2  # +Inf bucket equals _count
    assert "lat_count 2" in text
    assert "lat_sum" in text


def test_registry_snapshot_mutation_safe():
    r = MetricsRegistry()
    r.inc("ops.total", 3)
    r.observe("lat", 0.005)
    snap = r.snapshot()
    snap["counters"]["ops.total"] = 999
    snap["histograms"]["lat"]["buckets"].clear()
    snap["histograms"]["lat"]["count"] = 0
    snap2 = r.snapshot()
    assert snap2["counters"]["ops.total"] == 3
    assert snap2["histograms"]["lat"]["count"] == 1
    assert sum(snap2["histograms"]["lat"]["buckets"].values()) == 1


def test_fault_injector_snapshot_mutation_safe():
    from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan, FaultRule

    inj = FaultInjector(FaultPlan(rules=[FaultRule(seam="journal_fsync")]))
    with pytest.raises(Exception):
        inj.fire("journal_fsync")
    snap = inj.snapshot()
    snap["fired"][0]["seam"] = "corrupted"
    snap["hits"][0] = 999
    snap2 = inj.snapshot()
    assert snap2["fired"][0]["seam"] == "journal_fsync"
    assert snap2["hits"][0] == 1


@pytest.mark.parametrize("foreign", [False, True], ids=["own", "foreign"])
def test_executor_metrics_equal_the_registrys_own_observations(foreign):
    """ExecutorMetrics buffers its records and folds them in on read; its
    snapshot equals the same values fed through the registry's own inc /
    observe, also where another writer made a histogram first."""
    calls = [("hll_add", 3, 120_000, 2e-3, 1e-4, 1 << 21, 5e-4),
             ("map_put", 1, 1, 3e-5, None, 0, None),
             ("hll_add", 1, 40_000, 4e-3, 0.0, 1 << 21, 1e-3)]
    snaps = []
    for mod in (jobs, None):
        reg = mod.MetricsRegistry() if mod else MetricsRegistry()
        if foreign:
            reg.observe("executor.batch_keys", 7)
        m = mod.ExecutorMetrics(reg) if mod else ExecutorMetrics(reg)
        for kind, nops, nkeys, lat, qd, cap, st in calls:
            m.record_batch(kind, nops, nkeys, lat, queue_delay_s=qd, cap=cap, stage_s=st)
            m.record_run(2, nops > 1)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["histograms"]["executor.batch_keys"]["count"] == 3 + foreign


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_executor_metrics_fold_equals_jax(seed):
    """A seeded stream of runs (kinds, keys, latencies, queue delays, caps,
    staging times, overlaps), read midway and at the end, with more runs
    than one fold takes: the port's buffered metrics read the same
    counters and histograms, sums to the bit, as the JAX package's,
    which records each run directly."""
    snaps = []
    for mod in (jobs, None):
        reg = mod.MetricsRegistry() if mod else MetricsRegistry()
        m = mod.ExecutorMetrics(reg) if mod else ExecutorMetrics(reg)
        got = []
        r = np.random.default_rng(seed + 100)
        for i in range(3 * ExecutorMetrics.FOLD_EVERY + 7):
            if r.random() < 0.3:
                m.record_run(int(r.integers(1, 4)), bool(r.random() < 0.5))
            else:
                m.record_batch(
                    ("hll_add", "mc_put", "q_offer")[int(r.integers(3))],
                    int(r.integers(0, 6)), int(r.choice([0, 1, 40_000])),
                    float(r.random() * 1e-2),
                    queue_delay_s=(None, 0.0, -1e-6, float(r.random()))[int(r.integers(4))],
                    cap=int(r.choice([0, 1 << 21])),
                    stage_s=None if r.random() < 0.3 else float(r.random() * 1e-3))
            if i == 100 + seed:
                got.append(reg.snapshot())
                got.append(reg.counter("executor.ops_total"))
        got.append(reg.snapshot())
        snaps.append(got)
    assert snaps[1] == snaps[0]


def test_executor_metrics_flow(client):
    h = client.get_hyper_log_log("obs:h")
    h.add_all([b"k%d" % i for i in range(1000)])
    h.count()
    snap = client.metrics.snapshot()
    assert snap["counters"]["executor.ops_total"] >= 2
    assert snap["counters"]["executor.keys_total"] >= 1000
    assert snap["counters"].get("executor.ops.hll_add", 0) >= 1
    assert snap["histograms"]["executor.batch_keys"]["count"] >= 1
    assert snap["gauges"]["executor.queue_depth"] == 0  # drained


def test_executor_error_metric(client):
    bf = client.get_bloom_filter("obs:bloom")
    with pytest.raises(Exception):
        bf.add(b"x")  # not initialized -> backend error
    assert client.metrics.counter("executor.errors_total") >= 1


def test_nodes_group_ping(client):
    ng = client.get_nodes_group()
    nodes = ng.nodes()
    assert any(n.kind == "device" for n in nodes)
    assert ng.ping_all()


def test_nodes_group_with_redis_tier():
    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis

    with EmbeddedRedis() as er:
        cfg = Config()
        cfg.use_cuda(device="cpu")
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        try:
            ng = c.get_nodes_group()
            kinds = {n.kind for n in ng.nodes()}
            assert kinds == {"device", "redis"}
            assert ng.ping_all()
        finally:
            c.shutdown()


def test_connection_listener_fanout(client):
    ng = client.get_nodes_group()
    events = []
    ng.add_connection_listener(lambda e, ident: events.append((e, ident)))
    ng.fire("connect", "node-1")
    ng.fire("disconnect", "node-1")
    assert events == [("connect", "node-1"), ("disconnect", "node-1")]


def test_profile_context_manager(tmp_path, client):
    # Must not raise whether or not the platform supports tracing.
    with profile(str(tmp_path / "trace")):
        client.get_hyper_log_log("obs:p").add_all([b"a", b"b"])


def test_profile_writes_a_chrome_trace(tmp_path, client):
    """The port's profile() exports torch.profiler's Chrome trace into the
    directory (CPU activity here; on a card the CUDA kernels too)."""
    d = tmp_path / "trace"
    with profile(str(d)):
        client.get_hyper_log_log("obs:p2").add_ints(np.arange(100, dtype=np.uint64))
    doc = json.loads((d / "trace.json").read_text())
    assert doc["traceEvents"]


def test_profile_swallows_a_profiler_that_cannot_start(tmp_path, client, monkeypatch):
    """JAX's semantics: a profiler failure never reaches the block, and
    nothing is written (the chip check looks for the file)."""
    import torch

    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with profile(str(tmp_path / "none")):
        client.get_hyper_log_log("obs:p3").add_all([b"a"])
    assert not os.path.exists(tmp_path / "none" / "trace.json")


def test_nodes_group_pings_the_clients_device(client):
    nodes = client.get_nodes_group().nodes()
    assert [(n.kind, n.get_addr()) for n in nodes] == [("device", "cpu")]
    assert nodes[0].info() == {"type": "device", "addr": "cpu", "alive": True}
    assert client.get_cluster_nodes_group().ping_all()


# -- the registry against the JAX package's -----------------------------------


def _workload(c, seed=0):
    """Sequential sync ops (one run each): HLL, BitSet and Bloom writes and
    reads, a failing op, a delete."""
    rng = np.random.default_rng(seed)
    h = c.get_hyper_log_log("w:h")
    h.add_ints(rng.integers(0, 2**63, 3000, dtype=np.uint64))
    h.add_all([b"k%d" % i for i in range(500)])
    h.count()
    b = c.get_bit_set("w:b")
    b.set_bits(rng.integers(0, 5000, 200))
    b.cardinality()
    bf = c.get_bloom_filter("w:f")
    bf.try_init(10000, 0.01)
    bf.add_ints(rng.integers(0, 2**63, 300, dtype=np.uint64))
    with pytest.raises(Exception):
        c.get_bloom_filter("w:uninit").add(b"x")
    c.delete("w:b")


@pytest.mark.parametrize("serve", [False, True], ids=["raw", "served"])
def test_registry_matches_jax_after_the_same_workload(serve):
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "sort"
    tcfg = Config()
    tcfg.use_cuda(device="cpu", ingest="sort")
    if serve:
        jcfg.use_serve()
        jcfg.use_trace()
        tcfg.use_serve()
        tcfg.use_trace()
    jc, tc = RedissonTPU.create(jcfg), RedissonTorch.create(tcfg)
    try:
        _workload(jc)
        _workload(tc)
        js, ts = jc.metrics.snapshot(), tc.metrics.snapshot()
        for part in ("counters", "gauges", "histograms"):
            assert sorted(ts[part]) == sorted(js[part]), part
        jt = jc.metrics.render_prometheus().splitlines()
        tt = tc.metrics.render_prometheus().splitlines()
        jcount = [ln for i, ln in enumerate(jt) if i and jt[i - 1].endswith(" counter")]
        tcount = [ln for i, ln in enumerate(tt) if i and tt[i - 1].endswith(" counter")]
        assert jcount and tcount == jcount
    finally:
        jc.shutdown()
        tc.shutdown()
