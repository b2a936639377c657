"""Shard-level HA of the port on the CPU: the JAX package's corpus
tests/test_ha.py runs against the port, then a seeded HA cluster of the
port held against the JAX package's: the same writes, a failover of shard
0's primary and more writes, with every shard's sketches and cells, its
owned slots and the failover count compared exactly.

The corpus runs through `port_corpus` (tests/test_torch_interop.py) with
its two client factories redefined on `use_cuda(device="cpu")` (the
port's default is the card): `make_replicated` (a single engine with a
replica fleet, tests/test_torch_replica.py) and `_make_ha_cluster` (a
slot-sharded cluster whose every shard carries its own fleet,
`ClusterConfig.replicas_per_shard`). `tools.histcheck` stays the JAX
package's tool: the journal format is shared.
"""

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from tests import test_ha
from tests.test_torch_cluster import _shard_state, _stream
from tests.test_torch_interop import CLIENT_ALIASES, corpus_tests, port_corpus
from tests.test_torch_replica import make_replicated


def make_ha_cluster(tmp_path, num_shards=2, replicas_per_shard=1):
    """test_ha.py's `_make_ha_cluster` on the CPU."""
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_cluster(num_shards=num_shards, dir=str(tmp_path / "cl"),
                    replicas_per_shard=replicas_per_shard)
    rc = cfg.use_replicas(replicas_per_shard)  # per-shard tuning template
    rc.health_interval_s = 0.0  # deterministic: failover driven manually
    rc.poll_interval_s = 0.002
    return RedissonTorch.create(cfg)


#: tests of tests/test_ha.py with no counterpart run unchanged, and why
EXCLUDED = {}

_CORPUS = port_corpus(
    test_ha, EXCLUDED, "ha",
    ("redisson_tpu.client", "redisson_tpu.config", "redisson_tpu.fault",
     "redisson_tpu.cluster"),
    CLIENT_ALIASES,
    overrides={"make_replicated": make_replicated,
               "_make_ha_cluster": make_ha_cluster})
globals().update(_CORPUS)


def test_corpus_was_imported():
    names = corpus_tests(test_ha)
    assert len(names) == 14
    assert set(EXCLUDED) <= names
    assert {f"test_ha__{k[5:]}" for k in names - set(EXCLUDED)} <= set(_CORPUS)
    fn = _CORPUS["test_ha__cluster_shard_failover_slot_table_survives"]
    assert fn.__globals__["_make_ha_cluster"] is make_ha_cluster
    fn = _CORPUS["test_ha__failover_retry_after_aborted_promotion"]
    assert fn.__globals__["make_replicated"] is make_replicated


# -- the port's HA cluster against the JAX package's ---------------------------


def _fail_over_shard0(c):
    """Kill shard 0's primary once its fleet has caught up, promote its
    replica; the promotee owns the same slots."""
    s0 = c.cluster.shards[0]
    test_ha._wait_shard_caught_up(s0)
    owned = s0.guard.owned_slots()
    s0.client._executor.shutdown(wait=False)
    assert s0.replicas.failover("test kill") is not None
    assert s0.guard.owned_slots() == owned


def test_ha_cluster_equals_jax(tmp_path):
    jc = test_ha._make_ha_cluster(tmp_path / "jax")
    tc = make_ha_cluster(tmp_path / "port")
    try:
        for c in (jc, tc):
            _stream(c, 31)
            _fail_over_shard0(c)
            _stream(c, 32)  # lands on the promotee and on shard 1
        assert tc.cluster.router.slot_table() == jc.cluster.router.slot_table()
        assert tc.cluster.failovers() == jc.cluster.failovers() == 1
        jinfo, tinfo = jc.cluster_info(), tc.cluster_info()
        assert tinfo == jinfo and tinfo["failovers"] == 1
        for sid in range(2):
            js, ts = jc.cluster.shards[sid], tc.cluster.shards[sid]
            assert ts.guard.owned_slots() == js.guard.owned_slots()
            state = _shard_state(ts)
            assert set(state) - {"keys"}, sid  # the shard holds sketches
            assert state == _shard_state(js), sid
        names = [f"h{j}" for j in range(8)] + [f"hb{i}" for i in range(3)]
        for n in names:
            got = tc.get_hyper_log_log(n).count()
            exp = jc.get_hyper_log_log(n).count()
            assert abs(got - exp) <= 1e-5 * exp, n
        assert tc.get_buckets().get(*[f"b{i}" for i in range(6)]) == \
            jc.get_buckets().get(*[f"b{i}" for i in range(6)])
    finally:
        tc.shutdown()
        jc.shutdown()
