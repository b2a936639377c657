"""The redis connection tier of the port (interop/pool.py and
interop/topology_redis.py) on the CPU: the JAX package's corpora
tests/test_pool.py, tests/test_topology_redis.py and
tests/test_cluster_redis.py run against the port through `port_corpus`
(see tests/test_torch_interop.py), the passthrough client's tests among
them (JAX's client class read as `RedissonTorch`), then the client's
`_make_resp_pool` branches driven through the durability tier:
master/slave, sentinel bootstrap and +switch-master, a cluster end to end,
and a failed cluster bootstrap that leaks no pool or scan thread.
"""

import threading
import time

import numpy as np
import pytest

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.interop import hyll
from redisson_tpu_torch.interop.fake_server import ClusterFixture, EmbeddedRedis
from redisson_tpu_torch.interop.resp_client import SyncRespClient
from redisson_tpu_torch.interop.topology_redis import (ClusterRouter,
                                                       MasterSlaveRouter,
                                                       SentinelManager)
from redisson_tpu_torch.ops import crc16
from tests import test_cluster_redis, test_pool, test_topology_redis
from tests.test_torch_interop import (CLIENT_ALIASES, CLIENT_EXTRA,
                                      corpus_tests, port_corpus)

#: tests of tests/test_pool.py with no counterpart run unchanged (none)
EXCLUDED_POOL = {}

#: tests of tests/test_topology_redis.py with no counterpart run
#: unchanged (none)
EXCLUDED_TOPOLOGY = {}

#: tests of tests/test_cluster_redis.py with no counterpart run unchanged
#: (none)
EXCLUDED_CLUSTER = {}

_CORPUS = {**port_corpus(test_pool, EXCLUDED_POOL, "pool", CLIENT_EXTRA,
                         CLIENT_ALIASES),
           **port_corpus(test_topology_redis, EXCLUDED_TOPOLOGY, "topology",
                         CLIENT_EXTRA, CLIENT_ALIASES),
           **port_corpus(test_cluster_redis, EXCLUDED_CLUSTER, "cluster",
                         CLIENT_EXTRA, CLIENT_ALIASES)}
globals().update(_CORPUS)


@pytest.fixture()
def rclient():
    """test_pool.py's fixture on the port: a passthrough client."""
    with EmbeddedRedis() as server:
        cfg = Config()
        cfg.use_redis().address = f"redis://127.0.0.1:{server.port}"
        c = RedissonTorch.create(cfg)
        yield c
        c.shutdown()


@pytest.fixture()
def pair():
    master, slave = EmbeddedRedis.pair()
    try:
        yield master, slave
    finally:
        slave.stop()
        master.stop()


@pytest.fixture()
def cluster():
    with ClusterFixture(n_masters=3) as cf:
        yield cf


@pytest.fixture()
def sentinel_setup():
    master, slave = EmbeddedRedis.pair()
    sentinel = EmbeddedRedis(share_with=master)
    sentinel.server.sentinel_masters["mymaster"] = f"127.0.0.1:{master.port}"
    sentinel.server.sentinel_slaves["mymaster"] = [f"127.0.0.1:{slave.port}"]
    try:
        yield master, slave, sentinel
    finally:
        sentinel.stop()
        slave.stop()
        master.stop()


def test_corpora_were_imported():
    for mod, excluded, prefix, n in (
            (test_pool, EXCLUDED_POOL, "pool", 9),
            (test_topology_redis, EXCLUDED_TOPOLOGY, "topology", 15),
            (test_cluster_redis, EXCLUDED_CLUSTER, "cluster", 15)):
        names = corpus_tests(mod)
        assert len(names) == n
        assert set(excluded) <= names
        assert {f"test_{prefix}__{x[5:]}" for x in names - set(excluded)} <= set(_CORPUS)


# ---------------------------------------------------------------------------
# The client's connection tier under the durability tier
# ---------------------------------------------------------------------------


def _durable(**redis):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    for k, v in redis.items():
        setattr(cfg.use_redis(), k, v)
    return RedissonTorch.create(cfg)


def _fill(c, name="th", n=2000):
    c.get_hyper_log_log(name).add_all([b"k%d" % i for i in range(n)])
    regs, _v = c._executor.execute_sync(name, "hll_export", None)
    return np.asarray(regs, np.uint8)


def test_durability_over_master_slave(pair):
    master, slave = pair
    c = _durable(address=f"redis://127.0.0.1:{master.port}",
                 slave_addresses=[f"redis://127.0.0.1:{slave.port}"],
                 read_mode="SLAVE", timeout_ms=1000, failed_attempts=2)
    try:
        assert isinstance(c._resp, MasterSlaveRouter)
        regs = _fill(c)
        assert c.durability.flush(["th"]) == 1
        assert b"th" in master.server.data  # the write hit the master
        assert np.array_equal(hyll.decode(slave.server.data[b"th"]), regs)
        c.delete("th")
        assert c.durability.load_hll("th")  # the GET rides the slave
        back, _v = c._executor.execute_sync("th", "hll_export", None)
        assert np.array_equal(back, regs)
        assert [n.kind for n in c.get_nodes_group().nodes()] == ["device", "redis"]
    finally:
        c.shutdown()


def test_durability_role_polling_monitor(pair):
    master, slave = pair
    c = _durable(address=f"redis://127.0.0.1:{master.port}",
                 slave_addresses=[f"redis://127.0.0.1:{slave.port}"],
                 role_scan_interval_ms=50, timeout_ms=1000)
    try:
        monitor = c._role_monitor
        assert monitor is not None
    finally:
        c.shutdown()
    assert c._role_monitor is None and c._resp is None


def _sentinel_cfg(sentinel):
    return dict(address="redis://ignored:1",
                sentinel_addresses=[f"redis://127.0.0.1:{sentinel.port}"],
                master_name="mymaster", timeout_ms=1000, failed_attempts=2)


def test_durability_sentinel_bootstrap(sentinel_setup):
    master, slave, sentinel = sentinel_setup
    c = _durable(**_sentinel_cfg(sentinel))
    try:
        assert isinstance(c._resp, SentinelManager)
        assert c._resp.master_address.endswith(str(master.port))
        regs = _fill(c, "sb")
        c.durability.flush(["sb"])
        assert np.array_equal(hyll.decode(master.server.data[b"sb"]), regs)
        assert b"sb" in slave.server.data  # replicated
    finally:
        c.shutdown()


def test_durability_follows_switch_master(sentinel_setup):
    master, slave, sentinel = sentinel_setup
    c = _durable(**_sentinel_cfg(sentinel))
    try:
        _fill(c, "sw")
        c.durability.flush(["sw"])
        pub = SyncRespClient(port=sentinel.port)
        pub.connect()
        try:
            pub.execute("PUBLISH", "+switch-master",
                        f"mymaster 127.0.0.1 {master.port} 127.0.0.1 {slave.port}")
        finally:
            pub.close()
        deadline = time.time() + 5
        while time.time() < deadline and not c._resp.master_address.endswith(
                str(slave.port)):
            time.sleep(0.05)
        assert c._resp.master_address.endswith(str(slave.port))
        slave.server.replicas.append(master.server)
        master.server.replicas.clear()
        regs = _fill(c, "after")
        c.durability.flush(["after"])
        assert np.array_equal(hyll.decode(slave.server.data[b"after"]), regs)
    finally:
        c.shutdown()


def test_durability_sentinel_slave_events(sentinel_setup):
    master, slave, sentinel = sentinel_setup
    c = _durable(**_sentinel_cfg(sentinel))
    try:
        router = c._resp.router
        assert any(a.endswith(str(slave.port)) for a in router._slaves)
        pub = SyncRespClient(port=sentinel.port)
        pub.connect()
        try:
            pub.execute("PUBLISH", "+sdown",
                        f"slave s1 127.0.0.1 {slave.port} @ mymaster "
                        f"127.0.0.1 {master.port}")
            deadline = time.time() + 5
            while time.time() < deadline and router._slaves:
                time.sleep(0.05)
            assert not router._slaves
            pub.execute("PUBLISH", "-sdown",
                        f"slave s1 127.0.0.1 {slave.port} @ mymaster "
                        f"127.0.0.1 {master.port}")
            deadline = time.time() + 5
            while time.time() < deadline and not router._slaves:
                time.sleep(0.05)
            assert any(a.endswith(str(slave.port)) for a in router._slaves)
        finally:
            pub.close()
    finally:
        c.shutdown()


def test_durability_end_to_end_over_cluster(cluster):
    c = _durable(cluster_addresses=list(cluster.addresses),
                 cluster_scan_interval_ms=0)
    try:
        assert isinstance(c._resp, ClusterRouter)
        assert c._cluster_manager is not None
        names = [f"cb:{i}" for i in range(12)]
        want = {n: _fill(c, n, 300 + i) for i, n in enumerate(names)}
        bf = c.get_bloom_filter("cb:bf")
        bf.try_init(expected_insertions=2000, false_probability=0.01)
        bf.add_all([b"m%d" % i for i in range(500)])
        assert c.durability.flush() == len(names) + 1
        for n in names:  # each blob sits on its slot's owner
            owner = cluster.state.owner_of(crc16.key_slot(n))
            assert n.encode() in cluster.server_for(owner).data
        owners = {cluster.state.owner_of(crc16.key_slot(n)) for n in names}
        assert len(owners) >= 2
        cfg_owner = cluster.state.owner_of(crc16.key_slot("{cb:bf}__config"))
        assert cfg_owner == cluster.state.owner_of(crc16.key_slot("cb:bf"))
        c.flushall()
        for n in names:
            assert c.durability.load_hll(n)
            got, _v = c._executor.execute_sync(n, "hll_export", None)
            assert np.array_equal(got, want[n])
        assert c.durability.load_bloom("cb:bf")
        assert all(c.get_bloom_filter("cb:bf").contains_all(
            [b"m%d" % i for i in range(500)]))
    finally:
        c.shutdown()
    assert c._cluster_manager is None


def test_durability_create_against_non_cluster_does_not_leak(cluster):
    with EmbeddedRedis() as plain:  # CLUSTER support disabled on this one
        before = {t.name for t in threading.enumerate()}
        cfg = Config()
        cfg.use_cuda(device="cpu")
        cfg.use_redis().cluster_addresses = [f"127.0.0.1:{plain.port}"]
        cfg.flush_interval_s = 0.05
        with pytest.raises(Exception):
            RedissonTorch.create(cfg)
        deadline = time.time() + 3
        while time.time() < deadline:
            leaked = {t.name for t in threading.enumerate()} - before
            if not leaked:
                break
            time.sleep(0.05)
        assert not leaked, leaked
