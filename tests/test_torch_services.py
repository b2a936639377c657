"""services/ of the port on the CPU: the counterpart of every test of
tests/test_services.py (the RPC remote service and the cache manager) on
`RedissonTorch.create(Config().use_cuda(device="cpu"))`; then the client's
wiring of the tier (one cached remote service per name, shut down with
the client; only `get_topology_manager` still raises) and the request,
response and cache keys held against the JAX package's.
"""

import time

import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.services import CacheManager as JCacheManager
from redisson_tpu.services import RRemoteService as JRRemoteService
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.services import (CacheConfig, CacheManager,
                                         RemoteInvocationOptions,
                                         RemoteServiceAckTimeoutError,
                                         RemoteServiceTimeoutError,
                                         RRemoteService)
from redisson_tpu_torch.services.remote import RemoteServiceError


@pytest.fixture()
def client():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    yield c
    c.shutdown()


class Calculator:
    def add(self, a, b):
        return a + b

    def fail(self):
        raise ValueError("boom")

    def slow(self):
        time.sleep(3)
        return "late"

    def echo_kwargs(self, **kw):
        return dict(sorted(kw.items()))


def test_rpc_roundtrip(client):
    rs = client.get_remote_service()
    rs.register("Calculator", Calculator(), workers=2)
    try:
        calc = rs.get("Calculator")
        assert calc.add(2, 3) == 5
        assert calc.echo_kwargs(b=2, a=1) == {"a": 1, "b": 2}
    finally:
        rs.shutdown()


def test_rpc_remote_exception_propagates(client):
    rs = client.get_remote_service()
    rs.register("Calculator", Calculator())
    try:
        calc = rs.get("Calculator")
        with pytest.raises(RemoteServiceError, match="ValueError: boom"):
            calc.fail()
    finally:
        rs.shutdown()


def test_rpc_ack_timeout_when_no_worker(client):
    rs = client.get_remote_service()
    # nothing registered: ack must time out quickly
    calc = rs.get("Calculator",
                  RemoteInvocationOptions(ack_timeout_s=0.2,
                                          execution_timeout_s=1.0))
    with pytest.raises(RemoteServiceAckTimeoutError):
        calc.add(1, 2)
    rs.shutdown()


def test_rpc_execution_timeout(client):
    rs = client.get_remote_service()
    rs.register("Calculator", Calculator())
    try:
        calc = rs.get("Calculator",
                      RemoteInvocationOptions(ack_timeout_s=1.0,
                                              execution_timeout_s=0.3))
        with pytest.raises(RemoteServiceTimeoutError):
            calc.slow()
    finally:
        rs.shutdown()


def test_rpc_fire_and_forget(client):
    hits = []

    class Sink:
        def record(self, x):
            hits.append(x)

    rs = client.get_remote_service()
    rs.register("Sink", Sink())
    try:
        sink = rs.get("Sink", RemoteInvocationOptions().no_result())
        assert sink.record("a") is None  # returns immediately
        deadline = time.time() + 2
        while not hits and time.time() < deadline:
            time.sleep(0.01)
        assert hits == ["a"]
    finally:
        rs.shutdown()


def test_rpc_async_proxy(client):
    rs = client.get_remote_service()
    rs.register("Calculator", Calculator(), workers=2)
    try:
        calc = rs.get_async("Calculator")
        futs = [calc.add(i, i) for i in range(10)]
        assert [f.result(timeout=5) for f in futs] == [2 * i for i in range(10)]
    finally:
        rs.shutdown()


def test_rpc_separate_service_instances_share_structures(client):
    # A second RRemoteService instance over the same engine (the reference's
    # in-JVM server+client pair) reaches the same queues. The facade getter
    # itself caches per name.
    assert client.get_remote_service() is client.get_remote_service()
    rs_server = client.get_remote_service()
    rs_server.register("Calculator", Calculator())
    rs_client = RRemoteService(client)  # independent instance, same queues
    try:
        assert rs_client.get("Calculator").add(10, 5) == 15
    finally:
        rs_server.shutdown()
        rs_client.shutdown()


# ---------------------------------------------------------------------------
# Cache manager
# ---------------------------------------------------------------------------


def test_cache_basic(client):
    cm = client.get_cache_manager({"users": {"ttl_s": None}})
    cache = cm.get_cache("users")
    cache.put("u1", {"name": "ada"})
    assert cache.get("u1") == {"name": "ada"}
    assert cache.get("nope", "dflt") == "dflt"
    cache.evict("u1")
    assert cache.get("u1") is None


def test_cache_ttl_expiry(client):
    cm = CacheManager(client, {"short": {"ttl_s": 0.2}})
    cache = cm.get_cache("short")
    cache.put("k", "v")
    assert cache.get("k") == "v"
    time.sleep(0.4)
    assert cache.get("k") is None


def test_cache_put_if_absent_and_clear(client):
    cache = client.get_cache_manager().get_cache("pia")
    assert cache.put_if_absent("k", 1) is None
    assert cache.put_if_absent("k", 2) == 1
    assert cache.size() == 1
    cache.clear()
    assert cache.size() == 0


def test_cached_decorator(client):
    cm = client.get_cache_manager()
    calls = []

    @cm.cached("memo")
    def expensive(x):
        calls.append(x)
        return x * 10

    assert expensive(3) == 30
    assert expensive(3) == 30
    assert calls == [3]  # second call served from cache
    assert expensive(4) == 40
    assert calls == [3, 4]


def test_cache_manager_from_json(client):
    cm = CacheManager.from_json(client, '{"a": {"ttl_s": 5}, "b": {}}')
    assert cm.cache_names() == ["a", "b"]
    assert cm.get_cache("a")._config.ttl_s == 5


def test_cached_decorator_caches_none(client):
    cm = client.get_cache_manager()
    calls = []

    @cm.cached("memo_none")
    def maybe(x):
        calls.append(x)
        return None

    assert maybe(1) is None
    assert maybe(1) is None
    assert calls == [1]  # None results are cached, not recomputed


def test_cache_clear_with_ttl_policy(client):
    cm = client.get_cache_manager({"t": {"ttl_s": 60}})
    cache = cm.get_cache("t")
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.size() == 2
    cache.clear()  # RMapCache backing must support clear
    assert cache.size() == 0
    cache.put("c", 3)  # still usable (eviction schedule intact)
    assert cache.get("c") == 3


# ---------------------------------------------------------------------------
# The client's wiring, and the JAX package's key layout
# ---------------------------------------------------------------------------


def test_remote_services_stop_with_the_client():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    rs = c.get_remote_service("svc")
    rs.register("Calculator", Calculator(), workers=2)
    assert rs.get("Calculator").add(1, 1) == 2
    workers = list(rs._workers)
    c.shutdown()
    assert c._remote_services == {}
    for t in workers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in workers)


def test_topology_manager_alone_still_raises(client):
    """It raised until the cluster tier ported parallel/topology.py; now it
    polls the client's device like the JAX client's (the name is kept)."""
    tm = client.get_topology_manager(scan_interval_s=60.0, failed_attempts=1)
    assert tm.live_nodes() == [str(client.device)]
    assert tm.scan_once() is False and tm.scans == 1
    assert isinstance(client.get_cache_manager(), CacheManager)
    assert isinstance(client.get_remote_service(), RRemoteService)
    assert CacheConfig.from_dict({"ttl_s": 2}).ttl_s == 2


@pytest.mark.parametrize("ttl", [None, 30.0])
def test_cache_keys_and_values_equal_jax(client, ttl):
    """A cache filled the same way through both packages leaves the same
    keys (the `cache:<name>` map) holding the same entries."""
    jc = RedissonTPU.create()
    try:
        conf = {"c": {"ttl_s": ttl}}
        for cm in (CacheManager(client, conf), JCacheManager(jc, conf)):
            cache = cm.get_cache("c")
            for i in range(20):
                cache.put(f"k{i}", {"v": i})
            cache.evict("k3")
            cache.put_if_absent("k4", "no")
        for c in (client, jc):
            assert c.keys("cache:*") == ["cache:c"]
        getter = "get_map_cache" if ttl else "get_map"
        want = dict(getattr(jc, getter)("cache:c").read_all_map())
        got = dict(getattr(client, getter)("cache:c").read_all_map())
        assert got == want and len(got) == 19
    finally:
        jc.shutdown()


def test_rpc_request_queue_name_equals_jax(client):
    """A fire-and-forget request with no worker waits on the JAX package's
    queue name (the `{service}:{iface}` hashtag) with the same fields."""
    jc = RedissonTPU.create()
    try:
        opts = RemoteInvocationOptions().no_ack().no_result()
        seen = []
        for c, cls in ((client, RRemoteService), (jc, JRRemoteService)):
            rs = cls(c, "svc")
            assert rs.get("Calc", opts).add(1, b=2) is None
            rs.shutdown()
            names = sorted(c.keys("svc*"))
            req = c.get_queue(names[0]).peek()
            req.pop("id")
            seen.append((names, req))
        assert seen[0] == seen[1]
        assert seen[0][0] == ["svc:{Calc}"]
    finally:
        jc.shutdown()
