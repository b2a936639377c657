"""The JAX package's behavioural corpus for the structures tier, run against
the port's client on the CPU.

Every test function of tests/conformance/test_*_conformance.py,
tests/test_structures.py and tests/test_coordination.py is imported here
under the name `test_<corpus>__<name>` and runs against
`RedissonTorch.create(Config().use_cuda(device="cpu"))`, with the keyspace
flushed before each test (the corpora's own fixture model). No JAX test file
is edited.

Left out by name, with the reason:
- `structures::test_wrongtype_guard` expects the JAX package's
  `redisson_tpu.store.WrongTypeError` class; the port raises its own
  `redisson_tpu_torch.store.WrongTypeError`. `test_port_wrongtype_guard`
  below is the same check against the port's class.
"""

import time

import pytest

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.store import WrongTypeError
from tests import test_coordination, test_structures
from tests.conformance import (test_bitset_conformance,
                               test_bucket_conformance,
                               test_coordination_conformance,
                               test_deque_conformance, test_list_conformance,
                               test_lock_conformance, test_map_conformance,
                               test_mapcache_conformance,
                               test_scoredsortedset_conformance,
                               test_set_conformance)

CORPORA = {
    "bitset": test_bitset_conformance,
    "bucket": test_bucket_conformance,
    "coordconf": test_coordination_conformance,
    "deque": test_deque_conformance,
    "list": test_list_conformance,
    "lock": test_lock_conformance,
    "map": test_map_conformance,
    "mapcache": test_mapcache_conformance,
    "zset": test_scoredsortedset_conformance,
    "set": test_set_conformance,
    "structures": test_structures,
    "coordination": test_coordination,
}

#: (corpus, test name) -> why it does not run against the port
EXCLUDED = {
    ("structures", "test_wrongtype_guard"):
        "expects redisson_tpu.store.WrongTypeError; see test_port_wrongtype_guard",
}


def _import_corpus():
    imported = {}
    for short, mod in CORPORA.items():
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not callable(fn):
                continue
            if (short, name) in EXCLUDED:
                continue
            imported[f"test_{short}__{name[len('test_'):]}"] = fn
    return imported


_CORPUS = _import_corpus()
globals().update(_CORPUS)


@pytest.fixture(scope="module")
def client():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    yield c
    c.shutdown()


@pytest.fixture(autouse=True)
def _flush(client):
    client.get_keys().flushall()
    yield


def test_corpus_was_imported():
    assert len(_CORPUS) >= 250
    for short, name in EXCLUDED:
        assert hasattr(CORPORA[short], name), (short, name)


def test_port_wrongtype_guard(client):
    client.get_bucket("wt").set("v")
    with pytest.raises(WrongTypeError):
        client.get_map("wt").fast_put("a", 1)


# ---- the port's own checks of the tier's plumbing --------------------------


def _taker(q, out):
    try:
        out.append(q.take())
    except Exception as exc:  # noqa: BLE001 — recorded for the assertion
        out.append(exc)


def test_parked_pops_never_block_the_dispatcher(client):
    """More parked take()s than the in-flight window (2) hold no gate and no
    window slot: other ops, and the pushes that serve the waiters, run."""
    import threading

    out = []
    threads = [threading.Thread(target=_taker, args=(client.get_blocking_queue(f"bq{i % 2}"), out))
               for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while (sum(len(q) for q in client._routing.structures._waiters.values()) < 4
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert sum(len(q) for q in client._routing.structures._waiters.values()) == 4
    m = client.get_map("other")
    for i in range(100):
        m.fast_put(i, i)
    assert m.size() == 100
    client.get_hyper_log_log("h").add_all(["a", "b"])
    for i in range(4):
        client.get_blocking_queue(f"bq{i % 2}").offer(i)
    for t in threads:
        t.join(5)
    assert sorted(out) == [0, 1, 2, 3]
    assert client._routing.structures._waiters == {}
    assert client._executor.queue_depth() == 0


def test_bpop_cancel_is_serialised(client):
    """A client-side timeout submits bpop_cancel: the waiter is gone before
    the next push, so the pushed item stays in the queue."""
    q = client.get_blocking_queue("bq")
    assert q.poll(0.05) is None
    assert client._routing.structures._waiters == {}
    q.offer("x")
    assert q.read_all() == ["x"]
    assert q.poll(0.05) == "x"


def test_shutdown_fails_parked_waiters_and_stops_every_thread():
    import threading

    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    out = []
    t = threading.Thread(target=_taker, args=(c.get_blocking_queue("q"), out))
    t.start()
    deadline = time.monotonic() + 5
    while not c._routing.structures._waiters and time.monotonic() < deadline:
        time.sleep(0.005)
    lk = c.get_lock("lk")
    lk.lock()  # starts the watchdog thread
    c.get_map_cache("mc").put("k", 1, 60)  # arms an eviction timer
    c.get_topic("t").publish("m")
    c.shutdown()
    t.join(5)
    assert len(out) == 1 and isinstance(out[0], RuntimeError)
    assert not c._executor._thread.is_alive()
    assert not c._pubsub._thread.is_alive()
    c._watchdog._thread.join(5)
    assert not c._watchdog._thread.is_alive()
    assert c._eviction._timers == {}
    assert c.is_shutdown()


def test_keys_facade_matches_jax():
    from redisson_tpu.client import RedissonTPU
    from redisson_tpu.config import Config as JConfig

    jc = RedissonTPU.create(JConfig())
    tc = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        for c in (jc, tc):
            c.get_map("m").put("a", 1)
            c.get_hyper_log_log("h").add("x")
            c.get_bucket("b:1").set(1)
            c.get_bucket("b:2").set(2)
        for c in (jc, tc):
            assert c.get_keys().count() == 4
            assert sorted(c.keys("b:*")) == ["b:1", "b:2"]
            assert sorted(c.get_keys().get_keys()) == ["b:1", "b:2", "h", "m"]
            assert c.get_keys().delete("h", "m", "nope") == 2
            assert c.delete("b:1") and not c.delete("b:1")
            c.get_keys().flushall()
            assert c.get_keys().count() == 0 and c.keys() == []
    finally:
        jc.shutdown()
        tc.shutdown()


@pytest.mark.parametrize("getter", ["get_cluster_nodes_group", "get_nodes_group",
                                    "get_topology_manager", "get_remote_service",
                                    "get_cache_manager"])
def test_getters_of_queued_tiers_raise(client, getter):
    """The tiers still queued raise naming their ROADMAP item; the nodes
    groups arrived with observability.py and ping the client's device; the
    remote service and the cache manager arrived with services/; the
    topology manager with the cluster tier (it polls the client's device).
    No getter of the client raises any more."""
    if getter == "get_topology_manager":
        from redisson_tpu_torch.parallel.topology import TopologyManager

        tm = client.get_topology_manager()
        assert isinstance(tm, TopologyManager)
        assert tm.live_nodes() == [str(client.device)] and not tm.scan_once()
        return
    if getter in ("get_cluster_nodes_group", "get_nodes_group"):
        from redisson_tpu_torch.observability import NodesGroup

        group = getattr(client, getter)()
        assert isinstance(group, NodesGroup) and group.ping_all()
        return
    if getter in ("get_remote_service", "get_cache_manager"):
        from redisson_tpu_torch.services import CacheManager, RRemoteService

        want = RRemoteService if getter == "get_remote_service" else CacheManager
        assert isinstance(getattr(client, getter)(), want)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        getattr(client, getter)()


def test_codecs_match_jax():
    from redisson_tpu import codecs as jcodecs
    from redisson_tpu_torch import codecs

    assert sorted(codecs._REGISTRY) == sorted(jcodecs._REGISTRY)
    values = [{"a": [1, 2.5, None]}, "text", 12, [True, "x"]]
    for name in sorted(codecs._REGISTRY):
        try:
            jc = jcodecs.get_codec(name)
        except ValueError:
            with pytest.raises(ValueError, match="optional package"):
                codecs.get_codec(name)
            continue
        tc = codecs.get_codec(name)
        for v in values:
            try:
                want = jc.encode(v)
            except (TypeError, ValueError):
                continue
            assert tc.encode(v) == want, (name, v)
            assert tc.decode(want) == jc.decode(want), (name, v)
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("nope")


def test_lease_lock_is_not_renewed_by_a_stale_watchdog_entry(client):
    """What made `test_lock__expire_releases` fail under load: an earlier
    test's watchdog registration for the same lock name and owner (the
    test thread) outlived the flushed key, and a renewal tick landing
    inside the new 0.5 s lease stretched it to 30 s, so the waiter timed
    out. An explicit lease now drops such a registration."""
    lock = client.get_lock("lock")
    lock.lock()  # watchdog-renewed hold
    owner = lock._owner()
    assert ("lock", owner) in client._watchdog._entries
    client.get_keys().flushall()  # the key goes, the registration stays
    lock.lock(lease_time_s=0.5)
    assert ("lock", owner) not in client._watchdog._entries
    # the renewal tick the watchdog would run now: nothing to renew
    for name, own in list(client._watchdog._entries):
        client._executor.execute_sync(name, "lock_renew",
                                      {"owner": own, "lease_ms": 30_000})
    t0 = time.monotonic()
    acquired = []

    def worker():
        other = client.get_lock("lock")
        other.lock()
        acquired.append(time.monotonic() - t0)
        other.unlock()

    import threading

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=5)
    assert acquired and acquired[0] < 2.0


def test_lease_lock_is_not_renewed_by_a_renewal_in_flight(client, monkeypatch):
    """The same race one step later, as it failed under load: the watchdog
    had already taken the old registration for a renewal (woken by the
    hold's register) when the explicit lease was set, and the renewal
    landed after it. A renewal now holds the watchdog's lock and the
    lease's unregister waits for it, so the lease set after it stays
    0.5 s."""
    import threading

    ex = client._executor
    real = ex.execute_sync
    in_flight = threading.Event()

    def slow_renewal(target, kind, *args, **kwargs):
        if kind == "lock_renew" and target == "lock":
            in_flight.set()
            time.sleep(0.3)
        return real(target, kind, *args, **kwargs)

    monkeypatch.setattr(ex, "execute_sync", slow_renewal)
    lock = client.get_lock("lock")
    lock.lock()  # registers: the watchdog wakes and renews at once
    assert in_flight.wait(5)
    client.get_keys().flushall()  # the key goes while the renewal sleeps
    lock.lock(lease_time_s=0.5)
    t0 = time.monotonic()
    acquired = []

    def worker():
        other = client.get_lock("lock")
        other.lock()
        acquired.append(time.monotonic() - t0)
        other.unlock()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=5)
    assert acquired and acquired[0] < 2.0
