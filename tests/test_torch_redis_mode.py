"""The passthrough mode of the port (interop/backend_redis.py,
interop/bloom_redis.py, interop/coordination_redis.py and the client's
redis mode) on the CPU: the JAX package's corpora run against the port,
then the port held against the JAX package.

The corpora tests/test_redis_mode.py, tests/test_redis_coordination.py and
tests/test_script_codecs.py::test_script_redis_mode_is_server_side_lua run
unchanged through `port_corpus` (tests/test_torch_interop.py), with the
JAX client class read as `RedissonTorch`; their fixtures are redefined
here on the port's `EmbeddedRedis` and a config whose only section is
redis. A test that builds a device client with no compute section (the
port's default is the card) or with JAX's `TpuConfig` is in `EXCLUDED`
with its reason and has a counterpart here on `use_cuda(device="cpu")`.

Against the JAX package: one seeded 300-op mixed sequence through a JAX
passthrough client and a port passthrough client, each against its own
embedded server, gives equal replies, and every key's state read back by
GET / HGETALL / LRANGE / ZRANGE / SMEMBERS / PFCOUNT is equal (PFCOUNT
within rel 1e-5); the passthrough Bloom index walk equals JAX's.

The port's own rule: the passthrough client holds no device state (no
device, store or memory ledger; the MEMORY facade and checkpoints raise),
and its create / shutdown leaks no thread.
"""

import random
import threading
import time

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.interop.bloom_redis import (
    _bloom_indexes_host as j_bloom_indexes)
from redisson_tpu.interop.fake_server import EmbeddedRedis as JEmbeddedRedis
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.interop.bloom_redis import _bloom_indexes_host
from redisson_tpu_torch.interop.durability import DurabilityManager
from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
from redisson_tpu_torch.interop.resp_client import SyncRespClient
from tests import test_redis_coordination, test_redis_mode, test_script_codecs
from tests.test_torch_interop import (CLIENT_ALIASES, corpus_tests,
                                      port_corpus)

_EXTRA = ("redisson_tpu.client", "redisson_tpu.config",
          "redisson_tpu.services")

#: tests of tests/test_redis_mode.py with no counterpart run unchanged, and
#: why
EXCLUDED_MODE = {
    "test_bloom_cross_tier_bit_compatible":
        "builds its device client with RedissonTPU.create() (the port's "
        "default is the card); see test_port_bloom_cross_tier_bit_compatible",
    "test_bloom_cross_tier_with_nonzero_seed":
        "builds its device client with JAX's TpuConfig; see "
        "test_port_bloom_cross_tier_with_nonzero_seed",
}

#: tests of tests/test_redis_coordination.py with no counterpart run
#: unchanged, and why (none)
EXCLUDED_COORD = {}

#: tests of tests/test_script_codecs.py outside this corpus: only the
#: passthrough test is taken; the others drive the device mode's scripting
#: and codec matrix
EXCLUDED_SCRIPT = {
    name: "a device-mode scripting / codec test, not a passthrough one"
    for name in corpus_tests(test_script_codecs)
    if name != "test_script_redis_mode_is_server_side_lua"}

_CORPUS = {
    **port_corpus(test_redis_mode, EXCLUDED_MODE, "redis_mode", _EXTRA,
                  CLIENT_ALIASES),
    **port_corpus(test_redis_coordination, EXCLUDED_COORD, "redis_coord",
                  _EXTRA, CLIENT_ALIASES),
    **port_corpus(test_script_codecs, EXCLUDED_SCRIPT, "script", _EXTRA,
                  CLIENT_ALIASES),
}
globals().update(_CORPUS)


def redis_config(port: int, **fields) -> Config:
    cfg = Config()
    r = cfg.use_redis()
    r.address = f"redis://127.0.0.1:{port}"
    for k, v in fields.items():
        setattr(r, k, v)
    return cfg


# -- the corpora's fixtures, on the port ---------------------------------------


@pytest.fixture()
def rclient():
    with EmbeddedRedis() as er:
        c = RedissonTorch.create(redis_config(er.port))
        try:
            yield c
        finally:
            c.shutdown()


@pytest.fixture(scope="module")
def server():
    with EmbeddedRedis() as s:
        yield s


@pytest.fixture()
def client(server):
    c = RedissonTorch.create(redis_config(server.port))
    yield c
    c.get_keys().flushall()
    c.shutdown()


@pytest.fixture()
def client2(server):
    c = RedissonTorch.create(redis_config(server.port))
    yield c
    c.shutdown()


def test_corpora_were_imported():
    for mod, excluded, prefix, n in (
            (test_redis_mode, EXCLUDED_MODE, "redis_mode", 21),
            (test_redis_coordination, EXCLUDED_COORD, "redis_coord", 29)):
        names = corpus_tests(mod)
        assert len(names) == n
        assert set(excluded) <= names
        assert ({f"test_{prefix}__{k[5:]}" for k in names - set(excluded)}
                <= set(_CORPUS))
    assert "test_script__script_redis_mode_is_server_side_lua" in _CORPUS
    assert sum(k.startswith("test_script__") for k in _CORPUS) == 1
    fn = _CORPUS["test_redis_mode__bucket_over_redis"]
    assert fn.__globals__["RedissonTPU"] is RedissonTorch
    assert fn.__globals__["Config"] is Config


# -- counterparts of the excluded corpus tests ---------------------------------


def cpu_client(**cuda) -> RedissonTorch:
    cfg = Config()
    cfg.use_cuda(device="cpu", **cuda)
    return RedissonTorch.create(cfg)


def test_port_bloom_cross_tier_bit_compatible(rclient):
    local = cpu_client()
    try:
        bf = local.get_bloom_filter("rm:xt")
        bf.try_init(5000, 0.01)
        bf.add_all([f"m{i}" for i in range(500)])
        port = rclient.config.redis.address.rsplit(":", 1)[1]
        with SyncRespClient(port=int(port)) as rc:
            DurabilityManager(local._store, rc).flush(["rm:xt"])
    finally:
        local.shutdown()
    bf2 = rclient.get_bloom_filter("rm:xt")
    assert bf2.contains_all([f"m{i}" for i in range(500)]).all()
    bf2.add("extra")
    assert bf2.contains("extra")


def test_port_bloom_cross_tier_with_nonzero_seed():
    with EmbeddedRedis() as er:
        local = cpu_client(hash_seed=9)
        try:
            bf = local.get_bloom_filter("rm:seed")
            bf.try_init(3000, 0.01)
            bf.add_all([f"s{i}" for i in range(300)])
            with SyncRespClient(port=er.port) as rc:
                DurabilityManager(local._store, rc).flush(["rm:seed"])
        finally:
            local.shutdown()
        c = RedissonTorch.create(redis_config(er.port, hash_seed=9))
        try:
            assert c.get_bloom_filter("rm:seed").contains_all(
                [f"s{i}" for i in range(300)]).all()
        finally:
            c.shutdown()
        c2 = RedissonTorch.create(redis_config(er.port))  # default seed 0
        try:
            assert not c2.get_bloom_filter("rm:seed").contains_all(
                [f"s{i}" for i in range(300)]).all()
        finally:
            c2.shutdown()


# -- the port's own rules -------------------------------------------------------


def test_passthrough_holds_no_device_state(rclient, tmp_path):
    assert rclient.device is None
    assert rclient._store is None and rclient.sketch is None
    assert rclient._pod_backend() is None
    assert rclient.info()["server"]["mode"] == "redis"
    with pytest.raises(RuntimeError, match="MEMORY USAGE"):
        rclient.memory_usage("x")
    with pytest.raises(RuntimeError):
        rclient.memory_verify()
    with pytest.raises(NotImplementedError):
        rclient.load_checkpoint(str(tmp_path / "cp"))
    nodes = rclient.get_nodes_group().nodes()
    assert [n.kind for n in nodes] == ["redis"]
    assert rclient.get_nodes_group().ping_all()
    assert rclient.metrics.snapshot()["gauges"][
        "redis.blocking_pop_loss_windows"] == 0


def test_passthrough_refuses_persist(tmp_path):
    with EmbeddedRedis() as er:
        cfg = redis_config(er.port)
        cfg.use_persist(str(tmp_path / "p"))
        with pytest.raises(NotImplementedError, match="persist"):
            RedissonTorch.create(cfg)


def test_passthrough_create_shutdown_leaks_no_thread():
    with EmbeddedRedis() as er:
        before = {t.ident for t in threading.enumerate()}
        c = RedissonTorch.create(redis_config(er.port))
        lock = c.get_lock("t:lock")  # dials the subscribe connection
        lock.lock()
        lock.unlock()
        c.get_topic("t:topic").publish("x")
        c.shutdown()
        deadline = time.time() + 5
        while time.time() < deadline:
            left = {t.ident for t in threading.enumerate() if t.is_alive()}
            if left <= before:
                break
            time.sleep(0.05)
        assert left <= before


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_bloom_index_walk_equals_jax(seed):
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 70, 200)]
    for k, m in ((7, 9_585_059), (3, (1 << 31) + 12_345), (5, 1 << 32)):
        assert _bloom_indexes_host(keys, k, m, seed) == \
            j_bloom_indexes(keys, k, m, seed)


def _sequence(c, seed, n_ops=300):
    """A seeded mixed op stream over the structure, sketch and bloom
    objects; the list of every reply, in plain Python values."""
    rng = random.Random(seed)
    out = []

    def plain(v):
        if isinstance(v, np.ndarray):
            return [bool(x) if v.dtype == bool else int(x) for x in v.tolist()]
        if isinstance(v, (np.bool_, np.integer)):
            return v.item()
        if isinstance(v, (set, frozenset)):
            return sorted(v)
        return v

    bf = c.get_bloom_filter("pt:bloom")
    out.append(bf.try_init(2000, 0.01))
    for i in range(n_ops):
        k = rng.randrange(12)
        x = rng.randrange(40)
        if k == 0:
            out.append(plain(c.get_bucket(f"pt:b{x % 5}").get_and_set(x)))
        elif k == 1:
            out.append(c.get_atomic_long(f"pt:al{x % 3}").add_and_get(x))
        elif k == 2:
            out.append(c.get_map(f"pt:m{x % 3}").put(f"f{x % 7}", x))
        elif k == 3:
            out.append(c.get_map(f"pt:m{x % 3}").remove(f"f{x % 7}"))
        elif k == 4:
            out.append(c.get_list(f"pt:l{x % 2}").add(x))
        elif k == 5:
            out.append(c.get_queue(f"pt:q{x % 2}").poll())
        elif k == 6:
            out.append(c.get_scored_sorted_set("pt:z").add(float(x % 9), f"z{x}"))
        elif k == 7:
            out.append(c.get_set(f"pt:s{x % 2}").add(f"e{x % 11}"))
        elif k == 8:
            h = c.get_hyper_log_log(f"pt:h{x % 3}")
            out.append(h.add_all([b"h%d:%d" % (i, j) for j in range(x + 1)]))
        elif k == 9:
            bs = c.get_bit_set("pt:bits")
            out.append(plain(bs.set(x * 13)))
        elif k == 10:
            out.append(plain(bf.add_all([f"u{i}:{j}" for j in range(x % 5 + 1)])))
        else:
            out.append(plain(bf.contains_all([f"u{j}:0" for j in range(i, i + 4)])))
    out.append(c.get_bit_set("pt:bits").cardinality())
    out.append(bf.count())
    out.append(sorted(c.keys("pt:*")))
    return out


def _server_state(port):
    """Every key's state read back from the server: GET / HGETALL / LRANGE /
    ZRANGE WITHSCORES / SMEMBERS by type, PFCOUNT for the HLLs."""
    state = {}
    with SyncRespClient(port=port) as rc:
        for key in sorted(bytes(k).decode() for k in rc.execute("KEYS", "*")):
            t = bytes(rc.execute("TYPE", key)).decode()
            if key.startswith("pt:h"):
                state[key] = ("hll", int(rc.execute("PFCOUNT", key)))
            elif t == "string":
                state[key] = (t, bytes(rc.execute("GET", key)))
            elif t == "hash":
                pairs = [bytes(v) for v in rc.execute("HGETALL", key)]
                state[key] = (t, sorted(zip(pairs[::2], pairs[1::2])))
            elif t == "list":
                state[key] = (t, [bytes(v) for v in rc.execute("LRANGE", key, 0, -1)])
            elif t == "zset":
                state[key] = (t, [bytes(v) for v in rc.execute(
                    "ZRANGE", key, 0, -1, "WITHSCORES")])
            elif t == "set":
                state[key] = (t, sorted(bytes(v) for v in rc.execute("SMEMBERS", key)))
            else:
                state[key] = (t, None)
    return state


@pytest.mark.parametrize("seed", [3, 11])
def test_passthrough_sequence_equals_jax(seed):
    with JEmbeddedRedis() as jer, EmbeddedRedis() as er:
        jcfg = JConfig()
        jcfg.use_redis().address = f"redis://127.0.0.1:{jer.port}"
        jc = RedissonTPU.create(jcfg)
        try:
            jres = _sequence(jc, seed)
        finally:
            jc.shutdown()
        c = RedissonTorch.create(redis_config(er.port))
        try:
            res = _sequence(c, seed)
        finally:
            c.shutdown()
        assert res == jres
        jstate, state = _server_state(jer.port), _server_state(er.port)
    assert sorted(state) == sorted(jstate)
    for key, (kind, value) in state.items():
        jkind, jvalue = jstate[key]
        assert kind == jkind, key
        if kind == "hll":
            assert abs(value - jvalue) <= 1e-5 * max(jvalue, 1), key
        else:
            assert value == jvalue, key
