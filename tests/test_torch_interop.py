"""interop/ of the port on the CPU (the connection tier and the durability
tier): the JAX package's corpora run against the port, then the port held
against the JAX package.

The corpora tests/test_interop.py and tests/test_hll_redis_compat.py run
unchanged through `port_corpus`: each test function (and each helper of its
module) is rebound to globals in which every name the corpus took from the
JAX package is the port's object of the same module path and name, and
every import it makes at run time of `redisson_tpu.<module>` loads
`redisson_tpu_torch.<module>` (JAX itself, and a JAX module the port does
not have, raise ImportError). The corpora's client fixtures are port
clients on `Config().use_cuda(device="cpu")`. A test whose body needs what
the port does not have (the JAX client class and its Config, JAX's device
arrays) is in `EXCLUDED` with its reason, and has a counterpart here.

Against the JAX package, on seeded numpy inputs:

1. `hyll` encode, decode and estimate, `murmur2_64a` and `fold_redis`
   equal JAX's byte for byte and value for value;
2. one seeded command stream to a JAX `EmbeddedRedis` and to the port's
   gives equal reply bytes (`DIFFERING` lists what may differ);
3. the flush commands of the same state equal JAX's byte for byte;
4. state carried across both ways: a JAX client flushes into the port's
   server and a port client loads it, and the other way round.

The port's own rules: an imported tensor never aliases the decoded buffer;
a create / shutdown pair with a periodic flusher leaks no thread; the
server's PFADD raises without the host library (no Python fallback).
"""

import builtins
import importlib
import socket
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.interop import hyll as jhyll
from redisson_tpu.interop.durability import DurabilityManager as JDurability
from redisson_tpu.interop.fake_server import EmbeddedRedis as JEmbeddedRedis
from redisson_tpu_torch import native
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config, CudaConfig, RedisConfig
from redisson_tpu_torch.interop import hyll
from redisson_tpu_torch.interop.durability import DurabilityManager
from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
from redisson_tpu_torch.interop.resp_client import SyncRespClient
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.replica.manager import replica_engine_config
from redisson_tpu_torch.wire import proto
from tests import test_hll_redis_compat, test_interop

# ---------------------------------------------------------------------------
# The corpus runner (also used by test_torch_mini_lua / _redis_topology)
# ---------------------------------------------------------------------------

#: JAX package modules a corpus may reach, each with a counterpart of the
#: same path in the port
PORTED = ("redisson_tpu.interop", "redisson_tpu.native", "redisson_tpu.ops",
          "redisson_tpu.wire", "redisson_tpu.checkpoint", "redisson_tpu.store")


def _ported(name: str, extra=()) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in PORTED + tuple(extra))


def _port_path(name: str) -> str:
    return "redisson_tpu_torch" + name[len("redisson_tpu"):]


class _AliasModule(types.ModuleType):
    """A port module seen through a corpus's names: `aliases` maps a JAX
    name the port spells differently (RedissonTPU) to the port's object."""

    def __init__(self, module, aliases):
        super().__init__(module.__name__)
        self._module = module
        self._aliases = aliases

    def __getattr__(self, attr):
        if attr in self._aliases:
            return self._aliases[attr]
        return getattr(self._module, attr)


def _make_import(extra=(), aliases=None):
    """`__import__` of a rebound corpus: JAX package modules (PORTED plus
    `extra`) load their port counterparts, seen through `aliases` (JAX
    module path -> {JAX name: port object}); JAX itself and an unported
    module raise ImportError."""
    aliases = aliases or {}

    def port_import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0:
            if name == "jax" or name.startswith("jax."):
                raise ImportError(
                    f"a corpus test run against the port imports {name}")
            if name == "redisson_tpu" or name.startswith("redisson_tpu."):
                wanted = ([f"{name}.{f}" for f in fromlist]
                          if name == "redisson_tpu" else [name])
                missing = [w for w in wanted if not _ported(w, extra)]
                if missing:
                    raise ImportError(f"{missing} has no counterpart in the port")
                if fromlist and name in aliases:
                    builtins.__import__(_port_path(name), globals, locals,
                                        fromlist, level)
                    return _AliasModule(
                        importlib.import_module(_port_path(name)),
                        aliases[name])
                name = _port_path(name)
        return builtins.__import__(name, globals, locals, fromlist, level)

    return port_import


_port_import = _make_import()


class Unported:
    """Stands for a name the corpus took from an unported JAX module: any
    use fails the test that reached it."""

    def __init__(self, what: str):
        self._what = what

    def __getattr__(self, attr):
        raise AssertionError(f"{self._what} has no counterpart in the port")

    def __call__(self, *a, **kw):
        raise AssertionError(f"{self._what} has no counterpart in the port")


def _port_value(value, extra=(), aliases=None):
    """The port's object for one value of a corpus module's namespace (or
    the value itself when it does not come from the JAX package)."""
    aliases = aliases or {}
    if isinstance(value, types.ModuleType):
        name = value.__name__
        if name == "redisson_tpu" or name.startswith("redisson_tpu."):
            return (importlib.import_module(_port_path(name))
                    if _ported(name, extra) else Unported(name))
        if name == "jax" or name.startswith("jax."):
            return Unported(name)
        return value
    mod = getattr(value, "__module__", None)
    if (isinstance(mod, str) and mod.startswith("redisson_tpu.")
            and (isinstance(value, type) or callable(value))):
        if not _ported(mod, extra):
            return Unported(f"{mod}.{getattr(value, '__qualname__', value)}")
        alias = aliases.get(mod, {}).get(value.__qualname__)
        if alias is not None:
            return alias
        obj = importlib.import_module(_port_path(mod))
        for part in value.__qualname__.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                return Unported(f"{mod}.{value.__qualname__}")
        return obj
    return value


def _rebind(fn, ns):
    new = types.FunctionType(fn.__code__, ns, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__dict__.update(fn.__dict__)  # pytest marks
    new.__doc__ = fn.__doc__
    new.__qualname__ = fn.__qualname__
    return new


def _code_names(code) -> set:
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


def port_corpus(mod, excluded, prefix, extra=(), aliases=None,
                overrides=None):
    """{`test_<prefix>__<name>`: test rebound to the port} for every test
    of `mod` not in `excluded`; raises if an imported test names something
    the port does not have (it belongs in `excluded`). `extra` adds JAX
    package modules to PORTED for this corpus, and `aliases` (JAX module
    path -> {JAX name: port object}) names what the port spells
    differently, such as the client class. `overrides` replaces module
    helpers the tests call (a client factory on the CPU), as a redefined
    fixture replaces a corpus fixture. A `Test<Name>` class comes out as
    `Test_<prefix>__<Name>` with its methods rebound; `excluded` names one
    of its methods as `Test<Name>::test_<name>`."""
    ns = {}
    for key, value in vars(mod).items():
        ns[key] = _port_value(value, extra, aliases)
    ns["__builtins__"] = dict(vars(builtins),
                              __import__=_make_import(extra, aliases))
    for key, value in vars(mod).items():
        if isinstance(value, types.FunctionType) and value.__module__ == mod.__name__:
            ns[key] = _rebind(value, ns)
        elif isinstance(value, type) and value.__module__ == mod.__name__:
            body = {k: (_rebind(v, ns) if isinstance(v, types.FunctionType) else v)
                    for k, v in vars(value).items()
                    if k not in ("__dict__", "__weakref__")}
            ns[key] = type(value.__name__, value.__bases__, body)
    ns.update(overrides or {})
    unported = {k for k, v in ns.items() if isinstance(v, Unported)}

    def check(key, fn):
        used = _code_names(fn.__code__) & unported
        if used:
            raise AssertionError(f"{mod.__name__}::{key} needs {sorted(used)}; "
                                 "list it in EXCLUDED")

    out = {}
    for key, value in vars(mod).items():
        if (key.startswith("Test") and isinstance(value, type)
                and value.__module__ == mod.__name__):
            cls = ns[key]
            for name, fn in list(vars(cls).items()):
                if not name.startswith("test_"):
                    continue
                if f"{key}::{name}" in excluded:
                    delattr(cls, name)
                else:
                    check(f"{key}::{name}", fn)
            out[f"Test_{prefix}__{key[len('Test'):]}"] = cls
            continue
        if not key.startswith("test_") or not isinstance(value, types.FunctionType):
            continue
        if key in excluded:
            continue
        check(key, value)
        out[f"test_{prefix}__{key[len('test_'):]}"] = ns[key]
    return out


def corpus_tests(mod) -> set:
    """The corpus's tests: `test_<name>` functions, and `Class::test_<name>`
    for the methods of its `Test*` classes."""
    names = set()
    for k, v in vars(mod).items():
        if k.startswith("test_") and isinstance(v, types.FunctionType):
            names.add(k)
        elif (k.startswith("Test") and isinstance(v, type)
              and v.__module__ == mod.__name__):
            names |= {f"{k}::{m}" for m in vars(v) if m.startswith("test_")}
    return names


# ---------------------------------------------------------------------------
# The corpora
# ---------------------------------------------------------------------------

#: tests of tests/test_interop.py with no counterpart run unchanged, and why
EXCLUDED_INTEROP = {
    "test_hyll_blob_matches_native_fold_estimate":
        "counts with JAX's ops.hll on a jax array; see "
        "test_port_hyll_blob_matches_native_fold_estimate",
    "test_client_facade_durability_wiring":
        "builds the JAX client with use_local(); see "
        "test_port_client_facade_durability_wiring",
    "test_config_roundtrip_with_redis_tier":
        "uses JAX's Config with use_tpu() and mode() == 'tpu'; see "
        "test_port_config_roundtrip_with_redis_tier",
    "test_classic_bloom_import_clears_stale_blocked_flag":
        "builds a second JAX client and a JAX SketchStore; see "
        "test_port_classic_bloom_import_clears_stale_blocked_flag",
}

#: tests of tests/test_hll_redis_compat.py with no counterpart run
#: unchanged, and why
EXCLUDED_COMPAT = {
    "test_vector_murmur64a_matches_independent_scalar":
        "reads JAX's (hi, lo) hash pair; see "
        "test_port_vector_murmur64a_matches_independent_scalar",
    "test_redis_family_client_matches_fixture_registers_exactly":
        "builds the JAX client with use_tpu(); see "
        "test_port_redis_family_client_matches_fixture_registers_exactly",
    "test_redis_family_int_path_matches_bytes_path_contract":
        "builds the JAX client with use_tpu(); see "
        "test_port_redis_family_int_path_matches_bytes_path_contract",
    "test_import_guard_cross_family":
        "builds the JAX client with use_tpu(); see "
        "test_port_import_guard_cross_family",
    "test_m3_flush_blob_is_tagged":
        "builds the JAX client with use_tpu(); see test_port_m3_flush_blob_is_tagged",
    "test_mixed_writer_with_real_redis_semantics":
        "builds the JAX client with use_tpu(); see "
        "test_port_mixed_writer_with_real_redis_semantics",
}

#: the corpus's JAX modules beyond PORTED, and the names the port spells
#: differently (the client class)
CLIENT_EXTRA = ("redisson_tpu.client", "redisson_tpu.config",
                "redisson_tpu.executor")
CLIENT_ALIASES = {"redisson_tpu.client": {"RedissonTPU": RedissonTorch}}


class CpuConfig(Config):
    """A corpus's `Config` on the CPU: the compute section is
    `use_cuda(device="cpu")` unless the corpus passes one, and the JAX
    spellings of that section (`tpu=`, `use_tpu()`) name it."""

    def __init__(self, *args, tpu=None, **kwargs):
        super().__init__(*args, **kwargs)
        if tpu is not None:
            self.cuda = tpu
        elif self.cuda is None and self.pod is None:
            self.cuda = CudaConfig(device="cpu")

    def use_tpu(self, **overrides) -> CudaConfig:
        return self.use_cuda(**overrides)


def cpu_tpu_config(**overrides) -> CudaConfig:
    """A corpus's `TpuConfig(...)` on the CPU."""
    return CudaConfig(**{"device": "cpu", **overrides})


class CpuRedisson(RedissonTorch):
    """A corpus's `RedissonTPU`: `create()` with no config is a client on
    the CPU (the port's default is the card)."""

    @classmethod
    def create(cls, config=None):
        return RedissonTorch.create(CpuConfig() if config is None else config)


#: the corpora's client class and config on the CPU
CPU_ALIASES = {"redisson_tpu.client": {"RedissonTPU": CpuRedisson},
               "redisson_tpu.config": {"Config": CpuConfig,
                                       "TpuConfig": cpu_tpu_config}}

_CORPUS = {**port_corpus(test_interop, EXCLUDED_INTEROP, "interop",
                         CLIENT_EXTRA, CLIENT_ALIASES),
           **port_corpus(test_hll_redis_compat, EXCLUDED_COMPAT, "hllcompat")}
globals().update(_CORPUS)


def cpu_config(**cuda) -> Config:
    cfg = Config()
    cfg.use_cuda(device="cpu", **cuda)
    return cfg


@pytest.fixture()
def local_client():
    c = RedissonTorch.create(cpu_config())
    yield c
    c.shutdown()


def test_corpora_were_imported():
    for mod, excluded, prefix in ((test_interop, EXCLUDED_INTEROP, "interop"),
                                  (test_hll_redis_compat, EXCLUDED_COMPAT,
                                   "hllcompat")):
        names = corpus_tests(mod)
        assert set(excluded) <= names
        assert {f"test_{prefix}__{n[5:]}" for n in names - set(excluded)} <= set(_CORPUS)
    assert len(corpus_tests(test_interop)) == 31
    assert len(corpus_tests(test_hll_redis_compat)) == 8


def test_corpus_runner_maps_to_the_port():
    fn = _CORPUS["test_interop__sync_client_facade"]
    assert fn.__globals__["EmbeddedRedis"] is EmbeddedRedis
    assert fn.__globals__["SyncRespClient"] is SyncRespClient
    assert fn.__globals__["native"] is native
    assert fn.__globals__["hyll"] is hyll
    imp = fn.__globals__["__builtins__"]["__import__"]
    assert imp("redisson_tpu.interop.fake_server", fromlist=["x"]).EmbeddedRedis \
        is EmbeddedRedis
    with pytest.raises(ImportError):
        imp("jax.numpy")
    with pytest.raises(ImportError):
        imp("redisson_tpu.tpu_boot")
    # The client class is the one name the port spells differently.
    assert imp("redisson_tpu.client", fromlist=["RedissonTPU"]).RedissonTPU \
        is RedissonTorch


# ---------------------------------------------------------------------------
# Counterparts of the excluded corpus tests
# ---------------------------------------------------------------------------


def test_port_hyll_blob_matches_native_fold_estimate():
    regs = np.zeros(16384, np.uint8)
    native.hll_fold([b"k%d" % i for i in range(50000)], regs)
    back = hyll.decode(hyll.encode_dense(regs))
    est = float(hll_ops.count(torch.from_numpy(back.astype(np.int32))))
    assert abs(est - 50000) / 50000 < 0.02


def test_port_client_facade_durability_wiring():
    with EmbeddedRedis() as er:
        cfg = cpu_config()
        rc = cfg.use_redis()
        rc.address = f"redis://127.0.0.1:{er.port}"
        cfg.flush_interval_s = 0.05
        client = RedissonTorch.create(cfg)
        try:
            assert client.durability is not None
            h = client.get_hyper_log_log("w:hll")
            h.add_all([b"k%d" % i for i in range(5000)])
            est = h.count()
            assert client.flush_to_redis() >= 1
        finally:
            client.shutdown()  # also runs the final flush
        with SyncRespClient(port=er.port) as probe:
            got = probe.execute("PFCOUNT", "w:hll")
            assert abs(got - est) / max(est, 1) < 0.01


def test_port_config_roundtrip_with_redis_tier():
    cfg = Config()
    cfg.use_cuda()
    r = cfg.use_redis()
    assert cfg.use_redis() is r
    r.address = "redis://10.0.0.1:6380"
    r.password = "pw"
    r.slave_addresses = ["10.0.0.2:6380"]
    r.slave_weights = {"10.0.0.2:6380": 3}
    cfg.flush_interval_s = 12.5
    back = Config.from_json(cfg.to_json())
    assert back.redis == r
    assert back.flush_interval_s == 12.5
    assert back.mode() == "cuda"
    assert Config().mode() == "cuda"
    only = Config()
    only.use_redis()
    assert only.mode() == "redis"


def test_port_classic_bloom_import_clears_stale_blocked_flag(local_client):
    bf = local_client.get_bloom_filter("d:swap")
    bf.try_init(expected_insertions=5000, false_probability=0.01, blocked=True)
    with EmbeddedRedis() as er:
        with SyncRespClient(port=er.port) as rc:
            dm = DurabilityManager(local_client._store, rc)
            c2 = RedissonTorch.create(cpu_config())
            try:
                src = c2.get_bloom_filter("d:swap")
                src.try_init(expected_insertions=5000, false_probability=0.01)
                src.add_all([b"c%d" % i for i in range(1000)])
                DurabilityManager(c2._store, rc).flush(["d:swap"])
            finally:
                c2.shutdown()
            assert dm.load_bloom("d:swap")
            bf2 = local_client.get_bloom_filter("d:swap")
            assert bf2.is_blocked() is False
            assert all(bf2.contains_all([b"c%d" % i for i in range(1000)]))


FIX = test_hll_redis_compat.FIX
FIX_META = test_hll_redis_compat.FIX_META
KEYS = test_hll_redis_compat.KEYS


def _redis_client(**redis):
    cfg = cpu_config(hll_hash="redis")
    for k, v in redis.items():
        setattr(cfg.use_redis(), k, v)
    return RedissonTorch.create(cfg)


def test_port_vector_murmur64a_matches_independent_scalar():
    from redisson_tpu_torch.ops import hashing
    from tests import golden

    rng = np.random.default_rng(42)
    raw = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(0, 40, 64)]
    data = np.zeros((len(raw), 48), np.uint8)
    lengths = np.zeros(len(raw), np.int32)
    for i, k in enumerate(raw):
        data[i, :len(k)] = np.frombuffer(k, np.uint8)
        lengths[i] = len(k)
    got = hashing.murmur2_64a(torch.from_numpy(data), torch.from_numpy(lengths))
    got64 = got.numpy().view(np.uint64)
    want = np.array([golden.murmur2_64a(k) for k in raw], np.uint64)
    assert (got64 == want).all()
    assert all(hyll.murmur2_64a(k) == int(w) for k, w in zip(raw, want))


def test_port_redis_family_client_matches_fixture_registers_exactly():
    c = _redis_client()
    try:
        h = c.get_hyper_log_log("compat:fix")
        h.add_all(KEYS)
        regs, _version = c._executor.execute_sync("compat:fix", "hll_export", None)
        want = hyll.decode(open(FIX, "rb").read())
        assert np.array_equal(np.asarray(regs, np.uint8), want)
        assert abs(h.count() - len(KEYS)) / len(KEYS) < 0.02
    finally:
        c.shutdown()


def test_port_redis_family_int_path_matches_bytes_path_contract():
    ints = np.arange(5000, dtype=np.uint64)
    c = _redis_client()
    try:
        c.get_hyper_log_log("compat:int").add_ints(ints)
        c.get_hyper_log_log("compat:bytes").add_all(
            [int(v).to_bytes(8, "little") for v in ints])
        ra, _ = c._executor.execute_sync("compat:int", "hll_export", None)
        rb, _ = c._executor.execute_sync("compat:bytes", "hll_export", None)
        assert np.array_equal(ra, rb)
    finally:
        c.shutdown()


def test_port_import_guard_cross_family():
    with EmbeddedRedis() as er:
        cfg = cpu_config()  # murmur3 default
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        try:
            c.durability.client.execute("SET", "foreign", open(FIX, "rb").read())
            with pytest.warns(UserWarning, match="hash-family"):
                assert c.durability.load_hll("foreign")
            est = c.get_hyper_log_log("foreign").count()
            assert abs(est - FIX_META["true_count"]) / FIX_META["true_count"] < 0.02
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                assert c.durability.load_hll("foreign", force=True)
        finally:
            c.shutdown()
    with EmbeddedRedis(hll_hash="redis") as er:
        c = _redis_client(address=f"redis://127.0.0.1:{er.port}")
        try:
            regs = np.zeros(hyll.M, np.uint8)
            regs[3] = 2
            c.durability.client.execute(
                "SET", "m3blob", hyll.encode_dense(regs, family="m3"))
            with pytest.raises(ValueError, match="framework-murmur3"):
                c.durability.load_hll("m3blob")
            assert c.durability.load_hll("m3blob", force=True)
        finally:
            c.shutdown()


def test_port_m3_flush_blob_is_tagged():
    with EmbeddedRedis() as er:
        cfg = cpu_config()
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        try:
            c.get_hyper_log_log("tag:me").add_ints(np.arange(100, dtype=np.uint64))
            c.flush_to_redis(["tag:me"])
            blob = bytes(c.durability.client.execute("GET", "tag:me"))
            assert hyll.blob_family(blob) == "m3"
            assert c.durability.load_hll("tag:me")
        finally:
            c.shutdown()


def test_port_mixed_writer_with_real_redis_semantics():
    with EmbeddedRedis(hll_hash="redis") as er:
        c = _redis_client(address=f"redis://127.0.0.1:{er.port}")
        try:
            h = c.get_hyper_log_log("mix:key")
            h.add_all(KEYS[:6000])
            c.flush_to_redis(["mix:key"])
            blob = bytes(c.durability.client.execute("GET", "mix:key"))
            assert hyll.blob_family(blob) == "redis"
            c.durability.client.execute("PFADD", "mix:key", *KEYS[4000:])
            union = int(c.durability.client.execute("PFCOUNT", "mix:key"))
            assert abs(union - len(KEYS)) / len(KEYS) < 0.02, union
            assert c.durability.load_hll("mix:key")
            est = c.get_hyper_log_log("mix:key").count()
            assert abs(est - len(KEYS)) / len(KEYS) < 0.02
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------


def test_imported_state_does_not_alias_the_decoded_buffer(local_client):
    """`_put` and the bits_import path install a fresh tensor: the decoded
    arrays are views of reply bytes (read-only), and the port writes cells
    in place."""
    store = local_client._store
    with EmbeddedRedis() as er:
        with SyncRespClient(port=er.port) as rc:
            raw = np.frombuffer(bytes(range(16)), np.uint8)
            bits = np.unpackbits(raw)
            ro = bits.copy()
            ro.setflags(write=False)
            dm = DurabilityManager(store, rc)  # no executor: the store path
            dm._put("alias:ro", "bitset", ro, {"nbits": ro.size,
                                               "extent_bits": ro.size})
            t = store.get("alias:ro").state
            assert t.data_ptr() != ro.ctypes.data
            t[0] ^= 1  # writable, and the source stays as it was
            assert ro[0] == bits[0]
            rc.execute("SET", "alias:bits", raw.tobytes())
            dm2 = DurabilityManager(store, rc, executor=local_client._executor,
                                    pod_backend=local_client._pod_backend())
            assert dm2.load_bitset("alias:bits")
            local_client.get_bit_set("alias:bits").set(0, False)
            local_client.get_bit_set("alias:bits").set(1)
            assert rc.execute("GET", "alias:bits") == raw.tobytes()
            cells = store.get("alias:bits").state
            assert cells.dtype == torch.uint8 and cells.is_contiguous()
            assert int(cells[1]) == 1


def test_create_shutdown_with_periodic_flush_leaks_no_thread():
    with EmbeddedRedis() as er:
        before = {t.ident for t in threading.enumerate()}
        for _ in range(2):
            cfg = cpu_config()
            cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
            cfg.flush_interval_s = 0.05
            c = RedissonTorch.create(cfg)
            assert c.durability._timer is not None
            c.get_hyper_log_log("leak:h").add_all([b"a", b"b"])
            time.sleep(0.12)
            c.shutdown()
        deadline = time.time() + 5
        while time.time() < deadline:
            leaked = [t.name for t in threading.enumerate()
                      if t.ident not in before]
            if not leaked:
                break
            time.sleep(0.05)
        assert not leaked, leaked
        with SyncRespClient(port=er.port) as rc:
            assert rc.execute("EXISTS", "leak:h") == 1


def test_server_pfadd_raises_without_the_host_library(monkeypatch):
    with EmbeddedRedis() as er:
        with SyncRespClient(port=er.port) as rc:
            assert rc.execute("PFADD", "lib:h", "a") == 1
        # The request is encoded, and the connection's parser built, while
        # the library is there; then the server's fold finds none.
        frame = proto.resp_encode("PFADD", "lib:h", "b")
        with socket.create_connection(("127.0.0.1", er.port), timeout=5) as s:
            s.settimeout(5)
            s.sendall(proto.resp_encode("PING"))
            assert s.recv(64) == b"+PONG\r\n"
            monkeypatch.setattr(native, "_load", lambda: None)
            s.sendall(frame)
            reply = s.recv(256)
        assert reply.startswith(b"-ERR host fold library unavailable"), reply
    with pytest.raises(RuntimeError, match="host fold library"):
        native.hll_fold([b"x"], np.zeros(16384, np.uint8))


def test_replica_config_drops_the_redis_tier():
    cfg = cpu_config()
    cfg.use_redis().address = "redis://127.0.0.1:7000"
    cfg.flush_interval_s = 3.0
    rep = replica_engine_config(cfg)
    assert rep.redis is None and rep.flush_interval_s == 0.0
    assert cfg.redis is not None and cfg.flush_interval_s == 3.0


def test_redis_config_fields_equal_jax():
    from dataclasses import fields

    from redisson_tpu.config import RedisConfig as JRedisConfig

    assert [(f.name, f.default, f.default_factory) for f in fields(RedisConfig)] \
        == [(f.name, f.default, f.default_factory) for f in fields(JRedisConfig)]


def test_nodes_group_lists_the_redis_node():
    with EmbeddedRedis() as er:
        cfg = cpu_config()
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        try:
            nodes = c.get_nodes_group().nodes()
            assert [n.kind for n in nodes] == ["device", "redis"]
            assert nodes[1].ident == f"127.0.0.1:{er.port}"
            assert c.get_nodes_group().ping_all()
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _seeded_regs(seed, hi=52, n=16384):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hyll_codec_equals_jax(seed):
    regs = _seeded_regs(seed)
    for fam in ("m3", "redis"):
        assert hyll.encode_dense(regs, family=fam) == jhyll.encode_dense(regs, family=fam)
    assert hyll.encode_dense(regs, cached_card=seed * 77) == \
        jhyll.encode_dense(regs, cached_card=seed * 77)
    small = _seeded_regs(seed + 10, hi=33)
    small[np.random.default_rng(seed).random(16384) < 0.7] = 0
    assert hyll.encode_sparse(small) == jhyll.encode_sparse(small)
    for blob in (hyll.encode_dense(regs), hyll.encode_sparse(small)):
        a, b = hyll.decode(blob), jhyll.decode(blob)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert hyll.blob_family(blob) == jhyll.blob_family(blob)
        assert hyll.cached_cardinality(blob) == jhyll.cached_cardinality(blob)
    for r in (regs, small, np.zeros(16384, np.uint8)):
        assert hyll.estimate(r) == jhyll.estimate(r)


def test_murmur2_and_fold_redis_equal_jax():
    rng = np.random.default_rng(7)
    keys = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 33, 3000)]
    for k in keys[:300]:
        assert hyll.murmur2_64a(k) == jhyll.murmur2_64a(k)
        assert hyll.murmur2_64a(k, 12345) == jhyll.murmur2_64a(k, 12345)
    a, b = np.zeros(16384, np.uint8), np.zeros(16384, np.uint8)
    hyll.fold_redis(keys, a)
    jhyll.fold_redis(keys, b)
    assert np.array_equal(a, b) and a.any()


#: reply fields that may differ between the JAX package's server and the
#: port's (none of the stream below carries one: no run id, no port, no
#: clock-dependent TTL is read back)
DIFFERING = {}


def _command_stream(seed):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(12)]
    cmds = [("PING",), ("ECHO", "hi"), ("DBSIZE",), ("NOSUCHCMD", "x")]
    for _ in range(400):
        k = keys[int(rng.integers(len(keys)))]
        r = int(rng.integers(0, 1000))
        pick = int(rng.integers(0, 22))
        cmds.append([
            ("SET", k, f"v{r}"), ("GET", k), ("DEL", k), ("EXISTS", k, "nope"),
            ("APPEND", k, f"a{r}"), ("STRLEN", k), ("INCRBY", "ctr", r),
            ("HSET", "h" + k, f"f{r % 7}", r), ("HGETALL", "h" + k),
            ("HDEL", "h" + k, f"f{r % 7}"), ("SETBIT", "b" + k, r, r & 1),
            ("GETBIT", "b" + k, r), ("BITCOUNT", "b" + k),
            ("PFADD", "p" + k, *[f"e{r + j}" for j in range(r % 9)]),
            ("PFCOUNT", "p" + k, "p" + keys[0]),
            ("PFMERGE", "pm", "p" + k, "p" + keys[1]),
            ("LPUSH", "l" + k, r), ("RPOP", "l" + k), ("SADD", "s" + k, r % 5),
            ("SMEMBERS", "s" + k), ("ZADD", "z" + k, r, f"m{r % 4}"),
            ("TYPE", k),
        ][pick])
    cmds += [("INFO",), ("INFO", "replication"),
             ("EVAL", "return redis.call('get', KEYS[1])", 1, keys[0]),
             ("KEYS", "p*"), ("DBSIZE",), ("FLUSHALL",), ("DBSIZE",)]
    return cmds


def _raw_replies(port, cmds):
    """Each command's reply frame bytes, exactly as the server wrote them
    (one command in flight at a time, so the bytes read until the parser
    completes a frame are that command's reply)."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.settimeout(10)
        parser = proto.RespParser()
        try:
            for cmd in cmds:
                s.sendall(proto.resp_encode(*cmd))
                buf = b""
                while True:
                    chunk = s.recv(1 << 16)
                    assert chunk, "server closed the connection"
                    buf += chunk
                    if parser.feed(chunk):
                        break
                out.append(buf)
        finally:
            parser.close()
    return out


@pytest.mark.parametrize("hll_hash", ["murmur3", "redis"])
def test_server_reply_bytes_equal_jax(hll_hash):
    cmds = _command_stream(11)
    with EmbeddedRedis(hll_hash=hll_hash) as mine, \
            JEmbeddedRedis(hll_hash=hll_hash) as theirs:
        got = _raw_replies(mine.port, cmds)
        want = _raw_replies(theirs.port, cmds)
    assert len(got) == len(want) == len(cmds)
    for cmd, g, w in zip(cmds, got, want):
        assert g == w, (cmd, g[:80], w[:80])


def _fill(c, seed):
    """The same seeded sketches on either package's client (the facades
    share these method names)."""
    rng = np.random.default_rng(seed)
    for i in range(3):
        c.get_hyper_log_log(f"x:h{i}").add_all(
            [b"u%d" % v for v in rng.integers(0, 50_000, 4000)])
    bf = c.get_bloom_filter("x:bf")
    bf.try_init(expected_insertions=20_000, false_probability=0.02)
    bf.add_all([b"b%d" % v for v in rng.integers(0, 10**6, 3000)])
    bs = c.get_bit_set("x:bs")
    for v in rng.integers(0, 5000, 300):
        bs.set(int(v))


class _Recorder:
    """A stand-in RESP client that records the pipeline it is given."""

    def __init__(self):
        self.cmds = []

    def pipeline(self, cmds):
        self.cmds.extend(cmds)
        return [b"OK"] * len(cmds)


def _flush_bytes(dm_cls, c, hll_family):
    rec = _Recorder()
    dm = dm_cls(c._store, rec, executor=c._executor,
                pod_backend=c._pod_backend(), hll_family=hll_family)
    dm.flush(sorted(["x:h0", "x:h1", "x:h2", "x:bf", "x:bs"]))
    return proto.resp_encode_pipeline(rec.cmds)


@pytest.mark.parametrize("hll_hash", ["murmur3", "redis"])
def test_flush_commands_equal_jax(hll_hash):
    jcfg = JConfig()
    jcfg.use_tpu().hll_hash = hll_hash
    jc = RedissonTPU.create(jcfg)
    c = RedissonTorch.create(cpu_config(hll_hash=hll_hash))
    try:
        _fill(jc, 3)
        _fill(c, 3)
        fam = "m3" if hll_hash == "murmur3" else "redis"
        assert _flush_bytes(DurabilityManager, c, fam) == \
            _flush_bytes(JDurability, jc, fam)
    finally:
        c.shutdown()
        jc.shutdown()


def _state(c, names):
    out = {}
    for n in names:
        if not c._store.exists(n):  # HLLs are bank rows, not store objects
            regs, _v = c._executor.execute_sync(n, "hll_export", None)
            out[n] = ("hll", np.asarray(regs, np.uint8))
            continue
        otype, cells, meta, _v = c._executor.execute_sync(n, "bits_export", None)
        out[n] = (otype, np.asarray(cells, np.uint8)[:meta.get("extent_bits")
                                                      or len(cells)])
    return out


NAMES = ["x:h0", "x:h1", "x:h2", "x:bf", "x:bs"]


def _load_all(dm):
    for n in NAMES[:3]:
        assert dm.load_hll(n)
    assert dm.load_bloom("x:bf")
    assert dm.load_bitset("x:bs")


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n][0] == b[n][0], n
        assert np.array_equal(a[n][1], b[n][1]), n


def test_state_carried_from_jax_to_the_port():
    with EmbeddedRedis() as er:
        jcfg = JConfig()
        jcfg.use_local()
        jcfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        jc = RedissonTPU.create(jcfg)
        cfg = cpu_config()
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        try:
            _fill(jc, 5)
            assert jc.flush_to_redis(NAMES) == len(NAMES)
            _load_all(c.durability)
            _assert_same_state(_state(c, NAMES), _state(jc, NAMES))
            for i in range(3):
                assert c.get_hyper_log_log(f"x:h{i}").count() == \
                    jc.get_hyper_log_log(f"x:h{i}").count()
        finally:
            c.shutdown()
            jc.shutdown()


def test_state_carried_from_the_port_to_jax():
    with EmbeddedRedis() as er:
        cfg = cpu_config()
        cfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        c = RedissonTorch.create(cfg)
        jcfg = JConfig()
        jcfg.use_local()
        jcfg.use_redis().address = f"redis://127.0.0.1:{er.port}"
        jc = RedissonTPU.create(jcfg)
        try:
            _fill(c, 6)
            assert c.flush_to_redis(NAMES) == len(NAMES)
            _load_all(jc.durability)
            _assert_same_state(_state(jc, NAMES), _state(c, NAMES))
            for i in range(3):
                assert jc.get_hyper_log_log(f"x:h{i}").count() == \
                    c.get_hyper_log_log(f"x:h{i}").count()
        finally:
            jc.shutdown()
            c.shutdown()
