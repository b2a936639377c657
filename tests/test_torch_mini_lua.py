"""interop/mini_lua.py of the port (the EVAL subset of the embedded RESP
server): the JAX package's corpus tests/test_mini_lua.py run against the
port through `port_corpus` (see tests/test_torch_interop.py), then
`run_script` held against the JAX package's on a seeded script set.

Every test of the corpus runs: its interpreter tests against the port's
`mini_lua`, its wire tests against the port's `EmbeddedRedis` through the
port's `SyncRespClient`.
"""

import numpy as np
import pytest

from redisson_tpu.interop import mini_lua as jmini_lua
from redisson_tpu_torch.interop import mini_lua
from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
from redisson_tpu_torch.interop.resp_client import SyncRespClient
from tests import test_mini_lua
from tests.test_torch_interop import corpus_tests, port_corpus

#: tests of tests/test_mini_lua.py with no counterpart here, and why (none)
EXCLUDED = {}

_CORPUS = port_corpus(test_mini_lua, EXCLUDED, "lua")
globals().update(_CORPUS)


@pytest.fixture()
def server():
    with EmbeddedRedis() as s:
        yield s


@pytest.fixture()
def client(server):
    c = SyncRespClient(port=server.port, timeout=5.0)
    c.connect()
    yield c
    c.close()


def test_corpus_was_imported():
    assert len(corpus_tests(test_mini_lua)) == 18
    assert len(_CORPUS) == 18
    fn = _CORPUS["test_lua__tables"]
    assert fn.__globals__["mini_lua"] is mini_lua
    assert fn.__globals__["run"].__globals__ is fn.__globals__


# ---------------------------------------------------------------------------
# run_script against the JAX package's
# ---------------------------------------------------------------------------

SCRIPTS = [
    "return {KEYS[1], ARGV[1], #ARGV}",
    "local s = 0; for i = 1, tonumber(ARGV[1]) do s = s + i * i end; return s",
    "local t = {}; for i = 1, #ARGV do t[#t + 1] = ARGV[i] .. KEYS[1] end; return t",
    "return string.format('%s:%d:%f', KEYS[1], tonumber(ARGV[1]), 1.5)",
    "if tonumber(ARGV[1]) % 2 == 0 then return 'even' else return 'odd' end",
    "return redis.call('hincrby', KEYS[1], ARGV[1], 3)",
    "redis.call('set', KEYS[1], ARGV[1]); return redis.call('get', KEYS[1])",
    "local v = redis.call('get', KEYS[1]); if v == false then return -1 end; return v",
    "return math.floor(tonumber(ARGV[1]) / 7) .. '|' .. string.rep('x', 3)",
    "local t = {a = 1, b = 2}; local n = 0; for k, v in pairs(t) do n = n + v end; return n",
    "return string.sub(ARGV[1], 2, -2)",
    "return tostring(tonumber(ARGV[1]) / 4)",
    "error('bad ' .. ARGV[1])",
    "return redis.pcall('nosuch')",
    "local x = 0; repeat x = x + 3 until x > tonumber(ARGV[1]); return x",
]


class _Store:
    """A dict-backed redis.call target shared by both interpreters (the
    error type is the interpreter's own)."""

    def __init__(self, err):
        self.kv = {}
        self.err = err

    def __call__(self, args):
        name = bytes(args[0]).upper()
        if name == b"SET":
            self.kv[args[1]] = args[2]
            return {"ok": b"OK"}
        if name == b"GET":
            return self.kv.get(args[1])
        if name == b"HINCRBY":
            v = int(self.kv.get((args[1], args[2]), b"0")) + int(args[3])
            self.kv[(args[1], args[2])] = str(v).encode()
            return v
        raise self.err(b"unknown command " + name)


def _run(mod, src, keys, argv, store):
    try:
        return ("ok", mod.run_script(src.encode(), keys, argv, store))
    except mod.LuaError as e:
        return ("err", str(e))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_run_script_equals_jax(seed):
    rng = np.random.default_rng(seed)
    mine, theirs = _Store(mini_lua.LuaError), _Store(jmini_lua.LuaError)
    for _ in range(3):
        for src in SCRIPTS:
            keys = [b"k%d" % rng.integers(0, 4)]
            argv = [b"%d" % rng.integers(1, 60) for _ in range(int(rng.integers(1, 4)))]
            got = _run(mini_lua, src, keys, argv, mine)
            want = _run(jmini_lua, src, keys, argv, theirs)
            assert got == want, (src, keys, argv)
    assert mine.kv == theirs.kv
