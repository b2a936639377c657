"""Concurrency storms and dropped connections against the port on the
CPU: the JAX package's corpus tests/test_heavy.py runs against the port,
both its local (`[local]`, the engine on `use_cuda(device="cpu")`) and
its passthrough (`[redis]`, the port's embedded RESP server,
`interop/fake_server`) parametrizations.

The corpus runs through `port_corpus` (tests/test_torch_interop.py); its
fixtures `client` and `rclient` are redefined here on the port, as the
corpus defines them: the local client on the CPU (the port's default is
the card), the passthrough clients with no compute section.
"""

import pytest

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
from tests import test_heavy
from tests.test_torch_interop import CLIENT_ALIASES, corpus_tests, port_corpus

#: tests of tests/test_heavy.py with no counterpart run unchanged, and why
#: (none)
EXCLUDED = {}

_CORPUS = port_corpus(
    test_heavy, EXCLUDED, "heavy",
    ("redisson_tpu.client", "redisson_tpu.config"), CLIENT_ALIASES)
globals().update(_CORPUS)


def _redis_config(port: int) -> Config:
    cfg = Config()
    cfg.use_redis().address = f"redis://127.0.0.1:{port}"
    return cfg


@pytest.fixture(scope="module", params=["local", "redis"])
def client(request):
    """test_heavy.py's `client`: the engine on the CPU, or passthrough."""
    if request.param == "redis":
        with EmbeddedRedis() as er:
            c = RedissonTorch.create(_redis_config(er.port))
            try:
                yield c
            finally:
                c.shutdown()
        return
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    yield c
    c.shutdown()


@pytest.fixture()
def rclient():
    """test_heavy.py's `rclient`: passthrough with short retry timers."""
    with EmbeddedRedis() as er:
        cfg = _redis_config(er.port)
        cfg.redis.timeout_ms = 2000
        cfg.redis.retry_interval_ms = 50
        c = RedissonTorch.create(cfg)
        try:
            yield c, er
        finally:
            c.shutdown()


def test_corpus_was_imported():
    names = corpus_tests(test_heavy)
    assert len(names) == 7
    assert set(EXCLUDED) <= names
    assert {f"test_heavy__{k[5:]}" for k in names - set(EXCLUDED)} <= set(_CORPUS)
    fn = _CORPUS["test_heavy__lock_storm_counter_invariant"]
    assert fn.__globals__["RedissonTPU"] is RedissonTorch


def test_fixtures_run_the_port():
    """The local parametrization is the engine mode on the CPU; the redis
    one the passthrough mode of the port."""
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        assert c.config.mode() == "cuda" and c.config.cuda.device == "cpu"
    finally:
        c.shutdown()
    with EmbeddedRedis() as er:
        c = RedissonTorch.create(_redis_config(er.port))
        try:
            assert c.config.mode() == "redis"
        finally:
            c.shutdown()
