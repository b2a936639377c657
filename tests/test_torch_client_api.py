"""The client facade and the HLL bank of the port on the CPU: the JAX
package's corpora tests/test_client_api.py and tests/test_hll_bank.py run
against the port, then the counterparts of the tests they cannot run.

Both corpora run through `port_corpus` (tests/test_torch_interop.py) with
`CPU_ALIASES`: their `RedissonTPU`, `Config` and `TpuConfig` are the
port's client and config with the compute section `use_cuda(device="cpu")`
(the port's default is the card). The `client` fixture is redefined on
the CPU, shared across the facade corpus and flushed before each of its
tests as the corpus's own fixtures do, and fresh for each bank test as
the bank corpus's is. The class fixture `hf_client` of the hostfold tests
is redefined the same way.
"""

import numpy as np
import pytest
import torch

from redisson_tpu_torch import backend_torch, engine
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from tests import test_client_api, test_hll_bank
from tests.test_torch_interop import (CPU_ALIASES, CpuConfig, corpus_tests,
                                      cpu_tpu_config, port_corpus)

_EXTRA = ("redisson_tpu.client", "redisson_tpu.config")

#: tests of tests/test_client_api.py with no counterpart run unchanged, and
#: why
EXCLUDED_API = {
    "test_add_device_resident":
        "puts its keys on a JAX device; see test_port_add_device_resident "
        "(an int64 tensor on the client's device, the CPU here)",
    "test_add_device_larger_than_max_bucket":
        "puts its keys on a JAX device; see "
        "test_port_add_device_larger_than_max_bucket",
    "TestConfig::test_json_yaml_roundtrip":
        "reads the JAX section `tpu` of a round-tripped config; see "
        "test_port_config_json_yaml_roundtrip (the section is `cuda`)",
    "TestConfig::test_mode_exclusivity":
        "configures JAX's local and tpu modes; see "
        "test_port_mode_exclusivity (the port's cuda and pod modes)",
    "TestHostfoldIngest::test_byte_keys_roundtrip":
        "reads HOSTFOLD_MIN_KEYS from JAX's backend_tpu; see "
        "test_port_hostfold_byte_keys_roundtrip (backend_torch's)",
}

#: tests of tests/test_hll_bank.py with no counterpart run unchanged, and
#: why (none)
EXCLUDED_BANK = {}

_CORPUS = {
    **port_corpus(test_client_api, EXCLUDED_API, "client_api", _EXTRA,
                  CPU_ALIASES),
    **port_corpus(test_hll_bank, EXCLUDED_BANK, "hll_bank", _EXTRA,
                  CPU_ALIASES),
}
globals().update(_CORPUS)


@pytest.fixture(scope="module")
def _api_client():
    c = RedissonTorch.create(CpuConfig())
    yield c
    c.shutdown()


@pytest.fixture()
def client(request):
    """test_client_api.py's module client (flushed before each test) and
    test_hll_bank.py's fresh client, on the CPU."""
    if request.node.name.startswith("test_hll_bank__"):
        c = RedissonTorch.create(CpuConfig())
        yield c
        c.shutdown()
    else:
        c = request.getfixturevalue("_api_client")
        c.flushall()
        yield c


class Test_client_api__HostfoldIngest(
        _CORPUS.pop("Test_client_api__HostfoldIngest")):
    @pytest.fixture(scope="class")
    def hf_client(self):
        """The corpus's `hf_client` on the CPU (forced hostfold)."""
        c = RedissonTorch.create(Config(cuda=cpu_tpu_config(ingest="hostfold")))
        yield c
        c.shutdown()


def test_corpus_was_imported():
    for mod, excluded, prefix in ((test_client_api, EXCLUDED_API, "client_api"),
                                  (test_hll_bank, EXCLUDED_BANK, "hll_bank")):
        names = corpus_tests(mod)
        assert set(excluded) <= names
        got = {n for n in names - set(excluded) if "::" not in n}
        assert {f"test_{prefix}__{k[5:]}" for k in got} <= set(globals())
        for n in names - set(excluded):
            if "::" in n:
                cls, meth = n.split("::")
                assert hasattr(globals()[f"Test_{prefix}__{cls[4:]}"], meth)
    assert len(corpus_tests(test_client_api)) == 33
    assert len(corpus_tests(test_hll_bank)) == 12
    fn = _CORPUS["test_hll_bank__bank_grows_past_capacity"]
    assert fn.__globals__["RedissonTPU"].create.__func__.__qualname__ == (
        "CpuRedisson.create")


# -- counterparts of the excluded corpus tests ---------------------------------


def _packed(keys: np.ndarray) -> torch.Tensor:
    """uint64 keys as the int64 tensor (same bits) `add_device` takes."""
    return torch.from_numpy(keys.view(np.int64).copy())


def test_port_add_device_resident(client):
    """Device-resident ingest (add_device) matches the host packed path."""
    h = client.get_hyper_log_log("hll:dev")
    keys = np.arange(1, 50_001, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    assert h.add_device(_packed(keys)) is True
    est_dev = h.count()
    h2 = client.get_hyper_log_log("hll:host")
    h2.add_ints(keys)
    assert h2.count() == est_dev  # identical registers -> identical estimate
    # Ragged (non-bucket) device batch.
    h3 = client.get_hyper_log_log("hll:devragged")
    assert h3.add_device(_packed(keys[:1111])) is True
    assert abs(h3.count() - 1111) / 1111 < 0.05


def test_port_add_device_larger_than_max_bucket(client, monkeypatch):
    """Device batches above the chunk cap split like the host path."""
    monkeypatch.setattr(engine, "MAX_BUCKET", 1 << 12)
    h = client.get_hyper_log_log("hll:devbig")
    n = (1 << 12) * 2 + 77
    keys = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(0x2545F4914F6CDD1D)
    assert h.add_device(_packed(keys)) is True
    assert abs(h.count() - n) / n < 0.05
    h2 = client.get_hyper_log_log("hll:hostbig")
    h2.add_ints(keys)
    assert h2.count() == h.count()


def test_port_config_json_yaml_roundtrip():
    cfg = Config()
    cfg.use_cuda(device="cpu").hll_impl = "sort"
    cfg.flush_interval_s = 5.0
    back = Config.from_json(cfg.to_json())
    assert back.cuda.hll_impl == "sort" and back.cuda.device == "cpu"
    assert back.flush_interval_s == 5.0
    back2 = Config.from_yaml(cfg.to_yaml())
    assert back2.cuda.hll_impl == "sort"
    assert back2.to_dict() == back.to_dict() == cfg.to_dict()


def test_port_mode_exclusivity():
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_pod(device="cpu")
    with pytest.raises(ValueError):
        cfg.mode()


def test_port_hostfold_byte_keys_roundtrip():
    c = RedissonTorch.create(Config(cuda=cpu_tpu_config(ingest="hostfold")))
    try:
        h = c.get_hyper_log_log("hf:bytes")
        n = backend_torch.HOSTFOLD_MIN_KEYS + 5
        h.add_all([f"k{i}" for i in range(n)])
        assert abs(h.count() - n) / n < 0.03
    finally:
        c.shutdown()
