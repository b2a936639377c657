"""The port's host library (`redisson_tpu_torch/native.py` and its C++
sources) on the CPU: the JAX package's corpus tests/test_native.py runs
against it (hash goldens, CRC16 and key slots, the RESP codec, the HLL
folds), then the fold held against the JAX package's device path.

The corpus runs through `port_corpus` (tests/test_torch_interop.py):
its `native` is the port's. The port has no Python fallback, by design
(its folds and codec raise without the library), and three fold tests
compare against JAX device code: those are in `EXCLUDED`, with
counterparts here that hold `native.hll_fold` / `hll_fold_u64` against
the JAX function and the port's own device path on the same seeded keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from redisson_tpu import engine as jengine
from redisson_tpu.models.object import pack_u64
from redisson_tpu.ops import hll as jhll
from redisson_tpu.ops.u64 import U64
from redisson_tpu_torch import engine, native
from redisson_tpu_torch.ops import hll
from tests import test_native
from tests.test_torch_interop import corpus_tests, port_corpus

#: tests of tests/test_native.py with no counterpart run unchanged, and why
EXCLUDED = {
    "test_pyfallback_matches_golden":
        "the port has no Python fallback, by design; see "
        "test_port_no_python_fallback",
    "test_hll_fold_matches_jax_kernel":
        "folds with JAX's hll on jax arrays; see "
        "test_port_hll_fold_matches_jax_kernel",
    "test_hll_fold_estimate_sane":
        "counts with JAX's hll on a jax array; see "
        "test_port_hll_fold_estimate_sane",
    "test_hll_fold_u64_matches_device_path":
        "runs JAX's engine on jax arrays; see "
        "test_port_hll_fold_u64_matches_device_path",
}

_CORPUS = port_corpus(test_native, EXCLUDED, "native")
globals().update(_CORPUS)


def test_corpus_was_imported():
    names = corpus_tests(test_native)
    assert len(names) == 18
    assert set(EXCLUDED) <= names
    assert ({f"test_native__{k[5:]}" for k in names - set(EXCLUDED)}
            <= set(_CORPUS))
    fn = _CORPUS["test_native__murmur3_matches_golden"]
    assert fn.__globals__["native"] is native


# -- counterparts of the excluded corpus tests ---------------------------------


def test_port_no_python_fallback(monkeypatch):
    """Without the library every fold and codec call raises; nothing
    computes the answer another way. (The byte-key hashes and key slots
    are `ops.hashing` / `ops.crc16`, which need no library.)"""
    monkeypatch.setattr(native, "_load", lambda: None)
    calls = (lambda: native.hll_fold([b"k"], np.zeros(16384, np.uint8)),
             lambda: native.hll_fold_u64(np.arange(4, dtype=np.uint64),
                                         np.zeros(16384, np.uint8)),
             lambda: native.popcount(np.zeros(8, np.uint8)),
             lambda: native.resp_encode("PING"))
    for call in calls:
        with pytest.raises(RuntimeError, match="unavailable"):
            call()


def test_port_hll_fold_matches_jax_kernel():
    keys = [f"user:{i}".encode() for i in range(5000)]
    regs = np.zeros(16384, np.uint8)
    native.hll_fold(keys, regs)
    # JAX's bucket / rank and scatter over the same murmur3 hashes
    h1, _ = native.murmur3_x64_128(keys)
    hi = (h1 >> np.uint64(32)).astype(np.uint32)
    lo = (h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bucket, rank = jhll.bucket_rank(U64(jnp.asarray(hi), jnp.asarray(lo)))
    jregs = np.asarray(jhll.insert_scatter(jhll.make(), bucket, rank))
    np.testing.assert_array_equal(regs.astype(np.int32), jregs)
    # and the port's own bucket / rank and scatter
    b, r = hll.bucket_rank(torch.from_numpy(h1.view(np.int64).copy()))
    tregs = hll.insert_scatter(hll.make(device="cpu"), b, r)
    np.testing.assert_array_equal(regs.astype(np.int32), tregs.numpy())


def test_port_hll_fold_estimate_sane():
    n = 200_000
    keys = [b"k%d" % i for i in range(n)]
    regs = np.zeros(16384, np.uint8)
    native.hll_fold(keys, regs)
    est = float(hll.count(torch.from_numpy(regs.astype(np.int32))))
    assert abs(est - n) / n < 0.02
    jest = float(jhll.count(jnp.asarray(regs.astype(np.int32))))
    assert est == pytest.approx(jest, rel=1e-6)


def test_port_hll_fold_u64_matches_device_path():
    """The host u64 fold is register-identical to the port's device
    insert and to JAX's (the transfer-adaptive path swaps them freely)."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**64, size=50_000, dtype=np.uint64)
    for seed in (0, 7):
        dev, _ = engine.hll_add_packed(
            torch.zeros((16384,), dtype=torch.int32),
            torch.from_numpy(keys.view(np.int64).copy()), keys.shape[0],
            "scatter", seed)
        jdev, _ = jengine.hll_add_packed(
            jnp.zeros((16384,), jnp.int32), pack_u64(keys),
            np.int32(keys.shape[0]), "scatter", seed)
        host = np.zeros(16384, np.uint8)
        native.hll_fold_u64(keys, host, seed=seed)
        np.testing.assert_array_equal(dev.numpy().astype(np.uint8), host)
        np.testing.assert_array_equal(np.asarray(jdev).astype(np.uint8), host)
    # the packed [n, 2] uint32 layout is the same memory as uint64 [n]
    host2 = np.zeros(16384, np.uint8)
    native.hll_fold_u64(pack_u64(keys), host2, seed=0)
    ref = np.zeros(16384, np.uint8)
    native.hll_fold_u64(keys, ref, seed=0)
    np.testing.assert_array_equal(host2, ref)


def test_port_hashes_match_jax_native():
    """The batch hashes and key slots equal the JAX package's library on
    seeded random keys of every length class."""
    from redisson_tpu import native as jnative

    rng = np.random.default_rng(21)
    keys = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 80, 300)] + [b"{tag}x", b"a{}b{c}"]
    for seed in (0, 0xDEADBEEF):
        for a, b in zip(native.murmur3_x64_128(keys, seed),
                        jnative.murmur3_x64_128(keys, seed)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(native.xxhash64(keys, seed),
                                      jnative.xxhash64(keys, seed))
    np.testing.assert_array_equal(native.keyslot_batch(keys),
                                  jnative.keyslot_batch(keys))
    assert [native.crc16(k) for k in keys] == [jnative.crc16(k) for k in keys]
