"""The port's hashes against the JAX package's and the pure-python golden
transcriptions: bit-identical for every key width 0..W and every tail."""

import numpy as np
import pytest
import torch

from redisson_tpu.ops import hashing as jh
from redisson_tpu.ops import u64 as ju
from redisson_tpu_torch.ops import hashing as th
from redisson_tpu_torch.ops import u64 as tu
from tests import golden

W = 48
EDGE = [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]


def _byte_keys(seed: int = 7):
    rng = np.random.default_rng(seed)
    lens = list(range(W + 1)) * 2 + list(rng.integers(0, W + 1, 30))
    raw = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in lens]
    data = np.zeros((len(raw), W), np.uint8)
    lengths = np.zeros(len(raw), np.int32)
    for i, k in enumerate(raw):
        data[i, : len(k)] = np.frombuffer(k, np.uint8)
        lengths[i] = len(k)
    # Garbage past each length must not perturb the hash.
    data[np.arange(W)[None, :] >= lengths[:, None]] = 0xAB
    return raw, data, lengths


def _int_keys(seed: int = 11):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, 500, dtype=np.uint64, endpoint=False)
    return np.concatenate([np.array(EDGE, np.uint64), keys])


def _np64(x: ju.U64) -> np.ndarray:
    return ((np.asarray(x.hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(x.lo).astype(np.uint64))


def _ju64(keys: np.ndarray) -> ju.U64:
    return ju.U64(
        np.asarray((keys >> np.uint64(32)).astype(np.uint32)),
        np.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("seed", [0, 0x1234])
def test_murmur3_bytes_matches_jax_and_golden(seed):
    raw, data, lengths = _byte_keys()
    h1, h2 = th.murmur3_x64_128(torch.from_numpy(data), torch.from_numpy(lengths), seed)
    j1, j2 = jh.murmur3_x64_128(data, lengths, seed)
    want = [golden.murmur3_x64_128(k, seed) for k in raw]
    np.testing.assert_array_equal(tu.to_numpy_u64(h1), _np64(j1))
    np.testing.assert_array_equal(tu.to_numpy_u64(h2), _np64(j2))
    np.testing.assert_array_equal(tu.to_numpy_u64(h1),
                                  np.array([w[0] for w in want], np.uint64))
    np.testing.assert_array_equal(tu.to_numpy_u64(h2),
                                  np.array([w[1] for w in want], np.uint64))


@pytest.mark.parametrize("seed", [0, 0x1234])
def test_murmur3_u64_matches_jax_and_golden(seed):
    keys = _int_keys()
    h1, h2 = th.murmur3_x64_128_u64(tu.from_numpy_u64(keys), seed)
    j1, j2 = jh.murmur3_x64_128_u64(_ju64(keys), seed)
    np.testing.assert_array_equal(tu.to_numpy_u64(h1), _np64(j1))
    np.testing.assert_array_equal(tu.to_numpy_u64(h2), _np64(j2))
    want = [golden.murmur3_x64_128(int(k).to_bytes(8, "little"), seed) for k in keys]
    np.testing.assert_array_equal(tu.to_numpy_u64(h1),
                                  np.array([w[0] for w in want], np.uint64))


def test_murmur2_64a_bytes_matches_jax_and_golden():
    raw, data, lengths = _byte_keys(3)
    got = tu.to_numpy_u64(th.murmur2_64a(torch.from_numpy(data), torch.from_numpy(lengths)))
    np.testing.assert_array_equal(got, _np64(jh.murmur2_64a(data, lengths)))
    np.testing.assert_array_equal(
        got, np.array([golden.murmur2_64a(k) for k in raw], np.uint64))


def test_murmur2_64a_u64_matches_jax_and_golden():
    keys = _int_keys(5)
    got = tu.to_numpy_u64(th.murmur2_64a_u64(tu.from_numpy_u64(keys)))
    np.testing.assert_array_equal(got, _np64(jh.murmur2_64a_u64(_ju64(keys))))
    np.testing.assert_array_equal(got, np.array(
        [golden.murmur2_64a(int(k).to_bytes(8, "little")) for k in keys], np.uint64))


@pytest.mark.parametrize("n", [0, 1, 13, 31, 32, 33, 47, 63])
def test_u64_lane_ops_match_python_unsigned(n):
    keys = _int_keys(n + 1)
    x = tu.from_numpy_u64(keys)
    mask = (1 << 64) - 1
    vals = [int(k) for k in keys]
    np.testing.assert_array_equal(tu.to_numpy_u64(tu.shr(x, n)),
                                  np.array([v >> n for v in vals], np.uint64))
    np.testing.assert_array_equal(
        tu.to_numpy_u64(tu.rotl(x, n)),
        np.array([((v << n) | (v >> (64 - n))) & mask for v in vals], np.uint64))
    c = 0xC6A4A7935BD1E995 + n
    np.testing.assert_array_equal(tu.to_numpy_u64(tu.mul(x, c)),
                                  np.array([(v * c) & mask for v in vals], np.uint64))
    want_ctz = [64 if v == 0 else (v & -v).bit_length() - 1 for v in vals]
    np.testing.assert_array_equal(tu.ctz(x).numpy(), np.array(want_ctz, np.int32))


def _xx_keys(seed: int, width: int = 64):
    """Keys of every length 0..width (twice), garbage past each length."""
    rng = np.random.default_rng(seed)
    lens = np.array(list(range(width + 1)) * 2 + list(rng.integers(0, width + 1, 40)),
                    np.int32)
    data = rng.integers(0, 256, (lens.shape[0], width), dtype=np.uint8)
    data[np.arange(width)[None, :] >= lens[:, None]] = 0xCD
    return data, lens


@pytest.mark.parametrize("width", [8, 31, 64, 72])
@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, 2**64 - 1])
def test_xxhash64_matches_jax(width, seed):
    data, lens = _xx_keys(width + 3, width)
    want = _np64(jh.xxhash64(data, lens, seed))
    got = tu.to_numpy_u64(th.xxhash64(torch.from_numpy(data), torch.from_numpy(lens),
                                      seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 42, 2**63 + 1])
def test_murmur3_u32_matches_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    x = np.concatenate([np.array([0, 1, 2**31, 2**32 - 1], np.uint32),
                        rng.integers(0, 2**32, 400, dtype=np.uint64).astype(np.uint32)])
    jh1, jh2 = jh.murmur3_x64_128_u32(x, seed)
    th1, th2 = th.murmur3_x64_128_u32(torch.from_numpy(x.astype(np.int64)), seed)
    np.testing.assert_array_equal(tu.to_numpy_u64(th1), _np64(jh1))
    np.testing.assert_array_equal(tu.to_numpy_u64(th2), _np64(jh2))
    # the same 4-byte keys through the general byte-key hash
    data = x.view(np.uint8).reshape(-1, 4)
    b1, b2 = th.murmur3_x64_128(torch.from_numpy(data.copy()),
                                torch.full((x.shape[0],), 4, dtype=torch.int32), seed)
    assert torch.equal(b1, th1) and torch.equal(b2, th2)
