"""The port's delta ingest against the JAX package on the CPU: the host fold
library (`redisson_tpu_torch.native` against `redisson_tpu.native`), the
plane folds and their dense / sparse encode, `delta_merge` (its plain
version against the Pallas kernel in interpret mode and the engine's XLA
merge, and the CUDA kernel's row / chunk decomposition emulated in numpy
against the plain version), and the engine's delta helpers (unpack, sparse scatter, pack,
absorb). Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu import engine as je
from redisson_tpu import native as jnative
from redisson_tpu.ingest import delta as jdelta
from redisson_tpu.ops import pallas_kernels as jpk
from redisson_tpu_torch import engine as te
from redisson_tpu_torch import native as tnative
from redisson_tpu_torch.ingest import delta as tdelta
from redisson_tpu_torch.ops import kernels as ok

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="a host fold library failed to build")

M_SMALL = 95_851  # try_init(10_000, 0.01): not a multiple of 8


def _keys(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                                endpoint=False)


def _packed(keys: np.ndarray) -> np.ndarray:
    """The models' [n, 2] uint32 key layout."""
    return np.ascontiguousarray(keys).view(np.uint32).reshape(-1, 2)


def _rows(n: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, w + 1, n).astype(np.int32)
    data = rng.integers(0, 256, (n, w)).astype(np.uint8)
    data[np.arange(w)[None, :] >= lengths[:, None]] = 0
    return data, lengths


# -- the host fold library ----------------------------------------------------


@pytest.mark.parametrize("n,seed", [(0, 0), (1000, 7), (300_000, 0)])
def test_hll_fold_library_matches_jax(n, seed):
    keys = _keys(n, seed + 1)
    got, want = np.zeros(16384, np.uint8), np.zeros(16384, np.uint8)
    tnative.hll_fold_u64(keys, got, seed)  # 300,000 keys fold on 4 threads
    jnative.hll_fold_u64(keys, want, seed)
    np.testing.assert_array_equal(got, want)
    tnative.hll_fold_u64(_packed(keys), got, seed)  # the packed layout
    np.testing.assert_array_equal(got, want)
    data, lengths = _rows(500, 40, seed)
    tnative.hll_fold_rows(data, lengths, got, seed)
    jnative.hll_fold_rows(data, lengths, want, seed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k", [(M_SMALL, 7), (1 << 20, 3), (257_296_945, 7)])
def test_bloom_fold_library_matches_jax(m, k):
    keys = _keys(20_000, m % 1000)
    got, want = np.zeros((m + 7) // 8, np.uint8), np.zeros((m + 7) // 8, np.uint8)
    gn = tnative.bloom_fold_u64(keys, got, k, m, 3)
    wn = jnative.bloom_fold_u64(keys, want, k, m, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gn, wn)
    assert tnative.bloom_fold_u64(keys, got, k, m, 3, want_newly=False) is None
    data, lengths = _rows(800, 24, k)
    np.testing.assert_array_equal(tnative.bloom_fold_rows(data, lengths, got, k, m),
                                  jnative.bloom_fold_rows(data, lengths, want, k, m))
    np.testing.assert_array_equal(got, want)
    probe = np.concatenate([keys[:3000], _keys(100_000, 5)])
    np.testing.assert_array_equal(tnative.bloom_contains_u64(probe, got, k, m, 3),
                                  jnative.bloom_contains_u64(probe, want, k, m, 3))
    np.testing.assert_array_equal(tnative.bloom_contains_rows(data, lengths, got, k, m),
                                  jnative.bloom_contains_rows(data, lengths, want, k, m))
    assert tnative.popcount(got) == jnative.popcount(want) == int(
        np.unpackbits(got).sum())


def test_fold_library_refuses_wrong_layouts():
    regs = np.zeros(16384, np.uint8)
    with pytest.raises(TypeError):
        tnative.hll_fold_u64(np.arange(10, dtype=np.int64), regs)
    with pytest.raises(ValueError):
        tnative.hll_fold_u64(np.arange(10, dtype=np.uint64), np.zeros(100, np.uint8))
    with pytest.raises(ValueError):
        tnative.bloom_fold_u64(np.arange(10, dtype=np.uint64),
                               np.zeros(10, np.uint8), 3, 1000)


# -- plane folds and encode -----------------------------------------------------


def _plane_fields(p):
    return (p.kind, p.target, p.plane_bytes, p.cells, p.packed, p.nnz, p.nkeys,
            p.raw_bytes, p.link_bytes, p.sparse)


@pytest.mark.parametrize("fill", [0, 3, 1000, 9000])
def test_encode_matches_jax(fill):
    rng = np.random.default_rng(fill)
    plane = np.zeros(16384, np.uint8)
    plane[rng.integers(0, 16384, fill)] = rng.integers(1, 60, fill)
    for packed in (False, True):
        kw = dict(cells=16384 * (8 if packed else 1), packed=packed, nkeys=fill,
                  raw_bytes=8 * fill)
        got = tdelta.encode("hll_add", "t", plane, **kw)
        want = jdelta.encode("hll_add", "t", plane, **kw)
        assert _plane_fields(got) == _plane_fields(want)
        for name in ("dense", "idx", "val"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
        if got.sparse:
            assert got.idx.shape[0] & (got.idx.shape[0] - 1) == 0  # pow2


def _hll_payloads():
    data, lengths = _rows(700, 32, 4)
    return [{"packed": _packed(_keys(5000, 1))},
            {"data": data, "lengths": lengths},
            {"packed": _packed(_keys(70_000, 2))}]


def test_fold_hll_matches_jax():
    payloads = _hll_payloads()
    np.testing.assert_array_equal(tdelta.fold_hll(payloads, 9),
                                  jdelta.fold_hll(payloads, 9))


@pytest.mark.parametrize("m,k", [(M_SMALL, 7), (958_505, 7), (1 << 16, 2)])
def test_fold_bloom_matches_jax(m, k):
    payloads = _hll_payloads()
    np.testing.assert_array_equal(tdelta.fold_bloom(payloads, k, m, 1),
                                  jdelta.fold_bloom(payloads, k, m, 1))


@pytest.mark.parametrize("nbits", [1024, 1 << 20, 100_003])
def test_fold_bitset_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    payloads = [{"idx": rng.integers(0, nbits, 5000)}, {"idx": np.zeros(0, np.int64)},
                {"idx": np.array([nbits - 1, 0, 0, 7])}]
    np.testing.assert_array_equal(tdelta.fold_bitset(payloads, nbits),
                                  jdelta.fold_bitset(payloads, nbits))


def test_payload_helpers_match_jax():
    data, lengths = _rows(10, 16, 0)
    cases = [("hll_add", {"packed": _packed(_keys(33, 0))}),
             ("bloom_add", {"data": data, "lengths": lengths}),
             ("bitset_set", {"idx": np.arange(17)}),
             ("hll_add", {"device_packed": torch.zeros(4, dtype=torch.int64)}),
             ("bloom_add", {"idx": np.arange(3)}),
             ("bitset_clear", {"idx": np.arange(3)})]
    for kind, payload in cases:
        assert tdelta.foldable(kind, payload) == jdelta.foldable(kind, payload)
        if tdelta.foldable(kind, payload):
            assert tdelta.payload_nkeys(kind, payload) == jdelta.payload_nkeys(kind, payload)
            assert (tdelta.payload_raw_bytes(kind, payload)
                    == jdelta.payload_raw_bytes(kind, payload))
    assert not tdelta.foldable("hll_add", None)


# -- delta_merge ------------------------------------------------------------------


def _stacks(t: int, l: int, seed: int, high: int):
    rng = np.random.default_rng(seed)
    old = rng.integers(0, high, (t, l)).astype(np.uint8)
    delta = rng.integers(0, high, (t, l)).astype(np.uint8)
    delta[rng.random((t, l)) < 0.7] = 0
    if t > 1:
        delta[1] = np.minimum(delta[1], old[1])  # a row that cannot rise
    return old, delta


@pytest.mark.parametrize("t,l,high", [(4, 2048, 65), (3, 1024, 2), (2, 1 << 16, 2),
                                      (1, 1024, 65)])
def test_delta_merge_plain_matches_pallas_and_engine(t, l, high):
    old, delta = _stacks(t, l, t * l, high)
    jm, jc = jpk.delta_merge(jnp.asarray(old), jnp.asarray(delta))  # interpret
    xm, xc = je.delta_merge_stack(jnp.asarray(old), jnp.asarray(delta))
    told = torch.from_numpy(old.copy())
    tm, tc = ok.delta_merge_plain(told, torch.from_numpy(delta))
    assert tm.data_ptr() == told.data_ptr()  # merged in place
    for m_, c_ in ((jm, jc), (xm, xc)):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(m_))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(c_))
    if t > 1:
        assert not bool(tc[1])
    # The wrapper on a CPU tensor runs the plain version; the engine entry
    # point goes through the wrapper.
    wm, wc = te.delta_merge_stack(torch.from_numpy(old.copy()), torch.from_numpy(delta))
    np.testing.assert_array_equal(wm.numpy(), tm.numpy())
    np.testing.assert_array_equal(wc.numpy(), tc.numpy())


def _emulate_delta_merge_kernel(old, delta, owner_vecs, chunk_vecs, threads):
    """csrc/delta_merge.cu's algorithm in numpy over 16-byte vectors: rows
    of at most `owner_vecs` vectors take one block each, which writes the
    row's flag 0 or 1; longer rows are cut into `chunk_vecs`-vector chunks
    over flags cleared first, each block storing 1 where it saw a rise. A
    block steps `threads` vectors at a time, the last step ragged; a vector
    is stored when it or its sector partner (lane ^ 1) rose."""
    t, l = old.shape
    row_vecs = l // 16
    out = old.reshape(t, row_vecs, 16).copy()
    dv = delta.reshape(t, row_vecs, 16)
    owned = row_vecs <= owner_vecs
    chunk = row_vecs if owned else chunk_vecs
    chunks = -(-row_vecs // chunk)
    changed = np.full(t, 7 if owned else 0, np.uint8)  # an owned flag is written
    covered = np.zeros((t, row_vecs), np.int64)
    for block in range(t * chunks):
        row, first = divmod(block, chunks)
        first *= chunk
        last = min(first + chunk, row_vecs)
        rose_any = False
        for step in range(first, last, threads):
            v = np.arange(step, step + threads)
            inside = v < last
            vi = v[inside]
            merged = np.maximum(out[row, vi], dv[row, vi])
            rose = np.zeros(threads, bool)
            rose[inside] = (merged != out[row, vi]).any(axis=1)
            sector = rose | rose[np.arange(threads) ^ 1]
            store = vi[sector[inside]]
            out[row, store] = np.maximum(out[row, store], dv[row, store])
            covered[row, vi] += 1
            rose_any |= bool(rose.any())
        if owned:
            changed[row] = rose_any
        elif rose_any:
            changed[row] = 1
    assert (covered == 1).all()  # every vector merged exactly once
    return out.reshape(t, l), changed.astype(bool)


@pytest.mark.parametrize("t,l", [(256, 16384), (2, 16), (5, 16400), (3, 1040),
                                 (2, 1 << 17), (3, 70_000)])
def test_delta_merge_kernel_algorithm(t, l):
    """The CUDA kernel's row / chunk / step decomposition (emulated at its
    own constants and at small ones) merges every vector once and sets the
    same cells and flags as the plain version, for rows that a block owns
    and rows cut into chunks, with ragged last steps and odd row lengths."""
    old, delta = _stacks(t, l, t + l, 65)
    want_m, want_c = ok.delta_merge_plain(torch.from_numpy(old.copy()),
                                          torch.from_numpy(delta))
    configs = [(4096, 512, 256)]  # the kernel's own constants
    if t * l <= 1 << 18:
        configs += [(64, 48, 32), (1, 7, 2)]
    for owner_vecs, chunk_vecs, threads in configs:
        got_m, got_c = _emulate_delta_merge_kernel(old, delta, owner_vecs, chunk_vecs,
                                                   threads)
        np.testing.assert_array_equal(got_m, want_m.numpy())
        np.testing.assert_array_equal(got_c, want_c.numpy())


def test_delta_merge_refuses_bad_stacks():
    a = torch.zeros((2, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ok.delta_merge(a, torch.zeros((2, 512), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ok.delta_merge(a.to(torch.int32), a.to(torch.int32))


# -- the engine's delta helpers ---------------------------------------------------


@pytest.mark.parametrize("cells", [8, 13, 1024, M_SMALL])
def test_unpack_pack_absorb_match_jax(cells):
    rng = np.random.default_rng(cells)
    packed = rng.integers(0, 256, (cells + 7) // 8).astype(np.uint8)
    got = te.delta_unpack(torch.from_numpy(packed), cells)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(je.delta_unpack(jnp.asarray(packed), cells)))
    assert got.numpy().tolist() == np.unpackbits(packed)[:cells].tolist()
    bits = (rng.random(cells) < 0.3).astype(np.uint8)
    np.testing.assert_array_equal(te.bitset_pack(torch.from_numpy(bits)).numpy(),
                                  np.asarray(je.bitset_pack(jnp.asarray(bits))))
    np.testing.assert_array_equal(te.bitset_pack(torch.from_numpy(bits)).numpy(),
                                  np.packbits(bits))
    tb = torch.from_numpy(bits.copy())
    out = te.bitset_absorb_packed(tb, torch.from_numpy(packed))
    assert out.data_ptr() == tb.data_ptr()  # in place
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(je.bitset_absorb_packed(jnp.asarray(bits),
                                                        jnp.asarray(packed))))


def test_delta_scatter_bytes_matches_jax():
    rng = np.random.default_rng(5)
    plane = np.zeros(5000, np.uint8)
    plane[rng.integers(0, 5000, 300)] = rng.integers(1, 255, 300)
    enc = jdelta.encode("bloom_add", "b", plane, cells=40_000, packed=True,
                        nkeys=0, raw_bytes=0)
    assert enc.sparse and enc.idx.shape[0] > enc.nnz  # (0, 0) padding present
    got = te.delta_scatter_bytes(torch.from_numpy(enc.idx), torch.from_numpy(enc.val), 5000)
    want = je.delta_scatter_bytes(jnp.asarray(enc.idx), jnp.asarray(enc.val), 5000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plane)
