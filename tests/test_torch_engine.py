"""The port's engine (flat and bank HLL entry points) against
`redisson_tpu.engine` on a small bank: bank rows and per-row PFADD
`changed` flags bit-identical; estimates within float32 rounding (see
tests/test_torch_hll.py for the tolerance's reason)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu import engine as je
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.models.object import pack_u64 as jpack
from redisson_tpu_torch import engine as te
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config

S = 8
M = 16384
RTOL = 1e-5


def _bank(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 6, (S, M)).astype(np.int32)


def _keys(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                                endpoint=False)


def _i64(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(keys.view(np.int64).copy())


def _bytes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, n).astype(np.int32)
    data = rng.integers(0, 256, (n, 48)).astype(np.uint8)
    data[np.arange(48)[None, :] >= lengths[:, None]] = 0
    return data, lengths


def _same(tbank, jbank, tchanged=None, jchanged=None):
    np.testing.assert_array_equal(tbank.numpy(), np.asarray(jbank))
    if tchanged is not None:
        np.testing.assert_array_equal(tchanged.numpy(), np.asarray(jchanged))


@pytest.mark.parametrize("impl", ["scatter", "sort", "segment"])
@pytest.mark.parametrize("family", ["m3", "redis"])
def test_bank_add_packed_single_row(impl, family):
    bank = _bank(1)
    keys, count = te.pad_rows(_keys(3000, 2))
    tb, tc = te.hll_bank_add_packed(torch.from_numpy(bank.copy()), _i64(keys), count, 3,
                                    7, family, impl)
    jb, jc = je.hll_bank_add_packed(jnp.asarray(bank), jpack(keys), np.int32(count),
                                    np.int32(3), 7, family, impl)
    _same(tb, jb, tc, jc)
    assert bool(tc[3]) and int(tc.sum()) == 1
    # The same keys again change nothing.
    tb2, tc2 = te.hll_bank_add_packed(tb, _i64(keys), count, 3, 7, family, impl)
    jb2, jc2 = je.hll_bank_add_packed(jnp.asarray(np.asarray(jb)), jpack(keys),
                                      np.int32(count), np.int32(3), 7, family, impl)
    _same(tb2, jb2, tc2, jc2)
    assert not bool(tc2.any())


@pytest.mark.parametrize("family", ["m3", "redis"])
def test_bank_add_packed_rows(family):
    bank = _bank(2)
    keys, count = te.pad_rows(_keys(1500, 3))
    rows = np.random.default_rng(4).integers(0, S - 1, keys.shape[0]).astype(np.int32)
    tb, tc = te.hll_bank_add_packed_rows(torch.from_numpy(bank.copy()), _i64(keys),
                                         torch.from_numpy(rows), count, 0, family)
    jb, jc = je.hll_bank_add_packed_rows(jnp.asarray(bank), jpack(keys),
                                         jnp.asarray(rows), np.int32(count), 0, family)
    _same(tb, jb, tc, jc)
    assert not bool(tc[S - 1])  # untouched row


@pytest.mark.parametrize("impl", ["scatter", "sort", "segment"])
def test_bank_add_bytes(impl):
    bank = _bank(3)
    data, lengths, valid = te.pad_bytes(*_bytes(1200, 5))
    tb, tc = te.hll_bank_add_bytes(
        torch.from_numpy(bank.copy()), torch.from_numpy(data), torch.from_numpy(lengths),
        torch.from_numpy(valid), 5, 0, "m3", impl)
    jb, jc = je.hll_bank_add_bytes(jnp.asarray(bank), data, lengths, valid,
                                   np.int32(5), 0, "m3", impl)
    _same(tb, jb, tc, jc)
    rows, _ = te.pad_ints(np.arange(1200, dtype=np.int32) % S)
    # The multi-target form: 'segment' takes the kernel's, the others JAX's
    # flat scatter.
    tb, tc = te.hll_bank_add_bytes_rows(
        torch.from_numpy(bank.copy()), torch.from_numpy(data), torch.from_numpy(lengths),
        torch.from_numpy(rows), torch.from_numpy(valid), 0, "redis", impl)
    jb, jc = je.hll_bank_add_bytes_rows(jnp.asarray(bank), data, lengths, rows, valid,
                                        0, "redis")
    _same(tb, jb, tc, jc)


@pytest.mark.parametrize("impl", ["scatter", "sort", "segment"])
def test_flat_adds(impl):
    regs = _bank(4)[0]
    keys, count = te.pad_rows(_keys(2000, 6))
    tr, tc = te.hll_add_packed(torch.from_numpy(regs.copy()), _i64(keys), count, impl)
    jr, jc = je.hll_add_packed(jnp.asarray(regs), jpack(keys), np.int32(count), impl)
    _same(tr, jr, tc, jc)
    data, lengths, valid = te.pad_bytes(*_bytes(700, 7))
    tr, tc = te.hll_add_bytes(tr, torch.from_numpy(data), torch.from_numpy(lengths),
                              torch.from_numpy(valid), impl)
    jr, jc = je.hll_add_bytes(jnp.asarray(np.asarray(jr)), data, lengths, valid, impl)
    _same(tr, jr, tc, jc)


@pytest.mark.parametrize("batch", ["fresh", "no_raise", "all_invalid"])
@pytest.mark.parametrize("target", ["bank_row", "flat"])
def test_segment_insert_in_place_matches_sort_and_jax(batch, target):
    """`segment` folds into the row in place and the kernel's flag is the
    PFADD reply: the same registers and flags as `sort` and as JAX, also for
    a batch that raises nothing and one whose every lane is padding."""
    bank = _bank(6)
    keys, count = te.pad_rows(_keys(2500, 8))
    if batch == "all_invalid":
        count = 0
    elif batch == "no_raise":  # the registers already hold the batch
        bank = te.hll_bank_add_packed(torch.from_numpy(bank), _i64(keys), count, 2,
                                      7, "m3", "sort")[0].numpy()
    row = bank[2] if target == "flat" else bank
    out = {}
    for impl in ("segment", "sort"):
        regs = torch.from_numpy(row.copy())
        if target == "flat":
            got, changed = te.hll_add_packed(regs, _i64(keys), count, impl, 7)
        else:
            got, changed = te.hll_bank_add_packed(regs, _i64(keys), count, 2, 7,
                                                  "m3", impl)
        assert got is regs
        out[impl] = (regs, changed)
    if target == "flat":
        jr, jc = je.hll_add_packed(jnp.asarray(row), jpack(keys), np.int32(count),
                                   "segment", 7)
    else:
        jr, jc = je.hll_bank_add_packed(jnp.asarray(row), jpack(keys), np.int32(count),
                                        np.int32(2), 7, "m3", "segment")
    for regs, changed in out.values():
        _same(regs, jr, changed, jc)
    changed = out["segment"][1]
    assert bool(changed.any()) == (batch == "fresh")
    if target == "bank_row":
        assert changed.dtype == torch.bool and changed.shape == (S,)
        assert int(changed.sum()) == (batch == "fresh") and bool(changed[2]) == (
            batch == "fresh")


def test_bank_reads_and_merges():
    bank = _bank(5)
    tbank = torch.from_numpy(bank.copy())
    rows = te.pad_rows_repeat(np.array([1, 4, 6], np.int32))
    assert rows.tolist() == [1, 4, 6, 1]
    np.testing.assert_array_equal(te.hll_bank_row(tbank, 2).numpy(), bank[2])
    assert float(te.hll_bank_count(tbank, 2)) == pytest.approx(
        float(je.hll_bank_count(jnp.asarray(bank), np.int32(2))), rel=RTOL)
    assert float(te.hll_bank_count_rows(tbank, rows)) == pytest.approx(
        float(je.hll_bank_count_rows(jnp.asarray(bank), rows)), rel=RTOL)
    tb = te.hll_bank_merge_rows(torch.from_numpy(bank.copy()), rows, 4)
    _same(tb, je.hll_bank_merge_rows(jnp.asarray(bank), rows, np.int32(4)))
    tb, test = te.hll_bank_merge_count_rows(torch.from_numpy(bank.copy()), rows, 1)
    jb, jest = je.hll_bank_merge_count_rows(jnp.asarray(bank), rows, np.int32(1))
    _same(tb, jb)
    assert float(test) == pytest.approx(float(jest), rel=RTOL)
    # The port merges the row list as it comes: unpadded, JAX's answers.
    tb, test = te.hll_bank_merge_count_rows(torch.from_numpy(bank.copy()), rows[:3], 1)
    _same(tb, jb)
    assert float(test) == pytest.approx(float(jest), rel=RTOL)
    assert float(te.hll_bank_count_rows(tbank, rows[:3])) == pytest.approx(
        float(je.hll_bank_count_rows(jnp.asarray(bank), rows)), rel=RTOL)
    stack = torch.from_numpy(bank)
    np.testing.assert_array_equal(te.hll_merge_stack(stack).numpy(),
                                  np.asarray(je.hll_merge_stack(jnp.asarray(bank))))
    np.testing.assert_array_equal(
        te.hll_merge_all([stack[0], stack[1], stack[2]]).numpy(),
        np.asarray(je.hll_merge_all([jnp.asarray(bank[i]) for i in range(3)])))
    assert float(te.hll_count_merged(stack)) == pytest.approx(
        float(je.hll_count_merged(jnp.asarray(bank))), rel=RTOL)


@pytest.mark.parametrize("case", ["three", "repeats", "past_first_capacity", "strided"])
def test_bank_merges_over_host_rows(case):
    """countWith / PFMERGE / merge+count over a host row list (the numpy
    vector the backend builds, passed to merge_stack as it is): the bank
    JAX's engine leaves and its estimate, for repeats, a list longer than
    the first by-value capacity and a strided (non-contiguous) view."""
    bank = _bank(11)
    rng = np.random.default_rng(12)
    rows = {"three": np.array([1, 4, 6], np.int32),
            "repeats": np.array([2, 2, 5, 2, 0], np.int32),
            "past_first_capacity": rng.integers(0, S, 70).astype(np.int32),
            "strided": np.arange(2 * S, dtype=np.int32)[::3] % S}[case]
    assert (len(rows) > 64) == (case == "past_first_capacity")
    tbank = torch.from_numpy(bank.copy())
    assert float(te.hll_bank_count_rows(tbank, rows)) == pytest.approx(
        float(je.hll_bank_count_rows(jnp.asarray(bank), rows)), rel=RTOL)
    _same(tbank, bank)  # countWith never writes
    tb = te.hll_bank_merge_rows(torch.from_numpy(bank.copy()), rows, 3)
    _same(tb, je.hll_bank_merge_rows(jnp.asarray(bank), rows, np.int32(3)))
    tb, test = te.hll_bank_merge_count_rows(torch.from_numpy(bank.copy()), rows, 7)
    jb, jest = je.hll_bank_merge_count_rows(jnp.asarray(bank), rows, np.int32(7))
    _same(tb, jb)
    assert float(test) == pytest.approx(float(jest), rel=RTOL)


def test_bank_row_writes():
    bank = _bank(6)
    regs_u8 = np.random.default_rng(8).integers(0, 9, (4, M)).astype(np.uint8)
    rows = np.array([2, 5, 2, 7], np.int32)  # repeats fold under max
    tb, tc = te.hll_bank_absorb_rows(torch.from_numpy(bank.copy()),
                                     torch.from_numpy(regs_u8), rows)
    jb, jc = je.hll_bank_absorb_rows(jnp.asarray(bank), jnp.asarray(regs_u8), rows)
    _same(tb, jb, tc, jc)
    regs = regs_u8[0].astype(np.int32)
    _same(te.hll_bank_set_row(torch.from_numpy(bank.copy()), torch.from_numpy(regs), 3),
          je.hll_bank_set_row(jnp.asarray(bank), regs, np.int32(3)))
    urows = np.array([1, 6], np.int32)
    np.testing.assert_array_equal(te.hll_bank_rows_u8(torch.from_numpy(bank), urows).numpy(),
                                  np.asarray(je.hll_bank_rows_u8(jnp.asarray(bank), urows)))
    _same(te.hll_bank_set_rows(torch.from_numpy(bank.copy()),
                               torch.from_numpy(regs_u8[:2]), urows),
          je.hll_bank_set_rows(jnp.asarray(bank), jnp.asarray(regs_u8[:2]), urows))
    _same(te.hll_bank_zero_row(torch.from_numpy(bank.copy()), 0),
          je.hll_bank_zero_row(jnp.asarray(bank), np.int32(0)))
    _same(te.hll_bank_grow(torch.from_numpy(bank), 2 * S),
          je.hll_bank_grow(jnp.asarray(bank), 2 * S))


def test_padding_helpers():
    assert te.bucket_size(1) == te.MIN_BUCKET == je.MIN_BUCKET
    assert te.bucket_size(te.MAX_BUCKET + 5) == te.MAX_BUCKET == je.MAX_BUCKET
    assert te.chunk_spans(5, 2) == je.chunk_spans(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert te.chunk_spans(0) == []
    arr = np.arange(10, dtype=np.int32)
    for a, b in zip(te.pad_ints(arr, 3), je.pad_ints(arr, 3)):
        np.testing.assert_array_equal(a, b)


def test_from_jax_state_round_trip():
    """Install the JAX backend's bank + row map in the port; every sketch
    exports the same registers and counts the same."""
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "sort"
    jc = RedissonTPU.create(jcfg)
    tc = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="sort"))
    try:
        names = [f"s{i}" for i in range(S)]
        for i, n in enumerate(names):
            jc.get_hyper_log_log(n).add_ints(_keys(1500 + 100 * i, i))
        jsketch = jc._executor.backend.sketch
        jc._executor.execute_sync(names[0], "hll_count", None)  # drain
        jbank = np.asarray(jsketch.bank)
        tc.from_jax_state(jbank, dict(jsketch._rows))
        bank, rows = tc.to_numpy_state()
        np.testing.assert_array_equal(bank, jbank)
        assert rows == dict(jsketch._rows)
        for n in names:
            jregs, _ = jc._executor.execute_sync(n, "hll_export", None)
            tregs, _ = tc._executor.execute_sync(n, "hll_export", None)
            np.testing.assert_array_equal(tregs, jregs)
            assert tc.get_hyper_log_log(n).count() == jc.get_hyper_log_log(n).count()
        # The port keeps allocating rows after the installed ones.
        tc.get_hyper_log_log("fresh").add_ints(_keys(10, 99))
        _, rows = tc.to_numpy_state()
        assert rows["fresh"] == len(names)
    finally:
        jc.shutdown()
        tc.shutdown()
