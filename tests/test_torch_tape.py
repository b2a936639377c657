"""The port's tape ingest and delta window against the JAX package on the
CPU: `encode_window`, `window_merge_plain` (against the Pallas kernel in
interpret mode and `window_merge_lax`), `tape_apply`, the executor's
cross-kind steal, and the client end to end under ingest="delta", "tape"
and "hostfold" (bank, cells and every future's value). Exact everywhere
except PFCOUNT (rel 1e-5, the float32 estimator)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu import engine as je
from redisson_tpu import native as jnative
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.ingest import delta as jdelta
from redisson_tpu.ingest import tape as jtape
from redisson_tpu.ops import window_kernel as jwk
from redisson_tpu_torch import engine as te
from redisson_tpu_torch import native as tnative
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.executor import CommandExecutor
from redisson_tpu_torch.ingest import delta as tdelta
from redisson_tpu_torch.ingest import tape as ttape
from redisson_tpu_torch.ops import window_kernel as twk

@pytest.fixture(autouse=True, scope="module")
def _fold_libraries():
    """Both host fold libraries, asked for when the module's first test
    runs, not while pytest imports it: the JAX package's library is built
    by `make` at first use, and several test workers starting at once race
    on that build (a worker that loses reads a half-written file; the JAX
    package retries the build on the next call)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("a host fold library failed to build")


# -- encode_window ----------------------------------------------------------------


def _planes(delta_mod, seed: int):
    """A mixed window of planes (dense and sparse, all three kinds), made by
    `delta_mod.encode` from the same seeded arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (kind, cells, fill) in enumerate([
            ("bloom_add", 958_505, 40_000), ("hll_add", 16384, 9000),
            ("bitset_set", 1 << 17, 30), ("hll_add", 16384, 10),
            ("bitset_set", 1 << 20, 100_000), ("bloom_add", 95_851, 5)]):
        packed = kind != "hll_add"
        nbytes = (cells + 7) // 8 if packed else cells
        plane = np.zeros(nbytes, np.uint8)
        plane[rng.integers(0, nbytes, fill)] = rng.integers(1, 60 if not packed else 256,
                                                            fill)
        out.append(delta_mod.encode(kind, f"t{i}", plane, cells=cells, packed=packed,
                                    nkeys=fill, raw_bytes=8 * fill))
    return out


def _bank_rows(name: str) -> int:
    return 3 * int(name[1:]) + 1


@pytest.mark.parametrize("keep", [slice(None), slice(2, 3), slice(0, 0)])
def test_encode_window_matches_jax(keep):
    got = ttape.encode_window(_planes(tdelta, 1)[keep], _bank_rows)
    want = jtape.encode_window(_planes(jdelta, 1)[keep], _bank_rows)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.wire, want.wire)
    np.testing.assert_array_equal(got.hll_rows, want.hll_rows)
    assert (got.lanes, got.n_hll, got.link_bytes, len(got.planes)) == (
        want.lanes, want.n_hll, want.link_bytes, len(want.planes))
    assert not got.table[:, twk.COL_SHARD].any()  # one engine: shard 0
    assert [p.target for p in got.planes] == [p.target for p in want.planes]
    assert got.table.shape[1] == twk.TABLE_COLS == jwk.TABLE_COLS
    assert (twk.OP_PAD, twk.OP_HLL, twk.OP_BLOOM, twk.OP_BITSET, twk.COL_SHARD,
            twk.DENSE_OPS) == (jwk.OP_PAD, jwk.OP_HLL, jwk.OP_BLOOM, jwk.OP_BITSET,
                               jwk.COL_SHARD, jwk.DENSE_OPS)
    assert ttape.MIN_LANES == jtape.MIN_LANES and ttape.MIN_WIRE == jtape.MIN_WIRE


# -- window_merge -------------------------------------------------------------------


def _tape(t: int, lanes: int, width: int, seed: int):
    """A random tape: every op code, PAD rows, lengths not a multiple of 8,
    garbage in the target_row / offset / shard columns."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 4, t).astype(np.int32)
    lengths = rng.integers(0, lanes + 1, t).astype(np.int32)
    lengths[ops == twk.OP_PAD] = 0
    lengths[: max(1, t // 3)] = lanes - 1 - rng.integers(0, 7, max(1, t // 3))
    table = np.stack([ops, rng.integers(-5, 99, t),
                      rng.integers(-2**31, 2**31 - 1, t, dtype=np.int64),
                      lengths, rng.integers(0, 9, t)], axis=1).astype(np.int32)
    old = rng.integers(0, 2, (t, lanes)).astype(np.uint8)
    old[ops == twk.OP_HLL] = rng.integers(0, 50, (int((ops == twk.OP_HLL).sum()), lanes))
    wire = rng.integers(0, 256, (t, width)).astype(np.uint8)
    wire[ops == twk.OP_HLL] %= 64
    return old, wire, table


@pytest.mark.parametrize("t,lanes,width", [(8, 4096, 4096), (16, 2048, 256),
                                           (4, 1024, 128), (5, 8192, 1024)])
def test_window_merge_plain_matches_jax(t, lanes, width):
    old, wire, table = _tape(t, lanes, width, t * lanes)
    pm, pc = jwk.window_merge_pallas(jnp.asarray(old), jnp.asarray(wire),
                                     jnp.asarray(table), interpret=True)
    lm, lc = jwk.window_merge_lax(jnp.asarray(old), jnp.asarray(wire), jnp.asarray(table))
    told = torch.from_numpy(old.copy())
    tm, tc = twk.window_merge_plain(told, torch.from_numpy(wire), torch.from_numpy(table))
    assert tm.data_ptr() == told.data_ptr()  # merged in place
    for m_, c_ in ((pm, pc), (lm, lc)):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(m_))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(c_))
    gm, gc = twk.window_merge(torch.from_numpy(old.copy()), torch.from_numpy(wire),
                              torch.from_numpy(table))  # the gate, on the CPU
    np.testing.assert_array_equal(gm.numpy(), tm.numpy())
    np.testing.assert_array_equal(gc.numpy(), tc.numpy())


def test_window_merge_reads_row_t_not_the_offset_column():
    old, wire, table = _tape(8, 2048, 512, 3)
    base, _ = twk.window_merge_plain(torch.from_numpy(old.copy()),
                                     torch.from_numpy(wire), torch.from_numpy(table))
    garbage = table.copy()
    garbage[:, 2] = np.arange(8)[::-1] * 512  # offsets pointing at other rows
    again, _ = twk.window_merge_plain(torch.from_numpy(old.copy()),
                                      torch.from_numpy(wire), torch.from_numpy(garbage))
    np.testing.assert_array_equal(again.numpy(), base.numpy())
    with pytest.raises(ValueError):
        twk.window_merge(torch.from_numpy(old), torch.from_numpy(wire[:3]),
                         torch.from_numpy(table))


# -- tape_apply ---------------------------------------------------------------------


@pytest.mark.parametrize("n_hll,want_old", [(3, True), (0, True), (4, False)])
def test_tape_apply_matches_jax(n_hll, want_old):
    rng = np.random.default_rng(n_hll)
    planes = [p for p in _planes(tdelta, 2) if p.kind != "hll_add"]
    hplanes = []
    for i in range(n_hll):
        plane = np.zeros(16384, np.uint8)
        plane[rng.integers(0, 16384, 500)] = rng.integers(1, 52, 500)
        hplanes.append(tdelta.encode("hll_add", f"h{i}", plane, cells=16384,
                                     packed=False, nkeys=500, raw_bytes=0))
    rows = {f"h{i}": r for i, r in enumerate([5, 0, 9, 2][:n_hll])}
    tp = ttape.encode_window(hplanes + planes, rows.get)
    bank = rng.integers(0, 30, (12, 16384)).astype(np.int32)
    store_old = [(rng.random(p.cells) < 0.2).astype(np.uint8) for p in tp.planes[n_hll:]]
    rows_pad = (te.pad_rows_repeat(tp.hll_rows) if n_hll
                else np.zeros((1,), np.int32))
    jbank, jm, jc, jo = je.tape_apply(
        jnp.asarray(bank), jnp.asarray(tp.wire), jnp.asarray(tp.table),
        jnp.asarray(rows_pad), tuple(jnp.asarray(s) for s in store_old),
        n_hll=n_hll, lanes=tp.lanes, want_old=want_old)
    tbank = torch.from_numpy(bank.copy())
    nb, tm, tc, to = te.tape_apply(
        tbank if n_hll else None, torch.from_numpy(tp.wire), torch.from_numpy(tp.table),
        torch.from_numpy(rows_pad), [torch.from_numpy(s) for s in store_old],
        n_hll=n_hll, lanes=tp.lanes, want_old=want_old)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if n_hll:
        # In place, through the repeat-padded rows (3 rows pad to 4: row 5
        # is written twice with the same registers).
        assert nb.data_ptr() == tbank.data_ptr()
        np.testing.assert_array_equal(nb.numpy(), np.asarray(jbank))
        assert (nb.numpy() != bank).any()
    if want_old:
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert to.shape == (tp.table.shape[0], tp.lanes // 8)
    else:
        assert to is None and jo is None


# -- the executor's cross-kind steal --------------------------------------------------


class _Recorder:
    GLOBAL_COALESCE = frozenset({"hll_add", "bloom_add", "bitset_set"})
    COALESCE_GROUPS = {"hll_add": "delta", "bloom_add": "delta", "bitset_set": "delta"}
    DISPATCH_TIME_STATE = True

    def __init__(self):
        self.runs = []

    def run(self, kind, target, ops):
        self.runs.append([(op.kind, op.target) for op in ops])
        for op in ops:
            op.future.set_result(None)


def _hold(executor):
    """Block the dispatcher on a barrier until the returned event is set."""
    release, entered = threading.Event(), threading.Event()

    def block():
        entered.set()
        release.wait(30)

    fut = executor.execute_barrier(block)
    assert entered.wait(30)
    return release, fut


@pytest.mark.parametrize("grouped", [True, False])
def test_executor_steals_across_the_delta_kinds(grouped):
    rec = _Recorder()
    if not grouped:
        rec.COALESCE_GROUPS = {}
    ex = CommandExecutor(rec)
    try:
        release, fut = _hold(ex)
        heads = [("hll_add", "h1"), ("bloom_add", "f1"), ("bitset_set", "b1"),
                 ("hll_add", "h2"), ("bitset_set", "b2")]
        futs = [ex.execute_async(t, k, {}, nkeys=10) for k, t in heads]
        release.set()
        fut.result(30)
        for f in futs:
            f.result(30)
    finally:
        ex.shutdown()
    if grouped:
        assert rec.runs == [heads]  # one run: every head stolen into it
    else:
        assert len(rec.runs) == 3 and rec.runs[0] == [heads[0], heads[3]]


# -- the client end to end ------------------------------------------------------------


def _jax_client(ingest: str):
    cfg = JConfig()
    cfg.use_tpu().ingest = ingest
    return RedissonTPU.create(cfg)


def _port_client(ingest: str):
    return RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))


def _script(c):
    """One seeded op sequence, synchronous, so results compare op by op."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        h = c.get_hyper_log_log(f"h{i}")
        out.append(("pfadd", h.add_ints(rng.integers(0, 2**64, 3000 * (i + 1),
                                                     dtype=np.uint64))))
        out.append(("pfadd again", h.add_ints(np.arange(100, dtype=np.uint64))))
        out.append(("pfadd bytes", h.add_all([f"k{j}" for j in range(200)])))
    f = c.get_bloom_filter("bf")
    f.try_init(20_000, 0.01)
    keys = rng.integers(0, 2**63, 9000, dtype=np.uint64)
    out.append(("bloom add", f.add_ints(keys[:6000]).tolist()))
    out.append(("bloom add overlap", f.add_ints(keys[3000:]).tolist()))
    out.append(("bloom add_all", f.add_all([f"w{j}" for j in range(500)]).tolist()))
    probe = np.concatenate([keys[:100], rng.integers(2**63, 2**64, 2000, dtype=np.uint64)])
    out.append(("contains", f.contains_ints(probe).tolist()))
    out.append(("contains_count", f.contains_count_ints(keys)))
    out.append(("bloom count", f.count()))
    b = c.get_bit_set("bs")
    out.append(("setbit", b.set_bits(rng.integers(0, 50_000, 4000)).tolist()))
    out.append(("setbit grows", b.set_bits(rng.integers(0, 300_000, 4000)).tolist()))
    out.append(("cardinality", b.cardinality()))
    c._executor.execute_sync("bf", "bloom_sync", None)
    counts = [c.get_hyper_log_log(f"h{i}").count() for i in range(3)]
    state = {n: np.asarray(c._executor.execute_sync(n, "hll_export", None)[0], np.uint8)
             for n in ("h0", "h1", "h2")}
    for n in ("bf", "bs"):
        otype, cells, meta, _v = c._executor.execute_sync(n, "bits_export", None)
        state[n] = (otype, np.asarray(cells, np.uint8), meta)
    return out, counts, state


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tuple):
            assert g[0] == w[0] and g[2] == w[2], name
            np.testing.assert_array_equal(g[1], w[1], err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("ingest", ["delta", "tape", "hostfold"])
def test_client_script_matches_jax(ingest):
    jc, tc = _jax_client(ingest), _port_client(ingest)
    try:
        jout, jcounts, jstate = _script(jc)
        tout, tcounts, tstate = _script(tc)
        stats = tc.sketch.ingest_stats()
    finally:
        jc.shutdown()
        tc.shutdown()
    assert tout == jout
    np.testing.assert_allclose(tcounts, jcounts, rtol=1e-5)
    _assert_same_state(tstate, jstate)
    if ingest == "hostfold":
        assert stats["merge_launches"] == 0
    else:
        # Every PFADD, Bloom add and SETBIT went through a merge launch.
        assert stats["merge_launches"] == 14
        assert stats["tape_runs" if ingest == "tape" else "delta_runs"] == 14


def _mixed(c, n_hll=6, n_bloom=3, n_bits=3, seed=0):
    """One window that mixes PFADD, Bloom add and SETBIT on many targets:
    queued behind a barrier, so the executor steals them into one run."""
    rng = np.random.default_rng(seed)
    for i in range(n_bloom):
        c.get_bloom_filter(f"mf{i}").try_init(3000, 0.01)
    release, fut = _hold(c._executor)
    futs = [c.get_hyper_log_log(f"mh{i}").add_ints_async(
        rng.integers(0, 2**64, 2000, dtype=np.uint64)) for i in range(n_hll)]
    futs += [c.get_bloom_filter(f"mf{i}").add_ints_async(
        rng.integers(0, 2**63, 1500, dtype=np.uint64)) for i in range(n_bloom)]
    futs += [c.get_bit_set(f"mb{i}").set_bits_async(rng.integers(0, 20_000, 3000))
             for i in range(n_bits)]
    release.set()
    fut.result(30)
    results = [f.result(30) for f in futs]
    state = {n: np.asarray(c._executor.execute_sync(n, "hll_export", None)[0], np.uint8)
             for n in (f"mh{i}" for i in range(n_hll))}
    for n in [f"mf{i}" for i in range(n_bloom)] + [f"mb{i}" for i in range(n_bits)]:
        c._executor.execute_sync(n, "bloom_sync", None)
        otype, cells, meta, _v = c._executor.execute_sync(n, "bits_export", None)
        state[n] = (otype, np.asarray(cells, np.uint8), meta)
    return results, state


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_mixed_window_retires_in_one_launch_and_matches():
    tc, dc, sc, jc = (_port_client("tape"), _port_client("delta"),
                      _port_client("scatter"), _jax_client("tape"))
    try:
        tres, tstate = _mixed(tc)
        stats = tc.sketch.ingest_stats()
        dres, dstate = _mixed(dc)
        sres, sstate = _mixed(sc)
        jres, jstate = _mixed(jc)
    finally:
        for c in (tc, dc, sc, jc):
            c.shutdown()
    assert stats["tape_runs"] == 1 and stats["merge_launches"] == 1
    assert stats["delta_runs"] == 0
    _same_results(tres, dres)
    _same_results(tres, jres)
    _assert_same_state(tstate, dstate)
    _assert_same_state(tstate, jstate)
    _assert_same_state(tstate, sstate)
    # PFADD flags and SETBIT old bits equal the device path's; a Bloom key's
    # newly flag from the in-order host fold implies the device's
    # batch-start `added` flag.
    _same_results(tres[:6] + tres[9:], sres[:6] + sres[9:])
    for t_new, s_add in zip(tres[6:9], sres[6:9]):
        assert not (t_new & ~s_add).any()


def test_over_budget_tape_window_falls_back_to_chunked_merges():
    tc, dc = _port_client("tape"), _port_client("delta")
    try:
        # 12 entries pad to 16 rows x 2^15 lanes: past a 2^18-cell budget.
        tc.sketch.DELTA_STACK_CELLS = dc.sketch.DELTA_STACK_CELLS = 1 << 18
        tres, tstate = _mixed(tc, seed=4)
        stats = tc.sketch.ingest_stats()
        dres, dstate = _mixed(dc, seed=4)
    finally:
        tc.shutdown()
        dc.shutdown()
    assert stats["tape_runs"] == 0 and stats["delta_runs"] == 1
    assert stats["merge_launches"] >= 2
    _same_results(tres, dres)
    _assert_same_state(tstate, dstate)
