"""RBatch in the port against RBatch in the JAX package, on the CPU.

BASELINE config 3's shape at a small size (256 sketches x 2,000 seeded
8-byte keys, as benchmarks/suite.py's config 3 stages them): the batched
PFADD leaves bank rows equal to the JAX client's under `segment` and `sort`,
and the executor coalesces the 256 staged hll_add ops into as many runs as
the JAX executor does. A mixed sketch-and-structure batch returns the JAX
client's results in staging order; staged futures and failing ops behave
as the JAX package's do.
"""

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.store import WrongTypeError

SKETCHES = 256
PER = 2_000


def _keys():
    rng = np.random.default_rng(3)
    return [[k.tobytes() for k in rng.integers(0, 2**63, PER, np.uint64)]
            for _ in range(SKETCHES)]


def _clients(ingest):
    jcfg = JConfig()
    jcfg.use_tpu().ingest = ingest
    jc = RedissonTPU.create(jcfg)
    tc = RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))
    return jc, tc


def _jax_runs(client) -> int:
    return client._executor.pipeline_stats()["runs_completed"]


def _batched_pfadd(client, keys, runs_of):
    batch = client.create_batch()
    for s in range(SKETCHES):
        batch.get_hyper_log_log(f"b3:s{s}").add_all_async(keys[s])
    before = runs_of(client)
    flags = batch.execute()
    runs = runs_of(client) - before
    names = [f"b3:s{s}" for s in range(SKETCHES)]
    union = client.get_hyper_log_log("b3:merged").merge_with_and_count(*names)
    return flags, runs, union


@pytest.mark.parametrize("ingest", ["segment", "sort"])
def test_batched_pfadd_over_256_sketches_matches_jax(ingest):
    keys = _keys()
    jc, tc = _clients(ingest)
    try:
        jflags, jruns, junion = _batched_pfadd(jc, keys, _jax_runs)
        tflags, truns, tunion = _batched_pfadd(
            tc, keys, lambda c: c._executor.runs_dispatched())
        jb = jc._routing.sketch
        jbank, jrows = np.asarray(jb.bank), dict(jb._rows)
        tbank, trows = tc.to_numpy_state()
    finally:
        jc.shutdown()
        tc.shutdown()
    assert tflags == jflags == [True] * SKETCHES
    # One run carries all 256 staged ops on both sides: execute_many hands
    # the dispatcher the whole pipeline, and hll_add steals across targets.
    assert truns == jruns == 1
    for s in range(SKETCHES):
        name = f"b3:s{s}"
        np.testing.assert_array_equal(tbank[trows[name]], jbank[jrows[name]],
                                      err_msg=name)
    np.testing.assert_array_equal(tbank[trows["b3:merged"]],
                                  jbank[jrows["b3:merged"]])
    assert tunion == junion
    assert abs(tunion - SKETCHES * PER) / (SKETCHES * PER) < 0.02


def test_batched_bytes_keys_equal_unbatched_int_keys():
    """The chip check holds the batched 8-byte keys against the same keys
    added unbatched as uint64 (add_ints hashes their 8-byte LE encoding):
    the registers agree."""
    rng = np.random.default_rng(5)
    ints = [rng.integers(0, 2**63, PER, np.uint64) for _ in range(4)]
    a = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="segment"))
    b = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="sort"))
    try:
        batch = a.create_batch()
        for s, arr in enumerate(ints):
            batch.get_hyper_log_log(f"s{s}").add_all_async([k.tobytes() for k in arr])
        batch.execute()
        for s, arr in enumerate(ints):
            b.get_hyper_log_log(f"s{s}").add_ints(arr)
        abank, arows = a.to_numpy_state()
        bbank, brows = b.to_numpy_state()
    finally:
        a.shutdown()
        b.shutdown()
    for s in range(len(ints)):
        np.testing.assert_array_equal(abank[arows[f"s{s}"]], bbank[brows[f"s{s}"]])


def _mixed(client):
    client.get_bloom_filter("bf").try_init(10_000, 0.01)
    batch = client.create_batch()
    m = batch.get_map("m")
    futs = [m.put_async(f"k{i}", i) for i in range(50)]
    futs.append(m.get_async("k7"))
    h = batch.get_hyper_log_log("h")
    futs.append(h.add_all_async([f"u{i}" for i in range(300)]))
    futs.append(h.add_ints_async(np.arange(1000, dtype=np.uint64)))
    futs.append(h.count_async())
    futs.append(batch.get_bucket("b").set_async({"x": [1, 2]}))
    futs.append(batch.get_bucket("b").get_async())
    futs.append(batch.get_atomic_long("n").add_and_get_async(5))
    futs.append(batch.get_scored_sorted_set("z").add_async(1.5, "a"))
    futs.append(batch.get_scored_sorted_set("z").add_async(0.5, "a"))
    futs.append(batch.get_set("s").add_async("a"))
    futs.append(batch.get_set("s").add_async("a"))
    futs.append(batch.get_list("l").add_async(3))
    futs.append(batch.get_queue("q").offer_async("first"))
    futs.append(batch.get_bit_set("bits").set_bits_async([7, 9, 7]))
    futs.append(batch.get_bit_set("bits").get_bits_async([7, 8, 9]))
    futs.append(batch.get_bloom_filter("bf").add_all_async(["x", "y"]))
    futs.append(batch.get_keys().delete_async("l"))
    futs.append(batch.get_keys().get_keys_async("*"))
    results = batch.execute()
    _assert_same(results, [f.result() for f in futs])
    return results


def _assert_same(a, b):
    """Result lists with numpy flag arrays among plain values."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=str(i))
        else:
            assert x == y, (i, x, y)


def test_mixed_batch_matches_jax_in_staging_order():
    jc, tc = _clients("auto")
    try:
        jres = _mixed(jc)
        tres = _mixed(tc)
        assert tc.get_map("m").size() == jc.get_map("m").size() == 50
    finally:
        jc.shutdown()
        tc.shutdown()
    # the keyspace listing is the last op: compare it as a set
    assert sorted(tres[-1]) == sorted(jres[-1])
    _assert_same(tres[:-1], jres[:-1])
    assert tres[50] == 7 and tres[:50] == [None] * 50


def test_staged_future_result_before_execute_raises():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        batch = c.create_batch()
        f = batch.get_bucket("b").get_async()
        raw = batch._collector._futures[0]
        with pytest.raises(RuntimeError, match="not executed"):
            raw.result()
        with pytest.raises(RuntimeError, match="sync calls"):
            batch.get_bucket("b").size()  # an execute_sync method
        assert batch.execute() == [None]
        assert f.result() is None
        with pytest.raises(RuntimeError, match="already executed"):
            batch.execute()
    finally:
        c.shutdown()


def _failing(client):
    client.get_bucket("wt").set("v")
    batch = client.create_batch()
    ok = batch.get_map("fine").put_async("a", 1)
    bad = batch.get_map("wt").put_async("a", 1)
    after = batch.get_map("fine").get_async("a")
    with pytest.raises(Exception) as info:
        batch.execute()
    return type(info.value).__name__, ok.result(), after.result(), bad.exception()


def test_failing_op_fails_execute_as_in_jax():
    jc, tc = _clients("auto")
    try:
        jname, jok, jafter, jexc = _failing(jc)
        tname, tok, tafter, texc = _failing(tc)
    finally:
        jc.shutdown()
        tc.shutdown()
    assert tname == jname == "WrongTypeError"
    assert isinstance(texc, WrongTypeError)
    assert (tok, tafter) == (jok, jafter) == (None, 1)


def test_execute_async_returns_decoded_futures():
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        c.get_map("m").put("k", {"v": 1})
        batch = c.create_batch()
        batch.get_map("m").get_async("k")
        batch.get_atomic_long("n").increment_and_get_async()
        futs = batch.execute_async()
        assert [f.result(timeout=10) for f in futs] == [{"v": 1}, 1]
    finally:
        c.shutdown()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_decoded_staged_future_waits_for_execute(package):
    """Shared by both packages (ROADMAP Queue 3): a staged op's raw future
    raises before execute(), but its decoded wrapper (map_future) is a
    plain Future that waits; a sync getter built on it (RBucket.get)
    would wait forever on a batch object."""
    if package == "jax":
        c = RedissonTPU.create(JConfig())
    else:
        c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        batch = c.create_batch()
        f = batch.get_bucket("b").get_async()
        with pytest.raises(TimeoutError):
            f.result(timeout=0.05)
        assert batch.execute() == [None]
        assert f.result(timeout=5) is None
    finally:
        c.shutdown()


@pytest.mark.parametrize("ingest", ["segment", "scatter"])
def test_batched_small_int_ops_across_sketches_match_jax(ingest):
    """Ops under MIN_BUCKET keys gather into one multi-target chunk: under
    `segment` the port folds each target's span with the segmented insert,
    JAX with one flat scatter; registers and PFADD flags agree."""
    rng = np.random.default_rng(11)
    keys = [rng.integers(0, 2**63, int(n), np.uint64)
            for n in rng.integers(1, 900, 64)]
    keys[21] = keys[20][:10]
    jc, tc = _clients(ingest)
    try:
        out = []
        for c in (jc, tc):
            c.get_hyper_log_log("s20").add_ints(keys[20])
            c.get_hyper_log_log("s21").add_ints(keys[20])  # nothing new for either
            batch = c.create_batch()
            for i, k in enumerate(keys):
                batch.get_hyper_log_log(f"s{i % 48}").add_ints_async(k)
            out.append(batch.execute())
        jb = jc._routing.sketch
        jbank, jrows = np.asarray(jb.bank), dict(jb._rows)
        tbank, trows = tc.to_numpy_state()
    finally:
        jc.shutdown()
        tc.shutdown()
    assert out[0] == out[1]
    assert out[1][20] is False and out[1][21] is False and out[1][0] is True
    for name, row in trows.items():
        np.testing.assert_array_equal(tbank[row], jbank[jrows[name]], err_msg=name)


class _CountingBackend:
    """Resolves every op at once and records each run's size: the
    executors' coalescing, without an engine under them."""

    GLOBAL_COALESCE = frozenset({"hll_add", "bloom_add", "bitset_set"})
    DISPATCH_TIME_STATE = True
    batch_dims = {}

    def __init__(self):
        self.runs = []

    def run(self, kind, target, ops, window=None):
        self.runs.append(len(ops))
        for op in ops:
            op.future.set_result(True)


@pytest.mark.parametrize("max_batch_keys", [1 << 23, 1 << 21])
def test_config3_batch_takes_as_many_runs_as_jax(max_batch_keys):
    """BASELINE config 3 at full width (256 staged hll_add ops of 40,000
    keys) through both executors: the same runs, of the same sizes (2 at the
    default cap of 2^23 keys: 209 + 47 ops)."""
    from redisson_tpu import executor as jexec
    from redisson_tpu_torch import executor as texec

    staged = [(f"b3:s{i}", "hll_add", None, 40_000) for i in range(256)]
    runs = []
    for mod in (jexec, texec):
        backend = _CountingBackend()
        ex = mod.CommandExecutor(backend, max_batch_keys=max_batch_keys)
        try:
            batch = ex.batch()
            for t, k, p, n in staged:
                batch.add(t, k, p, n)
            assert batch.execute() == [True] * 256
        finally:
            ex.shutdown()
        runs.append(backend.runs)
    assert runs[0] == runs[1]
    if max_batch_keys == 1 << 23:
        assert runs[1] == [209, 47]


def test_multi_target_byte_run_takes_one_segmented_call_per_chunk(monkeypatch):
    """Under `segment` a coalesced byte-key run over many sketches goes
    through the segmented insert's multi-target form, one call per chunk
    (on the card one launch), and leaves the bank and the replies that the
    flat scatter leaves."""
    from redisson_tpu_torch import engine
    from redisson_tpu_torch.ingest import kernels as ik

    keys = [[b"k%d:%d" % (i, j) for j in range(100)] for i in range(3)]
    calls = []
    real = ik.hll_insert_segmented_rows

    def spy(bank, bucket, *rest):
        calls.append(bucket.numel())
        return real(bank, bucket, *rest)

    monkeypatch.setattr(ik, "hll_insert_segmented_rows", spy)
    monkeypatch.setattr(engine, "MAX_BUCKET", 128)
    out = {}
    for ingest in ("segment", "scatter"):
        c = RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))
        try:
            batch = c.create_batch()
            for i, k in enumerate(keys):
                batch.get_hyper_log_log(f"h{i}").add_all_async(k)
            flags = batch.execute()
            bank, rows = c.to_numpy_state()
            out[ingest] = (flags, {n: bank[r] for n, r in rows.items()})
        finally:
            c.shutdown()
        if ingest == "segment":
            assert len(calls) == 3  # 300 keys in chunks of 128, each padded
    assert out["segment"][0] == out["scatter"][0] == [True] * 3
    for n, regs in out["scatter"][1].items():
        np.testing.assert_array_equal(out["segment"][1][n], regs, err_msg=n)
