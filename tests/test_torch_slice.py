"""The whole slice on the CPU: one seeded op script through the JAX package's
client (RedissonTPU, single-device mode on the CPU) and through the port's
client (RedissonTorch, device="cpu"), for each device ingest path.
Registers and PFADD booleans must be identical; estimates equal after
rounding (both sides round one float32 estimate; see test_torch_hll.py)."""

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.store import ObjectType, WrongTypeError

NAMES = [f"hll:{i}" for i in range(8)]


def _script(client):
    """Every op is synchronous, so each is its own run on both sides and
    the PFADD booleans are comparable op by op."""
    rng = np.random.default_rng(1234)
    hs = {n: client.get_hyper_log_log(n) for n in NAMES}
    out = []
    for i, n in enumerate(NAMES):
        keys = rng.integers(0, 2**64, 3000 + 500 * i, dtype=np.uint64, endpoint=False)
        out.append(("add_ints", n, hs[n].add_ints(keys)))
        out.append(("re-add", n, hs[n].add_ints(keys[:1500])))
        small = rng.integers(0, 2**64, 200, dtype=np.uint64, endpoint=False)
        out.append(("small", n, hs[n].add_ints(small)))
        words = [f"user:{i}:{j}" for j in range(300)] + [b"\x00\xff" * (j % 40)
                                                        for j in range(60)]
        out.append(("add_all", n, hs[n].add_all(words)))
        out.append(("add", n, hs[n].add(f"user:{i}:0")))
    for n in NAMES:
        out.append(("count", n, hs[n].count()))
    out.append(("count_with", NAMES[0], hs[NAMES[0]].count_with(*NAMES[1:5], "missing")))
    hs[NAMES[1]].merge_with(*NAMES[2:6])
    out.append(("count", NAMES[1], hs[NAMES[1]].count()))
    out.append(("merge_count", "union",
                client.get_hyper_log_log("union").merge_with_and_count(*NAMES)))
    out.append(("exists", "union", client.get_hyper_log_log("union").is_exists()))
    out.append(("delete", NAMES[7], hs[NAMES[7]].delete()))
    out.append(("count", NAMES[7], hs[NAMES[7]].count()))
    hs[NAMES[6]].rename("renamed")
    out.append(("count", "renamed", client.get_hyper_log_log("renamed").count()))
    regs = {}
    for n in NAMES[:6] + ["union", "renamed"]:
        exported, _version = client._executor.execute_sync(n, "hll_export", None)
        regs[n] = np.asarray(exported, np.uint8)
    return out, regs


@pytest.mark.parametrize("ingest", ["scatter", "sort", "segment"])
def test_script_matches_jax_client(ingest):
    jcfg = JConfig()
    jcfg.use_tpu().ingest = ingest
    jc = RedissonTPU.create(jcfg)
    tc = RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))
    try:
        jout, jregs = _script(jc)
        tout, tregs = _script(tc)
    finally:
        jc.shutdown()
        tc.shutdown()
    assert tout == jout
    assert tregs.keys() == jregs.keys()
    for n in jregs:
        np.testing.assert_array_equal(tregs[n], jregs[n], err_msg=n)
    assert all(v is True for k, _, v in tout if k == "add_ints")
    assert all(v is False for k, _, v in tout if k == "re-add")


def test_redis_family_through_the_client():
    jcfg = JConfig()
    jcfg.use_tpu().hll_hash = "redis"
    jc = RedissonTPU.create(jcfg)
    tc = RedissonTorch.create(Config().use_cuda(device="cpu", hll_hash="redis",
                                                ingest="segment"))
    try:
        keys = [b"user:%d" % i for i in range(5000)]
        assert tc.get_hyper_log_log("r").add_all(keys) is jc.get_hyper_log_log("r").add_all(keys)
        ints = np.arange(5000, dtype=np.uint64)
        assert tc.get_hyper_log_log("r").add_ints(ints) is jc.get_hyper_log_log("r").add_ints(ints)
        treg, _ = tc._executor.execute_sync("r", "hll_export", None)
        jreg, _ = jc._executor.execute_sync("r", "hll_export", None)
        np.testing.assert_array_equal(treg, np.asarray(jreg, np.uint8))
        assert tc.get_hyper_log_log("r").count() == jc.get_hyper_log_log("r").count()
    finally:
        jc.shutdown()
        tc.shutdown()


def test_port_client_semantics():
    c = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="auto"))
    try:
        h = c.get_hyper_log_log("a")
        assert h.count() == 0 and not h.is_exists()
        futs = [h.add_ints_async(np.arange(i * 100, i * 100 + 100, dtype=np.uint64))
                for i in range(20)]
        assert all(isinstance(f.result(), bool) for f in futs)
        assert abs(h.count() - 2000) / 2000 < 0.02
        assert c.keys() == ["a"]
        assert c.get_keys().get_keys() == ["a"]
        assert h.renamenx("b") and h.name == "b"
        c.get_hyper_log_log("c").add("x")
        assert not h.renamenx("c")
        # Big op: several MAX_BUCKET-sized chunks through the staging pipeline.
        big = np.arange(5_000_000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        assert c.get_hyper_log_log("big").add_ints(big)
        assert abs(c.get_hyper_log_log("big").count() - 5_000_000) / 5_000_000 < 0.02
        assert c.sketch.planner.table()  # auto measured its size classes
        # Another sketch kind under an HLL name: WRONGTYPE, isolated per op.
        c._store.get_or_create("bits", ObjectType.BITSET,
                               lambda: torch.zeros(8, dtype=torch.uint8))
        with pytest.raises(WrongTypeError):
            c.get_hyper_log_log("bits").add("x")
        # Non-sketch kinds reach the structure engine; an unknown kind fails
        # there, as in the JAX package.
        with pytest.raises(ValueError, match="unknown op kind"):
            c._executor.execute_sync("m", "map_put", {"k": 1})
        c.get_map("m").fast_put("k", 1)
        assert sorted(c.keys()) == ["b", "big", "bits", "c", "m"]
        c.flushall()
        assert c.keys() == []
    finally:
        c.shutdown()


def test_staging_pipeline_orders_results_and_reraises_stage_errors():
    from redisson_tpu_torch.ingest.pipeline import StagingPipeline

    pipe = StagingPipeline(depth=2)
    assert pipe.run(range(7), lambda c: c * 10, lambda i, s: (i, s)) == [
        (i, 10 * i) for i in range(7)]

    def stage(c):
        if c == 3:
            raise OSError("h2d failed")
        return c

    seen = []
    with pytest.raises(OSError):
        pipe.run(range(6), stage, lambda i, s: seen.append(s))
    assert seen == [0, 1, 2]
    with pytest.raises(ValueError):
        StagingPipeline(depth=0)
