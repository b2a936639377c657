"""The port's Bloom host mirror (the cases of tests/test_bloom_mirror.py that
need neither persistence nor checkpoints, and its redis durability flush),
with ingest='hostfold' forcing the mirror on the CPU: membership and cells
against the device path and the JAX package, per-key newly flags, count
from the mirror, a device probe syncing pending mirror bits, a device write
invalidating the mirror, a durability flush carrying the mirror's bits,
blocked filters staying on the device, and every state change that must
drop a mirror."""

import numpy as np
import pytest
import torch

from redisson_tpu import native as jnative
from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu_torch import native as tnative
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config

@pytest.fixture(autouse=True, scope="module")
def _fold_libraries():
    """Both host fold libraries, asked for when the module's first test
    runs, not while pytest imports it: the JAX package's library is built
    by `make` at first use, and several test workers starting at once race
    on that build (a worker that loses reads a half-written file; the JAX
    package retries the build on the next call)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("a host fold library failed to build")


def _client(ingest: str):
    return RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))


@pytest.fixture()
def hclient():
    c = _client("hostfold")
    yield c
    c.shutdown()


def _cells(c, name):
    return c._executor.execute_sync(name, "bits_export", None)[1]


def _fill(c):
    keys = np.random.default_rng(0).integers(0, 2**63, 5000, np.uint64)
    strs = [b"s%d" % i for i in range(1000)]
    bf = c.get_bloom_filter("bm:eq")
    assert bf.try_init(20_000, 0.01)
    out = [bf.add_ints(keys), bf.add_all(strs)]
    fresh = np.random.default_rng(9).integers(2**63, 2**64, 5000, np.uint64)
    out += [bf.contains_ints(keys), bf.contains_ints(fresh), bf.count()]
    c._executor.execute_sync("bm:eq", "bloom_sync", None)
    return out, _cells(c, "bm:eq")


def test_mirror_matches_device_path_and_jax(hclient):
    dclient = _client("device")
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "hostfold"
    jclient = RedissonTPU.create(jcfg)
    try:
        hout, hcells = _fill(hclient)
        dout, dcells = _fill(dclient)
        jout, jcells = _fill(jclient)
    finally:
        dclient.shutdown()
        jclient.shutdown()
    assert "bm:eq" in hclient.sketch._bloom_mirrors
    np.testing.assert_array_equal(hcells, dcells)
    np.testing.assert_array_equal(hcells, np.asarray(jcells))
    assert hout[2].all() and dout[2].all()
    for h, j in zip(hout, jout):
        np.testing.assert_array_equal(h, j)  # newly flags, membership, count
    np.testing.assert_array_equal(hout[3], dout[3])
    assert hout[4] == dout[4]


def test_add_returns_per_key_newly(hclient):
    bf = hclient.get_bloom_filter("bm:newly")
    bf.try_init(10_000, 0.01)
    assert list(bf.add_all([b"a", b"b", b"c"])) == [True, True, True]
    assert list(bf.add_all([b"a", b"b", b"d"])) == [False, False, True]


def test_count_and_contains_count_use_mirror(hclient):
    bf = hclient.get_bloom_filter("bm:count")
    bf.try_init(50_000, 0.01)
    keys = np.arange(10_000, dtype=np.uint64)
    bf.add_ints(keys)
    assert abs(bf.count() - 10_000) / 10_000 < 0.05
    assert bf.contains_count_ints(keys) == 10_000
    # No device work has happened for this filter's bits yet.
    assert hclient._store.get("bm:count").version == 0


def test_device_probe_syncs_pending_mirror(hclient):
    bf = hclient.get_bloom_filter("bm:dev")
    bf.try_init(10_000, 0.01)
    keys = np.arange(3000, dtype=np.uint64)
    bf.add_ints(keys)
    on_device = torch.from_numpy(keys.view(np.int64).copy())
    assert bf.contains_count_device_async(on_device).result() == 3000
    mir = hclient.sketch._bloom_mirrors["bm:dev"]
    assert mir["host_v"] == mir["absorbed_v"]  # the probe absorbed them


def test_device_write_invalidates_mirror(hclient):
    back = hclient.sketch
    bf = hclient.get_bloom_filter("bm:mix")
    bf.try_init(10_000, 0.01)
    bf.add_all([b"host-side"])
    hclient._executor.execute_sync("bm:mix", "bloom_sync", None)
    back.ingest = "device"  # a device-path write under the mirror's feet
    bf.add_all([b"device-side"])
    back.ingest = "hostfold"
    mir = back._bloom_mirrors["bm:mix"]
    assert mir["synced_dev"] != hclient._store.get("bm:mix").version
    assert bf.contains(b"host-side")  # the mirror rebuilds from the device
    assert bf.contains(b"device-side")
    assert not bf.contains(b"neither")


def test_durability_flush_includes_mirror_bits(hclient):
    from redisson_tpu_torch.interop.durability import DurabilityManager
    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
    from redisson_tpu_torch.interop.resp_client import SyncRespClient

    bf = hclient.get_bloom_filter("bm:flush")
    bf.try_init(5000, 0.01)
    bf.add_all([b"f%d" % i for i in range(500)])
    with EmbeddedRedis() as er:
        with SyncRespClient(port=er.port) as rc:
            dm = DurabilityManager(
                hclient._store, rc, executor=hclient._executor,
                pod_backend=hclient._pod_backend())
            assert dm.flush(["bm:flush"]) == 1
            raw = bytes(rc.execute("GET", "bm:flush"))
    # the flushed blob must carry exactly the host-folded bits
    flushed_pop = int(np.unpackbits(np.frombuffer(raw, np.uint8)).sum())
    mirror_pop = tnative.popcount(hclient.sketch._bloom_mirrors["bm:flush"]["bits"])
    assert flushed_pop == mirror_pop > 0


def test_blocked_filter_stays_on_device_path(hclient):
    bf = hclient.get_bloom_filter("bm:blk")
    bf.try_init(5000, 0.01, blocked=True)
    bf.add_all([b"x%d" % i for i in range(500)])
    assert bf.contains_all([b"x%d" % i for i in range(500)]).all()
    assert "bm:blk" not in hclient.sketch._bloom_mirrors


def test_state_changes_drop_or_move_the_mirror(hclient):
    back = hclient.sketch
    for name in ("a", "b", "c"):
        f = hclient.get_bloom_filter(name)
        f.try_init(5000, 0.01)
        f.add_all([name.encode() * 3])
    hclient.get_bloom_filter("a").delete()
    assert "a" not in back._bloom_mirrors
    hclient.get_bloom_filter("b").rename("b2")
    assert "b" not in back._bloom_mirrors and "b2" in back._bloom_mirrors
    assert hclient.get_bloom_filter("b2").contains(b"bbb")
    # An import replaces the object: its mirror goes.
    otype, cells, meta, _v = hclient._executor.execute_sync("c", "bits_export", None)
    hclient._executor.execute_sync(
        "c", "bits_import", {"otype": otype, "array": np.zeros_like(cells), "meta": meta})
    assert "c" not in back._bloom_mirrors
    assert not hclient.get_bloom_filter("c").contains(b"ccc")
    # A state install with objects drops every mirror; one without pushes
    # pending bits to the device first.
    hclient.get_bloom_filter("b2").add_all([b"pending"])
    bank, rows = hclient.to_numpy_state()
    hclient.from_jax_state(bank, rows)
    assert back._bloom_mirrors == {}
    assert hclient.get_bloom_filter("b2").contains(b"pending")
    hclient.from_jax_state(bank, rows, hclient.to_numpy_objects())
    assert back._bloom_mirrors == {}
    hclient.flushall()
    assert back._bloom_mirrors == {}
