"""The mesh data plane of the port (`data_plane="mesh"`: cluster/shard.py
MeshOwnershipBackend / MeshShard, the manager's mesh plane, the engine's
mesh collectives and the backend's mesh hooks) on the CPU: the JAX
package's corpus tests/test_mesh.py runs against the port, then the port
held against the JAX package.

The corpus runs through `port_corpus` (tests/test_torch_interop.py) with
its cluster factory `_mesh_cluster` redefined on `use_cuda(device="cpu")`
(the port's default is the card), as a corpus fixture is redefined: the
mode-parity, live-migration and churn tests run unchanged. The tests that
call jax, or build a mesh with no device (the card in the port), are in
`EXCLUDED` with their reason and have counterparts here.

Against the JAX package (8 virtual devices against 8 logical shards,
seeded with numpy): the four mesh collectives (merge, merge+count, count,
occupancy) and the tape's shard column. Exact, PFCOUNT within rel 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from redisson_tpu import engine as jengine
from redisson_tpu.ingest import tape as jtape
from redisson_tpu.ingest.delta import encode as jencode
from redisson_tpu.parallel import mesh as jmesh_mod
from redisson_tpu_torch import engine
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.ingest import tape
from redisson_tpu_torch.ingest.delta import encode
from redisson_tpu_torch.ops import hll
from redisson_tpu_torch.parallel import mesh as mesh_mod
from tests import test_mesh
from tests.test_torch_interop import CLIENT_ALIASES, corpus_tests, port_corpus


def mesh_cluster(tmp_path, data_plane, sub="cl"):
    """test_mesh.py's `_mesh_cluster` on the CPU."""
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_cluster(num_shards=4, dir=str(tmp_path / f"{sub}-{data_plane}"),
                    data_plane=data_plane)
    return RedissonTorch.create(cfg)


#: tests of tests/test_mesh.py with no counterpart run unchanged, and why
EXCLUDED = {
    "test_collective_merge_matches_host_fold_oracle":
        "places its bank with jax; see test_port_collective_merge_matches_"
        "host_fold_oracle",
    "test_collective_merge_count_matches_stacks_kernel":
        "places its bank with jax; see test_port_collective_merge_count_"
        "matches_stacks_kernel",
    "test_collective_count_and_occupancy_match_oracles":
        "places its bank with jax; see test_port_collective_count_and_"
        "occupancy_match_oracles",
    "test_mesh_cache_pinned_across_repeated_reshards":
        "builds meshes and a pod with no device (the card in the port); see "
        "test_port_mesh_cache_pinned_across_repeated_reshards",
}

_CORPUS = port_corpus(
    test_mesh, EXCLUDED, "mesh",
    ("redisson_tpu.client", "redisson_tpu.config", "redisson_tpu.parallel"),
    CLIENT_ALIASES, overrides={"_mesh_cluster": mesh_cluster})
globals().update(_CORPUS)


def test_corpus_was_imported():
    names = corpus_tests(test_mesh)
    assert len(names) == 7
    assert set(EXCLUDED) <= names
    assert {f"test_mesh__{k[5:]}" for k in names - set(EXCLUDED)} <= set(_CORPUS)
    fn = _CORPUS["test_mesh__mode_parity_randomized_multi_shard_windows"]
    assert fn.__globals__["_mesh_cluster"] is mesh_cluster


# -- counterparts of the excluded corpus tests ---------------------------------


def _mesh_bank(capacity=64, num_shards=4, seed=3, entries=8):
    mesh = mesh_mod.get_mesh(entries, axis=mesh_mod.SLOT_AXIS, device="cpu")
    sb = mesh_mod.ShardedBank(mesh, capacity, num_shards)
    host = np.random.default_rng(seed).integers(
        0, 52, size=(sb.capacity, hll.M), dtype=np.int32)
    return mesh, sb, host


def test_port_collective_merge_matches_host_fold_oracle():
    mesh, sb, host = _mesh_bank()
    rows = [3, 17, 33, 60, 9]
    target = 9
    got = engine.hll_bank_merge_rows_collective(
        sb.place(torch.from_numpy(host.copy())), np.array(rows, np.int32),
        target, mesh=mesh)
    oracle = host.copy()
    oracle[target] = host[rows].max(axis=0)
    assert (np.asarray(got) == oracle).all()


def test_port_collective_merge_count_matches_stacks_kernel():
    mesh, sb, host = _mesh_bank(seed=5)
    rows = np.array([0, 21, 42, 63, 11], np.int32)
    target = 11
    new_bank, cnt = engine.hll_bank_merge_count_rows_collective(
        sb.place(torch.from_numpy(host.copy())), rows, target, mesh=mesh)
    sbank2, scnt = engine.hll_bank_merge_count_rows(
        torch.from_numpy(host.copy()), rows, target)
    assert np.array_equal(np.asarray(new_bank), sbank2.numpy())
    assert float(cnt) == float(scnt)


def test_port_collective_count_and_occupancy_match_oracles():
    mesh, sb, host = _mesh_bank(seed=7)
    rows = np.array([1, 30, 55], np.int32)
    bank = sb.place(torch.from_numpy(host.copy()))
    cnt = float(engine.hll_bank_count_rows_collective(bank, rows, mesh=mesh))
    assert cnt == float(engine.hll_bank_count_rows(bank, rows))
    host2 = host.copy()
    host2[5] = 0
    host2[40] = 0
    occ = int(engine.hll_bank_occupancy_collective(
        sb.place(torch.from_numpy(host2)), mesh=mesh))
    assert occ == int(np.sum(np.any(host2 != 0, axis=1)))


def test_port_mesh_cache_pinned_across_repeated_reshards():
    m1 = mesh_mod.get_mesh(4, device="cpu")
    s0 = mesh_mod.mesh_cache_stats()
    assert mesh_mod.get_mesh(4, device="cpu") is m1
    s1 = mesh_mod.mesh_cache_stats()
    assert s1["builds"] == s0["builds"]
    assert s1["hits"] == s0["hits"] + 1
    cfg = Config()
    cfg.use_pod(device="cpu", num_shards=8, bank_capacity=16)
    pod = RedissonTorch.create(cfg)
    try:
        backend = pod._pod_backend()
        h = pod.get_hyper_log_log("mc:h")
        h.add_all([b"v%d" % i for i in range(50)])
        before = h.count()
        ndev = backend.mesh.size
        builds0 = mesh_mod.mesh_cache_stats()["builds"]
        for _ in range(5):
            backend.reshard(ndev)
        assert mesh_mod.mesh_cache_stats()["builds"] == builds0
        assert backend.mesh is mesh_mod.get_mesh(ndev, device="cpu")
        assert h.count() == before
    finally:
        pod.shutdown()


# -- the port's own rules -------------------------------------------------------


def test_mesh_plane_wiring(tmp_path):
    c = mesh_cluster(tmp_path, "mesh", sub="wire")
    try:
        mc = c.cluster.mesh_client
        backend = mc._routing.sketch
        assert backend.mesh.size == 4  # one logical entry per shard
        assert backend.mesh.home == torch.device("cpu")
        assert c.cluster_info()["data_plane"] == "mesh"
        # Every logical shard fronts the one shared executor.
        assert len({id(s.executor) for s in c.cluster.shards.values()}) == 1
        # A sketch's row lands in its owning shard's preferred block.
        table = c.cluster.router.slot_table()
        from redisson_tpu_torch.ops.crc16 import key_slot

        for i in range(8):
            name = f"wire:{i}"
            c.get_hyper_log_log(name).add(b"x")
            lo, hi = backend._sharded_bank.block(table[key_slot(name)])
            assert lo <= backend._rows[name] < hi
        assert backend.mesh_occupancy() == 8
        with pytest.raises(RuntimeError, match="already materialized"):
            backend.attach_mesh(backend.mesh, 4)
    finally:
        c.shutdown()
    with pytest.raises(ValueError):
        Config().use_cluster(data_plane="ring")


def test_mesh_plane_asks_for_the_card(tmp_path):
    cfg = Config()
    cfg.use_cluster(num_shards=2, data_plane="mesh")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            RedissonTorch.create(cfg)


def test_mesh_plane_snapshot_reseeds_the_owner_table(tmp_path):
    c = mesh_cluster(tmp_path, "mesh", sub="snap")
    try:
        table = c.cluster.router.slot_table()
        c.get_bucket("snap:k").set(1)
        moved = [s for s in range(16384) if table[s] == 0][:10]
        c.cluster.migrate_slots(moved, 3)
        c.cluster.mesh_client.snapshot_now()
        want = c.cluster.router.slot_table()
    finally:
        c.shutdown()
    c = mesh_cluster(tmp_path, "mesh", sub="snap")
    try:
        assert c.cluster.router.slot_table() == want
        assert c.get_bucket("snap:k").get() == 1
    finally:
        c.shutdown()


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_collectives_equal_jax(seed):
    rng = np.random.default_rng(seed)
    mesh, sb, host = _mesh_bank(capacity=64, seed=seed)
    jmesh = jmesh_mod.get_mesh(8, axis=jmesh_mod.SLOT_AXIS)
    jsb = jmesh_mod.ShardedBank(jmesh, 64, 4)
    host[rng.integers(0, 64, 6)] = 0
    rows = rng.integers(0, 64, 13).astype(np.int32)
    target = int(rows[0])
    jrows = jengine.pad_rows_repeat(rows)

    jb = jengine.hll_bank_merge_rows_collective(
        jsb.place(jnp.asarray(host)), jnp.asarray(jrows), jnp.int32(target),
        mesh=jmesh)
    b = engine.hll_bank_merge_rows_collective(
        sb.place(torch.from_numpy(host.copy())), rows, target, mesh=mesh)
    assert np.array_equal(np.asarray(b), np.asarray(jb))

    jb, jcnt = jengine.hll_bank_merge_count_rows_collective(
        jsb.place(jnp.asarray(host)), jnp.asarray(jrows), jnp.int32(target),
        mesh=jmesh)
    b, cnt = engine.hll_bank_merge_count_rows_collective(
        sb.place(torch.from_numpy(host.copy())), rows, target, mesh=mesh)
    assert np.array_equal(np.asarray(b), np.asarray(jb))
    assert abs(float(cnt) - float(jcnt)) <= 1e-5 * float(jcnt)

    jcnt = jengine.hll_bank_count_rows_collective(
        jsb.place(jnp.asarray(host)), jnp.asarray(jrows), mesh=jmesh)
    cnt = engine.hll_bank_count_rows_collective(
        sb.place(torch.from_numpy(host.copy())), rows, mesh=mesh)
    assert abs(float(cnt) - float(jcnt)) <= 1e-5 * float(jcnt)

    jocc = jengine.hll_bank_occupancy_collective(
        jsb.place(jnp.asarray(host)), mesh=jmesh)
    occ = engine.hll_bank_occupancy_collective(
        sb.place(torch.from_numpy(host.copy())), mesh=mesh)
    assert int(occ) == int(jocc)


def test_tape_shard_column_equals_jax():
    rng = np.random.default_rng(9)
    shard_of = {f"t{i}": i % 3 for i in range(5)}.get
    planes, jplanes = [], []
    for i in range(5):
        plane = rng.integers(0, 30, 16384).astype(np.uint8)
        planes.append(encode("hll_add", f"t{i}", plane, cells=16384,
                             packed=False, nkeys=10, raw_bytes=80))
        jplanes.append(jencode("hll_add", f"t{i}", plane, cells=16384,
                               packed=False, nkeys=10, raw_bytes=80))
    rows = {f"t{i}": i for i in range(5)}.get
    tp = tape.encode_window(planes, rows, shard_of)
    jtp = jtape.encode_window(jplanes, rows, shard_of)
    assert np.array_equal(tp.table, jtp.table)
    assert np.array_equal(tp.wire, jtp.wire)
    assert tp.n_shards == jtp.n_shards == 3
    assert tape.encode_window(planes, rows).n_shards == 1
    assert jax.devices()[0].platform == "cpu"
