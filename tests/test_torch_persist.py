"""persist/ and checkpoint.py of the port on the CPU: the counterpart of
every test of tests/test_persist.py that needs nothing outside this slice,
then the same on-disk formats held between the two packages.

Port counterparts run on `RedissonTorch.create(Config().use_cuda(
device="cpu"))` with `use_persist(dir)`:

1. codec round-trips (plus torch tensors, encoded as their host arrays);
2. journal framing, group commit, rotation, compaction, torn tails, tails;
3. the durability property: a journal truncated at any byte offset
   recovers to exactly a committed prefix of the op stream;
4. kill-and-recover, snapshots, everysec, recovery stats, the config
   section, the checkpoint `.old` fallback;
5. the snapshot cut: taken while SETBIT/CLEAR and Bloom adds mutate cell
   tensors in place, it equals the state at its journal watermark;
9. the journal follower (warm standby): tailing and promoting mid-stream,
   queue mode, promotion of a crash image, resync under rotation and
   compaction, the PSYNC counters, the incremental watermark scanner; a
   queue-mode record the leader's caller can no longer change; the
   default config's device.

Cross-package, seeded op mixes (HLL add_ints and byte keys, Bloom, SETBIT
and CLEAR, delete, structure ops) through the JAX package's client
(single-device mode on the CPU) and the port's:

6. `encode_payload` gives the same bytes in both packages;
7. the two journals of one op stream hold equal (seq, target, kind,
   payload) records;
8. a JAX-written persist directory (snapshot + suffix, crash image)
   recovers in the port to exactly what JAX's own recovery gives
   (registers, cells, the structures keyspace; PFCOUNT within rel 1e-5),
   and the reverse; a port follower tailing a live JAX leader's directory
   ends bit-identical to the leader.
"""

import hashlib
import os
import pickle
import random
import shutil
import time

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.persist import codec as jcodec
from redisson_tpu.persist.journal import iter_records as jiter_records
from redisson_tpu_torch import checkpoint
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config, PersistConfig
from redisson_tpu_torch.persist import codec
from redisson_tpu_torch.persist import snapshotter as snap_mod
from redisson_tpu_torch.persist.follower import JournalFollower, _WatermarkScanner
from redisson_tpu_torch.persist.journal import (
    Journal,
    JournalGap,
    JournalTail,
    _list_segments,
    iter_records,
    last_seq_in_dir,
)

#: tests of tests/test_persist.py with no counterpart here, and why (none:
#: the journal follower is ported)
EXCLUDED = {}


def make_client(path=None, fsync="always", ingest="auto", **persist_kw):
    cfg = Config()
    cfg.use_cuda(device="cpu", ingest=ingest)
    if path is not None:
        cfg.use_persist(str(path), fsync=fsync, **persist_kw)
    return RedissonTorch.create(cfg)


def make_jax_client(path=None, fsync="always"):
    cfg = JConfig()
    cfg.use_tpu()
    if path is not None:
        cfg.use_persist(str(path)).fsync = fsync
    return RedissonTPU.create(cfg)


def _canon(obj, h):
    """Feed an identity-free rendering of `obj` into hash `h` (raw pickle
    bytes depend on object sharing and on the defining package)."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        h.update(repr(obj).encode())
    elif isinstance(obj, (bytearray, memoryview)):
        h.update(b"B" + bytes(obj))
    elif isinstance(obj, dict):
        h.update(b"{")
        for k, v in obj.items():
            _canon(k, h)
            h.update(b":")
            _canon(v, h)
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _canon(v, h)
            h.update(b",")
        h.update(b"]")
    elif isinstance(obj, (set, frozenset)):
        h.update(b"<")
        for r in sorted(repr(v) for v in obj):
            h.update(r.encode() + b",")
        h.update(b">")
    elif isinstance(obj, np.ndarray):
        h.update(str(obj.dtype).encode() + str(obj.shape).encode())
        h.update(obj.tobytes())
    else:
        h.update(type(obj).__name__.encode())
        state = getattr(obj, "__dict__", None)
        _canon(state if state is not None else repr(obj), h)


def structures_canon(client) -> str:
    """Digest of the structure tier's keyspace, the same for a JAX and a
    port dump of one keyspace (the record classes differ by package)."""
    ex = client._executor
    blob = ex.execute_barrier(client._routing.structures.dump_state).result()
    h = hashlib.sha256()
    _canon(pickle.loads(blob), h)
    return h.hexdigest()


def sketch_state(client) -> dict:
    """name -> ("hll", registers) or (otype, cells, sorted meta) of every
    sketch, through the executor (works on both packages' clients)."""
    ex = client._executor
    out = {}
    for name in sorted(ex.execute_sync("", "keys", {"pattern": "*"})):
        try:
            exported = ex.execute_sync(name, "hll_export", None)
        except TypeError:  # WRONGTYPE: the name holds a BitSet or a Bloom
            exported = None
        if exported is not None:
            out[name] = ("hll", np.asarray(exported[0], np.uint8).tobytes())
            continue
        exported = ex.execute_sync(name, "bits_export", None)
        if exported is not None:
            otype, cells, meta = exported[:3]
            out[name] = (str(otype), np.asarray(cells, np.uint8).tobytes(),
                         repr(sorted((meta or {}).items())))
    return out


def digest(client) -> str:
    """Bit-identical fingerprint of the data (versions excluded)."""
    h = hashlib.sha256()
    for name, entry in sketch_state(client).items():
        h.update(name.encode())
        for part in entry:
            h.update(part if isinstance(part, bytes) else part.encode())
    h.update(structures_canon(client).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# 1. codec
# ---------------------------------------------------------------------------

PAYLOADS = [
    None, True, False, 0, -1, 2**80, -(2**80), 1.5, float("inf"),
    "", "héllo", b"", b"\x00\xff" * 9,
    [1, "two", b"3", None], (4, (5, 6)), {"k": [1, 2], b"b": {"n": None}},
]
ARRAYS = [
    np.arange(7, dtype=np.uint32),
    np.zeros((3, 5), np.uint8),
    np.array([[1.5, -2.5]], np.float64),
    np.array([], np.int64),
]


class TestCodec:
    @pytest.mark.parametrize("value", PAYLOADS)
    def test_roundtrip_scalars_containers(self, value):
        out = codec.decode_payload(codec.encode_payload(value))
        assert out == value
        assert type(out) is type(value)

    @pytest.mark.parametrize("arr", ARRAYS)
    def test_roundtrip_ndarray(self, arr):
        out = codec.decode_payload(codec.encode_payload(arr))
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert np.array_equal(out, arr)

    def test_numpy_scalar_decays_to_python(self):
        assert codec.decode_payload(codec.encode_payload(np.uint32(7))) == 7

    def test_nested_payload_like_real_ops(self):
        payload = {"field": b"f1", "value": b"v1", "nx": False,
                   "items": [b"a", b"b"],
                   "scores": np.arange(3, dtype=np.float64)}
        out = codec.decode_payload(codec.encode_payload(payload))
        assert out["field"] == b"f1" and out["nx"] is False
        assert np.array_equal(out["scores"], payload["scores"])

    @pytest.mark.parametrize("dtype", [torch.int64, torch.uint8, torch.float32])
    def test_tensor_encodes_as_its_host_array(self, dtype):
        t = torch.arange(12, dtype=dtype).reshape(3, 4)
        blob = codec.encode_payload({"device_packed": t})
        assert blob == codec.encode_payload({"device_packed": t.numpy()})
        out = codec.decode_payload(blob)["device_packed"]
        assert isinstance(out, np.ndarray) and np.array_equal(out, t.numpy())


# ---------------------------------------------------------------------------
# 2. journal
# ---------------------------------------------------------------------------

class _Op:
    def __init__(self, target, kind, payload):
        self.target, self.kind, self.payload = target, kind, payload


class TestJournal:
    def test_append_read_roundtrip(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        j.append_run("set", [_Op("b1", "set", {"value": b"v"})])
        j.append_run("hput", [_Op("m1", "hput", {"field": b"f", "value": b"1"})])
        j.close()
        recs = list(iter_records(str(tmp_path)))
        assert [(r.seq, r.target, r.kind) for r in recs] == [
            (1, "b1", "set"), (2, "m1", "hput")]
        assert recs[0].payload == {"value": b"v"}

    def test_read_kinds_are_not_journaled(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        assert j.append_run("num_get", [_Op("b1", "num_get", {})]) == 0
        assert j.append_run("exists", [_Op("b1", "exists", {})]) == 0
        assert j.last_seq == 0
        j.close()
        assert list(iter_records(str(tmp_path))) == []

    def test_group_commit_defers_then_syncs_on_fill(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always", group_commit_runs=2,
                    fsync_interval_s=60.0)
        j.append_run("set", [_Op("a", "set", {"value": b"1"})], defer=True)
        assert j.durable_seq == 0  # deferred, group not full
        j.append_run("set", [_Op("b", "set", {"value": b"2"})], defer=True)
        assert j.durable_seq == 2  # group filled -> inline fsync
        j.close()

    def test_rotation_and_compaction(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        for i in range(3):
            j.append_run("set", [_Op(f"k{i}", "set", {"value": b"x"})])
        j.rotate()
        j.rotate()  # idempotent on an empty active segment
        j.append_run("set", [_Op("k3", "set", {"value": b"x"})])
        assert [b for b, _ in _list_segments(str(tmp_path))] == [1, 4]
        j.remove_segments_below(3)
        assert [b for b, _ in _list_segments(str(tmp_path))] == [4]
        assert [r.seq for r in iter_records(str(tmp_path), from_seq=3)] == [4]
        j.close()
        j2 = Journal(str(tmp_path), fsync="always")
        assert j2.last_seq == 4
        j2.append_run("set", [_Op("k4", "set", {"value": b"x"})])
        assert j2.last_seq == 5
        j2.close()

    def test_segment_size_rotation(self, tmp_path):
        j = Journal(str(tmp_path), fsync="off", segment_max_bytes=1 << 16)
        for i in range(20):
            j.append_run("set", [_Op(f"k{i}", "set", {"value": b"x" * 5000})])
        j.close()
        assert len(_list_segments(str(tmp_path))) > 1
        assert [r.seq for r in iter_records(str(tmp_path))] == list(range(1, 21))

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        for i in range(4):
            j.append_run("set", [_Op(f"k{i}", "set", {"value": b"y" * 100})])
        j.close()
        _, seg = _list_segments(str(tmp_path))[-1]
        size = os.path.getsize(seg)
        with open(seg, "r+b") as f:
            f.truncate(size - 37)  # mid-frame
        j2 = Journal(str(tmp_path), fsync="always")
        assert j2.last_seq == 3
        assert j2.stats()["recovered_tail_bytes"] > 0
        j2.append_run("set", [_Op("k", "set", {"value": b"z"})])
        j2.close()
        assert [r.seq for r in iter_records(str(tmp_path))] == [1, 2, 3, 4]

    def test_corrupt_crc_stops_replay_at_prefix(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        for i in range(3):
            j.append_run("set", [_Op(f"k{i}", "set", {"value": b"v" * 50})])
        j.close()
        _, seg = _list_segments(str(tmp_path))[-1]
        with open(seg, "r+b") as f:
            f.seek(os.path.getsize(seg) - 10)
            f.write(b"\xde\xad")
        assert [r.seq for r in iter_records(str(tmp_path))] == [1, 2]

    def test_tail_poll_and_gap(self, tmp_path):
        j = Journal(str(tmp_path), fsync="always")
        tail = JournalTail(str(tmp_path))
        j.append_run("set", [_Op("a", "set", {"value": b"1"})])
        assert [r.seq for r in tail.poll()] == [1]
        assert tail.poll() == []
        j.rotate()
        j.append_run("set", [_Op("b", "set", {"value": b"2"})])
        assert [r.seq for r in tail.poll()] == [2]  # follows rotation
        j.close()
        stale = JournalTail(str(tmp_path), from_seq=0)
        j2 = Journal(str(tmp_path), fsync="always")
        j2.remove_segments_below(2)
        with pytest.raises(JournalGap):
            stale.poll()
        j2.close()

    def test_last_seq_in_dir(self, tmp_path):
        assert last_seq_in_dir(str(tmp_path)) == 0
        j = Journal(str(tmp_path), fsync="always")
        j.append_run("set", [_Op("a", "set", {"value": b"1"})])
        j.close()
        assert last_seq_in_dir(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# 3. the durability property: truncate anywhere -> a committed prefix
# ---------------------------------------------------------------------------

def _write_ops(n_mix=3):
    """A deterministic mixed-op script; each call = exactly one journal
    record (all sync singleton dispatches)."""
    ops = []
    for i in range(n_mix):
        ops.append(lambda c, i=i: c.get_bucket(f"b{i}").set({"round": i}))
        ops.append(lambda c, i=i: c.get_map("m").put(f"f{i}", i * 11))
        ops.append(lambda c, i=i: c.get_bit_set("bits").set(i * 7 + 3, True))
        ops.append(lambda c, i=i: c.get_hyper_log_log("h").add_all(
            [f"u{i}-{k}" for k in range(50)]))
        ops.append(lambda c, i=i: c.get_atomic_long("ctr").add_and_get(i + 1))
    return ops


def test_truncate_anywhere_recovers_committed_prefix(tmp_path):
    ops = _write_ops()
    lead_dir = tmp_path / "leader"
    c = make_client(lead_dir, fsync="always")
    try:
        for op in ops:
            op(c)
        c.persist.journal.sync()
        committed = list(iter_records(str(lead_dir)))
        assert len(committed) == len(ops)

        golden = make_client()
        digests = {0: digest(golden)}
        try:
            for k, op in enumerate(ops, start=1):
                op(golden)
                digests[k] = digest(golden)
        finally:
            golden.shutdown()

        _, seg = _list_segments(str(lead_dir))[0]
        size = os.path.getsize(seg)
        rng = random.Random(0xD15C)
        offsets = sorted(rng.sample(range(1, size - 1), 6)) + [8, size]
        for t in offsets:
            crash_dir = tmp_path / f"crash-{t}"
            shutil.copytree(lead_dir, crash_dir)
            _, cseg = _list_segments(str(crash_dir))[0]
            with open(cseg, "r+b") as f:
                f.truncate(t)
            surviving = list(iter_records(str(crash_dir)))
            k = len(surviving)
            assert [r.seq for r in surviving] == list(range(1, k + 1))
            r = make_client(crash_dir, fsync="always")
            try:
                rec = r.persist.last_recovery
                if k:
                    assert rec["replayed"] == k and rec["replay_errors"] == 0
                else:
                    assert rec is None
                assert digest(r) == digests[k], (
                    f"truncate@{t}: recovered state != serial prefix of {k} ops")
            finally:
                r.shutdown()
            shutil.rmtree(crash_dir)
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 4. kill-and-recover + snapshots through the client
# ---------------------------------------------------------------------------

def _crash_image(src, dst):
    """Simulate kill -9: act on a copy of the on-disk state."""
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)


def test_kill_and_recover_full_replay(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    try:
        c.get_bucket("b1").set({"x": 1})
        c.get_hyper_log_log("h1").add_all([f"k{i}" for i in range(1000)])
        bs = c.get_bit_set("bits"); bs.set(5, True); bs.set(100, True)
        m = c.get_map("m1"); m.put("a", 1); m.put("b", 2)
        c.get_bloom_filter("bf").try_init(1000, 0.01)
        c.get_bloom_filter("bf").add("member-1")
        c.persist.journal.sync()
        expect_hll = c.get_hyper_log_log("h1").count()
        _crash_image(lead, tmp_path / "img")
    finally:
        c.shutdown()
    r = make_client(tmp_path / "img", fsync="always")
    try:
        assert r.persist.last_recovery["replay_errors"] == 0
        assert r.get_bucket("b1").get() == {"x": 1}
        assert r.get_map("m1").get("a") == 1 and r.get_map("m1").get("b") == 2
        assert r.get_bit_set("bits").get(5) and r.get_bit_set("bits").get(100)
        assert not r.get_bit_set("bits").get(6)
        assert r.get_hyper_log_log("h1").count() == expect_hll
        assert r.get_bloom_filter("bf").contains("member-1")
        seq0 = r.persist.journal.last_seq
        r.get_bucket("b2").set("post")
        assert r.persist.journal.last_seq == seq0 + 1
    finally:
        r.shutdown()


def test_snapshot_bounds_recovery_to_suffix(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    try:
        for i in range(10):
            c.get_map("m").put(f"f{i}", i)
        snap_path = c.snapshot_now()
        assert os.path.basename(snap_path).startswith("snap-")
        assert checkpoint.info(snap_path)["journal_seq"] == 10
        assert all(b > 10 for b, _ in _list_segments(str(lead)))
        c.get_bucket("after").set("suffix")
        c.persist.journal.sync()
        _crash_image(lead, tmp_path / "img")
        want = digest(c)
    finally:
        c.shutdown()
    r = make_client(tmp_path / "img", fsync="always")
    try:
        rec = r.persist.last_recovery
        assert rec["snapshot_seq"] == 10
        assert rec["replayed"] == 1  # ONLY the suffix replays
        assert r.get_bucket("after").get() == "suffix"
        assert r.get_map("m").get("f7") == 7
        assert digest(r) == want
    finally:
        r.shutdown()


def test_everysec_clean_shutdown_loses_nothing(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="everysec")
    try:
        for i in range(5):
            c.get_bucket(f"b{i}").set(i)
    finally:
        c.shutdown()  # close() flushes + fsyncs the tail
    assert [r.seq for r in iter_records(str(lead))] == [1, 2, 3, 4, 5]


def test_recovery_stats(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    try:
        c.get_bucket("b").set(1)
        _crash_image(lead, tmp_path / "img")
    finally:
        c.shutdown()
    r = make_client(tmp_path / "img", fsync="always")
    try:
        st = r.persist.stats()
        assert st["journal"]["last_seq"] == 1
        assert st["journal"]["segments"] >= 1
        assert st["recovery"]["replayed"] == 1
        assert st["snapshotter"]["snapshots_taken"] == 0
    finally:
        r.shutdown()


def test_recovery_stats_and_gauges(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    try:
        c.get_bucket("b").set(1)
        _crash_image(lead, tmp_path / "img")
    finally:
        c.shutdown()
    r = make_client(tmp_path / "img", fsync="always")
    try:
        gauges = r.metrics.snapshot()["gauges"]
        assert gauges["persist.last_seq"] == 1
        assert gauges["persist.replayed"] == 1
        assert gauges["persist.segments"] >= 1
        st = r.persist.stats()
        assert st["journal"]["last_seq"] == 1
        assert st["recovery"]["replayed"] == 1
        # the journal and snapshot disk meters of the memstat ledger
        assert r.memstat.meter_totals()["disk"] > 0
    finally:
        r.shutdown()


def test_persist_config_from_dict_and_redis_mode_guard(tmp_path):
    cfg = Config.from_dict({
        "persist": {"dir": str(tmp_path / "p"), "fsync": "off",
                    "snapshot_keep": 5},
    })
    assert isinstance(cfg.persist, PersistConfig)
    assert cfg.persist.fsync == "off" and cfg.persist.snapshot_keep == 5
    assert Config.from_json(cfg.to_json()) == cfg


def test_persist_config_section(tmp_path):
    cfg = Config()
    pc = cfg.use_persist(str(tmp_path / "p"), fsync="off", snapshot_keep=5)
    assert isinstance(cfg.persist, PersistConfig) and pc is cfg.persist
    assert cfg.persist.fsync == "off" and cfg.persist.snapshot_keep == 5
    assert cfg.use_persist() is pc and pc.dir == str(tmp_path / "p")
    with pytest.raises(ValueError):
        Config().use_persist(str(tmp_path), fsync="sometimes")
    with pytest.raises(TypeError):
        Config().use_persist(str(tmp_path), no_such_field=1)


def test_persist_dir_that_cannot_be_written_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_bytes(b"x")
    with pytest.raises(OSError):
        make_client(blocker / "sub")


def test_add_device_record_replays_in_either_layout(tmp_path):
    """`add_device` keys are journaled as their host copy (int64 [n]); a
    replay copies them back to the device. The JAX package journals the
    same keys as uint32 [n, 2] (the same bytes): the port replays that
    layout too."""
    keys = np.random.default_rng(9).integers(0, 2**64, 5000, dtype=np.uint64)
    lead = tmp_path / "lead"
    c = make_client(lead)
    try:
        c.get_hyper_log_log("dev").add_device(torch.from_numpy(keys.view(np.int64)))
        c.persist.journal.sync()
        (rec,) = list(iter_records(str(lead)))
        want = sketch_state(c)
    finally:
        c.shutdown()
    assert rec.payload["device_packed"].dtype == np.int64
    for payload in (rec.payload,
                    {"device_packed": keys.view(np.uint32).reshape(-1, 2)}):
        r = make_client()
        try:
            r._executor.execute_sync("dev", "hll_add", payload)
            assert sketch_state(r) == want
        finally:
            r.shutdown()


# ---------------------------------------------------------------------------
# 5. checkpoint .old fallback
# ---------------------------------------------------------------------------

def test_checkpoint_old_fallback_after_interrupted_swap(tmp_path):
    c = make_client()
    try:
        c.get_bit_set("bits").set(3, True)
        path = str(tmp_path / "ckpt")
        assert c.save_checkpoint(path) >= 1
        os.replace(path, path + ".old")
        assert checkpoint.info(path)["version"] == 1  # info() falls back
        c.get_bit_set("bits").set(3, False)
        assert c.load_checkpoint(path) >= 1  # load() falls back
        assert c.get_bit_set("bits").get(3)
        assert checkpoint.extra_file(path, "nope.bin") is None
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 6. the snapshot cut against in-place writes
# ---------------------------------------------------------------------------

def _replay_upto(records, seq):
    """A fresh client fed the journal's own records up to `seq`, in order."""
    ref = make_client()
    for rec in records:
        if rec.seq > seq:
            break
        ref._executor.execute_sync(rec.target, rec.kind, rec.payload)
    return ref


def _inplace_traffic(c, rng, rounds: int, sync: bool):
    """SETBIT / CLEAR batches and Bloom and HLL adds (all written in place)."""
    ex = c._executor
    futs = []
    for _ in range(rounds):
        idx = rng.integers(0, 4096, 64).astype(np.int64)
        kind = "bitset_set" if rng.random() < 0.5 else "bitset_clear"
        futs.append(ex.execute_async("bits", kind, {"idx": idx}, nkeys=64))
        futs.append(c.get_bloom_filter("bf").add_ints_async(
            rng.integers(0, 2**63, 200, dtype=np.uint64)))
        futs.append(c.get_hyper_log_log("h").add_ints_async(
            rng.integers(0, 2**63, 200, dtype=np.uint64)))
        if sync:
            for f in futs:
                f.result()
            futs = []
    return futs


def test_snapshot_cut_equals_state_at_its_watermark(tmp_path, monkeypatch):
    """SETBIT/CLEAR and Bloom adds write their cell tensors in place. A
    snapshot is cut, and before its host copies are taken more of that
    traffic lands; the snapshot must still equal the journal's records up
    to its watermark, replayed (a cut that kept the live tensors would
    carry the later writes onto the disk)."""
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always", ingest="segment")
    rng = np.random.default_rng(7)
    c.get_bit_set("bits").set(4095, True)
    c.get_bloom_filter("bf").try_init(20_000, 0.01)
    _inplace_traffic(c, rng, 30, sync=True)
    c.persist.journal.sync()
    _crash_image(lead, tmp_path / "prefix")  # every record the cut covers
    real_host_objects = snap_mod.Snapshotter._host_objects

    def late_host_copies(cut):
        for f in _inplace_traffic(c, rng, 30, sync=False):
            f.result()  # lands between the cut and its host copies
        return real_host_objects(cut)

    monkeypatch.setattr(snap_mod.Snapshotter, "_host_objects",
                        staticmethod(late_host_copies))
    try:
        snap_path = c.snapshot_now()
        seq = checkpoint.info(snap_path)["journal_seq"]
        c.persist.journal.sync()
        assert c.persist.journal.last_seq >= seq + 90  # the later traffic
    finally:
        c.shutdown()
    records = list(iter_records(str(tmp_path / "prefix")))
    assert records[-1].seq == seq
    got = make_client()
    ref = _replay_upto(records, seq)
    try:
        got.load_checkpoint(snap_path)
        assert sketch_state(got) == sketch_state(ref)
    finally:
        got.shutdown()
        ref.shutdown()


# ---------------------------------------------------------------------------
# 7. cross-package: codec bytes, journal records, recovery both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", PAYLOADS + ARRAYS + [
    {"packed": np.arange(16, dtype=np.uint32).reshape(8, 2)},
    {"data": np.zeros((3, 16), np.uint8), "lengths": np.array([1, 2, 3], np.int32)},
    {"idx": np.array([5, 1 << 40], np.int64), "scores": np.float64(2.5)},
], ids=lambda v: type(v).__name__)
def test_codec_bytes_equal_jax(value):
    blob = codec.encode_payload(value)
    assert blob == jcodec.encode_payload(value)
    # each package decodes the other's bytes to the same value
    assert jcodec.encode_payload(codec.decode_payload(blob)) == blob
    assert codec.encode_payload(jcodec.decode_payload(blob)) == blob


def _op_mix(client, seed: int):
    """Seeded sketch + structure traffic, every op synchronous (one run
    each), so both packages journal the same stream."""
    rng = np.random.default_rng(seed)
    hs = [client.get_hyper_log_log(f"h{i}") for i in range(3)]
    bits = client.get_bit_set("bits")
    bf = client.get_bloom_filter("bf")
    bf.try_init(5000, 0.01)
    for i in range(4):
        for j, h in enumerate(hs):
            h.add_ints(rng.integers(0, 2**64, 300 + 50 * j, dtype=np.uint64,
                                    endpoint=False))
            h.add_all([f"user:{i}:{j}:{k}" for k in range(20)])
        bf.add_ints(rng.integers(0, 2**64, 200, dtype=np.uint64, endpoint=False))
        bf.add_all([f"bloom:{i}:{k}" for k in range(10)])
        for off in rng.integers(0, 2000, 6):
            bits.set(int(off), True)
        bits.set(int(rng.integers(0, 2000)), False)
        client.get_map("m").put(f"f{i}", i * 3)
        client.get_bucket(f"b{i}").set({"i": i})
        client.get_atomic_long("ctr").add_and_get(i + 1)
    client.get_hyper_log_log("gone").add_all(["x", "y"])
    client.get_hyper_log_log("gone").delete()
    client.get_bucket("b0").delete()


def _tail_mix(client, seed: int):
    rng = np.random.default_rng(seed + 1)
    client.get_hyper_log_log("h0").add_ints(
        rng.integers(0, 2**64, 500, dtype=np.uint64, endpoint=False))
    client.get_bit_set("bits").set(7, False)
    client.get_bit_set("bits").set(2500, True)
    client.get_bloom_filter("bf").add_all(["tail-a", "tail-b"])
    client.get_hyper_log_log("h2").delete()
    client.get_map("m").put("tail", "t")


def _records(iterable):
    return [(r.seq, r.target, r.kind, codec.encode_payload(r.payload))
            for r in iterable]


def test_journals_of_one_op_stream_hold_equal_records(tmp_path):
    jc = make_jax_client(tmp_path / "jax")
    tc = make_client(tmp_path / "port")
    try:
        _op_mix(jc, 11)
        _op_mix(tc, 11)
    finally:
        jc.shutdown()
        tc.shutdown()
    jrecs = _records(jiter_records(str(tmp_path / "jax")))
    trecs = _records(iter_records(str(tmp_path / "port")))
    assert len(trecs) > 50
    assert trecs == jrecs
    # each package reads the other's segment files
    assert _records(iter_records(str(tmp_path / "jax"))) == jrecs
    assert _records(jiter_records(str(tmp_path / "port"))) == trecs


def _write_dir(client, path: str, seed: int) -> None:
    """Op mix, snapshot, a suffix, then a crash image under `path`.img."""
    _op_mix(client, seed)
    client.snapshot_now()
    _tail_mix(client, seed)
    client.persist.journal.sync()
    _crash_image(path, path + ".img")


def _recovered(make, path):
    c = make(path)
    try:
        assert c.persist.last_recovery["replay_errors"] == 0
        assert c.persist.last_recovery["replayed"] > 0
        counts = {n: c.get_hyper_log_log(n).count() for n in ("h0", "h1")}
        return sketch_state(c), structures_canon(c), counts
    finally:
        c.shutdown()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persist_dir_recovers_in_either_package(tmp_path, writer):
    make_writer = make_jax_client if writer == "jax" else make_client
    lead = str(tmp_path / "lead")
    c = make_writer(lead)
    try:
        _write_dir(c, lead, 5)
    finally:
        c.shutdown()
    img = lead + ".img"
    shutil.copytree(img, img + ".jax")
    shutil.copytree(img, img + ".port")
    jstate, jstruct, jcounts = _recovered(make_jax_client, img + ".jax")
    tstate, tstruct, tcounts = _recovered(make_client, img + ".port")
    assert tstate.keys() == jstate.keys()
    for name in jstate:
        assert tstate[name] == jstate[name], name
    assert tstruct == jstruct
    for n, want in jcounts.items():
        assert abs(tcounts[n] - want) <= 1e-5 * want
    assert "gone" not in tstate and "h2" not in tstate


def test_port_follower_tails_a_jax_leader_bit_identically(tmp_path):
    """A port JournalFollower bootstraps from a live JAX leader's snapshot,
    tails its journal while it writes, and promotes to exactly the
    leader's registers, cells and structures keyspace."""
    lead = str(tmp_path / "lead")
    jc = make_jax_client(lead)
    follower = None
    try:
        _op_mix(jc, 21)
        jc.snapshot_now()
        follower = _follower(lead, poll_interval_s=0.005)
        follower.start()
        _tail_mix(jc, 21)
        _op_mix(jc, 22)
        jc.persist.journal.sync()
        promoted = follower.promote(catch_up=True, timeout_s=30)
        st = follower.stats()
        assert st["applied_seq"] == jc.persist.journal.last_seq
        assert st["apply_errors"] == 0 and st["full_resyncs"] == 1
        assert sketch_state(promoted) == sketch_state(jc)
        assert structures_canon(promoted) == structures_canon(jc)
        for n in ("h0", "h1"):
            want = jc.get_hyper_log_log(n).count()
            assert abs(promoted.get_hyper_log_log(n).count() - want) <= 1e-5 * want
    finally:
        if follower is not None:
            follower.close()
        jc.shutdown()


# ---------------------------------------------------------------------------
# 9. follower / warm standby
# ---------------------------------------------------------------------------

def cpu_config():
    return Config().use_cuda(device="cpu")


def _follower(path, **kw):
    return JournalFollower(str(path), config=Config(cuda=cpu_config()), **kw)


def test_follower_tails_and_promotes_mid_stream(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    follower = None
    try:
        for i in range(4):
            c.get_map("m").put(f"f{i}", i)
        follower = _follower(lead, poll_interval_s=0.01)
        follower.start()
        # keep writing while the follower is live, then promote mid-stream:
        # the drain inside promote() must pick up whatever it hadn't applied
        for i in range(4, 12):
            c.get_map("m").put(f"f{i}", i)
        c.get_bit_set("bits").set(9, True)
        c.persist.journal.sync()
        leader_digest = digest(c)
        promoted = follower.promote(catch_up=True, timeout_s=30)
        assert follower.lag() == 0
        assert digest(promoted) == leader_digest
        assert promoted.get_map("m").get("f11") == 11
        st = follower.stats()
        assert st["applied_seq"] == c.persist.journal.last_seq
        assert st["apply_errors"] == 0
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()


def test_follower_queue_mode_attach(tmp_path):
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="off")  # queue mode needs no disk flushes
    follower = None
    try:
        follower = _follower(lead, poll_interval_s=0.01)
        follower.attach(c.persist.journal)
        follower.start()
        for i in range(6):
            c.get_bucket(f"b{i}").set(i * 3)
        promoted = follower.promote(catch_up=True, timeout_s=30)
        for i in range(6):
            assert promoted.get_bucket(f"b{i}").get() == i * 3
        assert follower.stats()["mode"] == "queue"
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()


def test_follower_rejects_persisting_config(tmp_path):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_persist(str(tmp_path / "f"))
    with pytest.raises(ValueError):
        JournalFollower(str(tmp_path / "lead"), config=cfg)


def test_promote_under_mid_window_crash_equals_committed_prefix(tmp_path):
    """Satellite of the truncate-anywhere property, pointed at PROMOTION:
    the primary dies between journal append and backend apply (simulated
    by truncating its journal at an arbitrary byte — write-ahead order
    makes truncation exactly that interleaving), a follower bootstraps
    from the crash image and promotes; the promoted engine must equal the
    serial execution of the surviving committed prefix, bit-identical."""
    ops = _write_ops(n_mix=3)
    lead_dir = tmp_path / "leader"
    c = make_client(lead_dir, fsync="always")
    try:
        for op in ops:
            op(c)
        c.persist.journal.sync()
    finally:
        c.shutdown()

    golden = make_client()
    digests = {0: digest(golden)}
    try:
        for k, op in enumerate(ops, start=1):
            op(golden)
            digests[k] = digest(golden)
    finally:
        golden.shutdown()

    _, seg = _list_segments(str(lead_dir))[0]
    size = os.path.getsize(seg)
    rng = random.Random(0xFA110)
    for t in sorted(rng.sample(range(1, size - 1), 4)) + [size]:
        crash_dir = tmp_path / f"crash-{t}"
        shutil.copytree(lead_dir, crash_dir)
        _, cseg = _list_segments(str(crash_dir))[0]
        with open(cseg, "r+b") as f:
            f.truncate(t)
        k = len(list(iter_records(str(crash_dir))))
        follower = _follower(crash_dir, poll_interval_s=0.01)
        try:
            promoted = follower.promote(catch_up=True, timeout_s=30)
            assert follower.applied_seq == k
            assert follower.stats()["apply_errors"] == 0
            assert digest(promoted) == digests[k], (
                f"truncate@{t}: promoted state != serial prefix of {k} ops")
        finally:
            follower.close()
        shutil.rmtree(crash_dir)


def test_follower_resync_under_rotation_and_compaction(tmp_path):
    """A replica tailing while the leader rotates AND compacts
    (`snapshot_now` truncates covered segments) must either partial-resync
    or cleanly full-resync — never apply a torn suffix — and converge to
    the leader's exact state."""
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always", segment_max_bytes=1 << 16)
    follower = None
    try:
        for i in range(20):
            c.get_map("m").put(f"f{i}", i)
        follower = _follower(lead, poll_interval_s=0.005)
        follower.start()
        # Interleave traffic with rotation + snapshot-compaction; the big
        # payloads force several segment rollovers under the follower.
        for round_ in range(4):
            for i in range(8):
                c.get_bucket(f"r{round_}-{i}").set("x" * 4000)
            c.persist.journal.rotate()
            c.snapshot_now()  # compacts: remove_segments_below(watermark)
        for i in range(5):
            c.get_map("m").put(f"tail{i}", i)
        c.persist.journal.sync()
        leader_digest = digest(c)
        leader_seq = c.persist.journal.last_seq
        promoted = follower.promote(catch_up=True, timeout_s=30)
        st = follower.stats()
        assert st["applied_seq"] == leader_seq
        assert st["apply_errors"] == 0  # a torn suffix would error here
        assert st["full_resyncs"] >= 1  # initial bootstrap counts as full
        assert digest(promoted) == leader_digest
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()


def test_follower_partial_vs_full_resync_counters(tmp_path):
    """PSYNC parity: a resync with the suffix still on disk is partial
    (state kept, tail re-opened at the cursor); one whose suffix was
    compacted away is full (snapshot re-bootstrap). Initial bootstrap
    counts as full, mirroring redis sync_full."""
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    follower = None
    try:
        for i in range(10):
            c.get_map("m").put(f"f{i}", i)
        c.persist.journal.sync()
        follower = _follower(lead, poll_interval_s=0.005)
        follower.start()
        deadline = time.monotonic() + 30
        while follower.lag() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert follower._full_resyncs == 1 and follower._partial_resyncs == 0
        # Retarget to the SAME dir: suffix available at the cursor -> partial.
        follower.retarget(str(lead))
        assert follower._partial_resyncs == 1 and follower._full_resyncs == 1
        # Compact history past the cursor while appending more, then force
        # a resync: the suffix is gone -> full snapshot bootstrap.
        follower.close(shutdown_client=False)
        for i in range(10, 16):
            c.get_map("m").put(f"f{i}", i)
        c.persist.journal.rotate()  # seal seqs 1..16 so compaction can drop them
        c.snapshot_now()  # remove_segments_below: history past the cursor gone
        c.get_map("m").put("post", 99)
        c.persist.journal.sync()
        follower.retarget(str(lead))
        assert follower._full_resyncs == 2 and follower._partial_resyncs == 1
        promoted = follower.promote(catch_up=True, timeout_s=30)
        assert promoted.get_map("m").get("post") == 99
        assert digest(promoted) == digest(c)
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()


def test_watermark_scanner_incremental_lag(tmp_path):
    """Satellite: file-mode lag() must not rescan the whole journal per
    call. The incremental scanner tracks appends, rotation, and
    compaction, agreeing with last_seq_in_dir at every step while only
    re-anchoring on actual segment events."""
    j = Journal(str(tmp_path), fsync="always")
    scanner = _WatermarkScanner(str(tmp_path))
    assert scanner.last_seq() == 0
    for i in range(5):
        j.append_run("set", [_Op(f"k{i}", "set", {"value": b"x"})])
        assert scanner.last_seq() == i + 1 == last_seq_in_dir(str(tmp_path))
    anchors = scanner.rescans
    j.rotate()
    j.append_run("set", [_Op("k5", "set", {"value": b"y"})])
    assert scanner.last_seq() == 6 == last_seq_in_dir(str(tmp_path))
    # Rotation follows the base==last+1 chain without a re-anchor.
    assert scanner.rescans == anchors
    j.remove_segments_below(5)  # drops the first segment (our history)
    j.append_run("set", [_Op("k6", "set", {"value": b"z"})])
    assert scanner.last_seq() == 7 == last_seq_in_dir(str(tmp_path))
    # Steady state: repeated calls with no appends never re-anchor.
    anchors = scanner.rescans
    for _ in range(10):
        assert scanner.last_seq() == 7
    assert scanner.rescans == anchors
    j.close()


def test_queue_mode_records_outlive_the_callers_buffers(tmp_path):
    """Queue mode hands the follower each record as its framed bytes
    decode: a host buffer the caller refills, and a key tensor it zeroes,
    right after their PFADDs are acknowledged, reach the follower as they
    were when appended. Records wait in the queue (the follower is not
    started) until promote() applies them."""
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="off", ingest="segment")
    follower = None
    try:
        follower = _follower(lead, poll_interval_s=0.01)
        follower.attach(c.persist.journal)
        rng = np.random.default_rng(5)
        buf = rng.integers(0, 2**63, 3000, dtype=np.uint64)
        c.get_hyper_log_log("host").add_ints(buf)  # borrowed, then released
        buf[:] = rng.integers(0, 2**63, 3000, dtype=np.uint64)
        c.get_hyper_log_log("host2").add_ints(buf)
        buf[:] = 0
        keys = torch.from_numpy(rng.integers(0, 2**63, 3000, dtype=np.int64))
        c.get_hyper_log_log("dev").add_device(keys)
        keys.zero_()
        c.get_bit_set("bits").set_bits(np.arange(0, 4000, 7))
        assert len(follower._queue) == 4
        want = digest(c)
        promoted = follower.promote(catch_up=True, timeout_s=30)
        assert follower.stats()["apply_errors"] == 0
        assert digest(promoted) == want
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()


def test_follower_default_config_asks_for_the_card(tmp_path, monkeypatch):
    """JournalFollower(path) with no config runs on cuda:0 (the JAX
    follower's default is local mode on the CPU): without a card it raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JournalFollower(str(tmp_path / "lead"))



def test_follower_record_filter_projects_records_and_counts_position(tmp_path):
    """`record_filter` drops or rewrites records after the seq cursor
    advances: dropped records count as applied (lag measures journal
    position), and only what passes reaches the follower's engine."""
    lead = tmp_path / "lead"
    c = make_client(lead, fsync="always")
    follower = None
    try:
        for i in range(6):
            c.get_bucket(f"keep{i}").set(i)
            c.get_bucket(f"drop{i}").set(i)
        follower = _follower(lead, poll_interval_s=0.005,
                             record_filter=lambda r: None
                             if r.target.startswith("drop") else r)
        promoted = follower.promote(catch_up=True, timeout_s=30)
        assert follower.applied_seq == c.persist.journal.last_seq == 12
        assert follower.lag() == 0
        st = follower.stats()
        assert st["records_applied"] == 6 and st["apply_errors"] == 0
        assert sorted(promoted.keys()) == [f"keep{i}" for i in range(6)]
    finally:
        if follower is not None:
            follower.close()
        c.shutdown()
