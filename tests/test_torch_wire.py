"""wire/, the RESP codec of native.py and loopwitness.py of the port on the
CPU: the counterpart of every test of tests/test_wire.py and
tests/test_wire_cluster.py, then the port held against the JAX package.

Counterparts (servers on `Config().use_cuda(device="cpu")` with
`use_wire()`; the client is the JAX package's
`interop.resp_client.SyncRespClient`, raw sockets speak through the port's
own `resp_encode` / `RespParser`):

1. frame rendering and the one codec per direction;
2. conformance of the command table against the facade, BITOP, the
   introspection surface, HELLO 2 / 3, SLOWLOG's admitted stage (and
   redis-py, when it is installed);
3. pipeline reply order, inline replies behind engine commands, two
   connections;
4. sheds: the per-connection inflight cap in position, the connection
   limit, RejectedError rendered as -BUSY with its retry hint;
5. the wire_conn fault seam: a dropped connection loses no
   acknowledgement and misattributes no reply;
6. lifecycle: shutdown stops the listener, the wire.* gauges, AUTH;
7. the cluster front-end: a followable -MOVED, CLUSTER KEYSLOT / INFO /
   SLOTS and HELLO over the wire, ownership moving on the wire with a live
   migration, the frontend's summed snapshot, -ASK / -MOVED rendering
   against stub cluster state.

Against the JAX package:

8. the port's codec against JAX's on seeded frames: whole frames, the
   same stream split at every byte, RESP3 type bytes and protocol errors
   (the poisoned parser), pipelines the encoders write;
9. one command stream to a JAX WireServer and to the port's, reply bytes
   equal except the fields that carry an id, a port or the engine's name
   (`DIFFERING`); the same on a 2-shard cluster front-end (CLUSTER SLOTS
   and -MOVED equal up to the ports);
10. the wire.* gauge names equal JAX's; the loop witness's gauges.
"""

import socket
import time

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.interop.resp_client import SyncRespClient
from redisson_tpu.native import RespParser as JRespParser
from redisson_tpu.native import resp_encode_pipeline as jencode_pipeline
from redisson_tpu.observability import MetricsRegistry as JMetricsRegistry
from redisson_tpu.observability import register_wire as jregister_wire
from redisson_tpu.wire import proto as jproto
from redisson_tpu_torch import loopwitness, native
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.fault import inject
from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan, FaultRule
from redisson_tpu_torch.observability import MetricsRegistry, register_wire
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.wire import proto
from redisson_tpu_torch.wire.server import ShardWireContext

#: tests of tests/test_wire.py / test_wire_cluster.py with no counterpart
#: here, and why
EXCLUDED = {}

#: reply fields that carry an id, a port or the engine's name, and so may
#: differ between the JAX package's server and the port's
DIFFERING = {
    "HELLO": ("id", "mode"),  # connection id; "local" (JAX) / "standalone"
    "CLIENT ID": "the connection id",
    "CLIENT INFO": "id= and addr= (the peer's port)",
    "INFO": "client_id, and the server section's mode and device",
    "CLUSTER SLOTS": "each master's port",
    "-MOVED / -ASK": "the destination's port",
}


def _wire_client(**wire_kw):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_serve()
    cfg.use_trace(sample_every=1, slowlog_threshold_ms=0.0)
    cfg.use_wire(**wire_kw)
    return RedissonTorch.create(cfg)


def _jax_wire_client(**wire_kw):
    cfg = JConfig()
    cfg.use_serve()
    tr = cfg.use_trace()
    tr.sample_every = 1
    tr.slowlog_threshold_ms = 0.0
    w = cfg.use_wire()
    for k, v in wire_kw.items():
        setattr(w, k, v)
    return RedissonTPU(cfg)


def _connect(c, **kw):
    cli = SyncRespClient("127.0.0.1", c.wire.port, retry_attempts=1, **kw)
    cli.connect()
    return cli


def _raw_connect(c):
    s = socket.create_connection(("127.0.0.1", c.wire.port), timeout=5.0)
    s.settimeout(5.0)
    return s


def _raw_read_frames(sock, parser, n, deadline_s=5.0):
    """Read exactly n frames from a raw socket, or fewer on EOF."""
    frames = []
    end = time.monotonic() + deadline_s
    while len(frames) < n and time.monotonic() < end:
        try:
            data = sock.recv(65536)
        except socket.timeout:
            break
        if not data:
            break
        frames.extend(parser.feed(data))
    return frames


# ---------------------------------------------------------------------------
# 1. proto: frame rendering + one codec per direction
# ---------------------------------------------------------------------------


class TestProto:
    def test_simple_frames(self):
        assert proto.ok() == b"+OK\r\n"
        assert proto.simple("PONG") == b"+PONG\r\n"
        assert proto.integer(42) == b":42\r\n"
        assert proto.bulk(b"ab\r\nc") == b"$5\r\nab\r\nc\r\n"
        assert proto.bulk(None) == b"$-1\r\n"
        assert proto.array([proto.integer(1), proto.bulk(b"x")]) == (
            b"*2\r\n:1\r\n$1\r\nx\r\n")

    def test_err_flattens_newlines(self):
        frame = proto.err("bad\r\nthing", code="ERR")
        assert frame.startswith(b"-ERR ")
        assert frame.endswith(b"\r\n")
        assert frame.count(b"\r\n") == 1

    def test_null_per_protocol(self):
        assert proto.null(proto.RESP2) == b"$-1\r\n"
        assert proto.null(proto.RESP3) == b"_\r\n"

    def test_map_reply_resp2_vs_resp3(self):
        pairs = [(b"a", proto.integer(1))]
        assert proto.map_reply(pairs, proto.RESP2).startswith(b"*2\r\n")
        assert proto.map_reply(pairs, proto.RESP3).startswith(b"%1\r\n")

    def test_redirect_and_busy_frames(self):
        assert proto.moved(100, "1.2.3.4:7000") == b"-MOVED 100 1.2.3.4:7000\r\n"
        assert proto.ask(100, "1.2.3.4:7000") == b"-ASK 100 1.2.3.4:7000\r\n"
        assert proto.busy("shed", 0.05).startswith(b"-BUSY retry_after=0.050s")

    def test_roundtrip_through_parser(self):
        p = proto.RespParser()
        frames = p.feed(proto.array([proto.integer(7), proto.bulk(b"hi")]))
        assert frames == [[7, b"hi"]]
        p.close()

    def test_port_codec_is_the_native_library_s(self):
        # One implementation per direction: proto re-exports the codec of
        # the port's host library, and the cluster tier renders redirects
        # with proto's renderers.
        from redisson_tpu_torch.cluster.errors import (SlotAskError,
                                                       SlotMovedError,
                                                       render_redirect)

        assert proto.RespParser is native.RespParser
        assert proto.resp_encode is native.resp_encode
        assert proto.RespError is native.RespError
        assert render_redirect(SlotMovedError(9), "h:1") == proto.moved(9, "h:1")
        assert render_redirect(SlotAskError(9), "h:2") == proto.ask(9, "h:2")

    def test_fake_server_uses_shared_codec(self):
        # The port's embedded RESP server renders with proto's functions,
        # and parses with the port's C++ codec through proto.
        from redisson_tpu_torch.interop import fake_server

        assert fake_server._ok is proto.ok
        assert fake_server._err is proto.err
        assert fake_server._int is proto.integer
        assert fake_server._bulk is proto.bulk
        assert fake_server._array is proto.array
        assert fake_server.proto is proto

    def test_resp_client_uses_shared_codec(self):
        import redisson_tpu_torch.interop.resp_client as rc

        assert rc.proto is proto
        assert rc.RespError is proto.RespError is native.RespError
        assert rc.proto.RespParser is native.RespParser

    def test_port_codec_has_no_python_fallback(self, monkeypatch):
        monkeypatch.setattr(native, "_load", lambda: None)
        with pytest.raises(RuntimeError, match="host fold library"):
            native.RespParser()
        with pytest.raises(RuntimeError, match="host fold library"):
            native.resp_encode(b"PING")


# ---------------------------------------------------------------------------
# 2. conformance: wire vs facade on golden vectors
# ---------------------------------------------------------------------------


GOLDEN_HLL = [b"alpha", b"beta", b"gamma", b"\x00\xffbin", b"alpha"]
GOLDEN_BITS = [0, 1, 7, 63, 300]


class TestConformance:
    def test_command_table_matches_facade(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                assert cli.execute("PFADD", "w:hll", *GOLDEN_HLL) == 1
                assert cli.execute("PFADD", "w:hll2", b"delta", b"beta") == 1
                wire_count = cli.execute("PFCOUNT", "w:hll")
                wire_union = cli.execute("PFCOUNT", "w:hll", "w:hll2")
                assert cli.execute("PFMERGE", "w:dest", "w:hll", "w:hll2") == b"OK"
                wire_merged = cli.execute("PFCOUNT", "w:dest")

                f = c.get_hyper_log_log("f:hll")
                f.add_all(list(GOLDEN_HLL))
                f2 = c.get_hyper_log_log("f:hll2")
                f2.add_all([b"delta", b"beta"])
                assert wire_count == f.count()
                assert wire_union == f.count_with("f:hll2")
                dest = c.get_hyper_log_log("f:dest")
                dest.merge_with("f:hll", "f:hll2")
                assert wire_merged == dest.count()

                for i in GOLDEN_BITS:
                    assert cli.execute("SETBIT", "w:bits", str(i), "1") == 0
                assert cli.execute("SETBIT", "w:bits", "1", "0") == 1
                assert cli.execute("GETBIT", "w:bits", "7") == 1
                assert cli.execute("GETBIT", "w:bits", "1") == 0
                fb = c.get_bit_set("f:bits")
                for i in GOLDEN_BITS:
                    fb.set(i)
                fb.clear(1)
                assert cli.execute("BITCOUNT", "w:bits") == fb.cardinality()

                assert cli.execute("EXISTS", "w:hll", "w:bits", "w:nope") == 2
                assert cli.execute("DBSIZE") == len(c.keys())
                assert cli.execute("DEL", "w:hll2") == 1
                assert cli.execute("EXISTS", "w:hll2") == 0
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_bitop_over_wire(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                cli.execute("SETBIT", "a", "0", "1")
                cli.execute("SETBIT", "a", "3", "1")
                cli.execute("SETBIT", "b", "3", "1")
                cli.execute("SETBIT", "b", "9", "1")
                nbytes = cli.execute("BITOP", "AND", "a", "a", "b")
                assert isinstance(nbytes, int) and nbytes >= 1
                assert cli.execute("BITCOUNT", "a") == 1
                assert cli.execute("GETBIT", "a", "3") == 1
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_introspection_surface(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                assert cli.execute("PING") == b"PONG"
                assert cli.execute("ECHO", "hey") == b"hey"
                info = cli.execute("INFO")
                assert b"# wire" in info and b"redis_version" in info
                cli.execute("PFADD", "m:k", "x")
                usage = cli.execute("MEMORY", "USAGE", "m:k")
                assert isinstance(usage, int) and usage > 0
                assert cli.execute("MEMORY", "USAGE", "m:missing") is None
                stats = cli.execute("MEMORY", "STATS")
                assert isinstance(stats, list) and stats
                assert isinstance(cli.execute("MEMORY", "DOCTOR"), bytes)
                assert isinstance(cli.execute("SLOWLOG", "LEN"), int)
                assert isinstance(cli.execute("SLOWLOG", "GET"), list)
                assert cli.execute("SLOWLOG", "RESET") == b"OK"
                assert cli.execute("CLUSTER", "KEYSLOT", "m:k") == key_slot(b"m:k")
                assert cli.execute("SELECT", "0") == b"OK"
                assert isinstance(cli.execute("COMMAND", "COUNT"), int)
                assert isinstance(cli.execute("CLIENT", "ID"), int)
                assert cli.execute("CLIENT", "SETNAME", "t1") == b"OK"
                assert cli.execute("CLIENT", "GETNAME") == b"t1"
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_hello_negotiates_resp3(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                h2 = cli.execute("HELLO", "2")
                assert isinstance(h2, list)  # RESP2 renders map as flat array
                assert b"proto" in h2
            finally:
                cli.close()
            # The parser is RESP2-only: check the RESP3 map upgrade at the
            # byte level on a raw socket.
            sock = _raw_connect(c)
            try:
                sock.sendall(proto.resp_encode(b"HELLO", b"3"))
                data = b""
                while b"modules" not in data:
                    chunk = sock.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                assert data.startswith(b"%")  # RESP3 map header
                assert b"proto\r\n:3\r\n" in data
            finally:
                sock.close()
        finally:
            c.shutdown()

    def test_slowlog_entries_carry_admitted_stage(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                cli.execute("PFADD", "sl:k", "v1", "v2")
                cli.execute("PFCOUNT", "sl:k")
            finally:
                cli.close()
            # an op's span finishes in a done-callback: poll for it
            deadline = time.monotonic() + 10
            while True:
                entries = c.trace.slowlog.get(None)
                names = {ev[0] for e in entries for ev in e.events}
                if "admitted" in names or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            assert entries
            assert "admitted" in names
        finally:
            c.shutdown()

    def test_redis_py_roundtrip(self):
        redis = pytest.importorskip("redis")
        c = _wire_client()
        try:
            r = redis.Redis(host="127.0.0.1", port=c.wire.port)
            assert r.ping()
            assert r.pfadd("rp:hll", "a", "b", "c") == 1
            assert r.pfcount("rp:hll") == c.get_hyper_log_log("rp:hll").count()
            assert r.setbit("rp:bits", 5, 1) == 0
            assert r.getbit("rp:bits", 5) == 1
            assert r.bitcount("rp:bits") == 1
            r.close()
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# 3. reply ordering
# ---------------------------------------------------------------------------


class TestReplyOrder:
    def test_pipeline_replies_in_submission_order(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                cmds, expect = [], []
                for i in range(16):
                    cmds.append(("SETBIT", "ord:bits", str(i), "1"))
                    expect.append(0)
                    cmds.append(("ECHO", "m%d" % i))
                    expect.append(b"m%d" % i)
                assert cli.pipeline(cmds) == expect
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_inline_replies_ordered_behind_engine_commands(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                out = cli.pipeline([("PFADD", "q:k", "a"), ("PING",),
                                    ("PFCOUNT", "q:k"), ("PING",)])
                assert out == [1, b"PONG", 1, b"PONG"]
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_two_connections_do_not_cross_replies(self):
        c = _wire_client()
        try:
            a, b = _connect(c), _connect(c)
            try:
                oa = a.pipeline([("ECHO", "from-a%d" % i) for i in range(8)])
                ob = b.pipeline([("ECHO", "from-b%d" % i) for i in range(8)])
                assert oa == [b"from-a%d" % i for i in range(8)]
                assert ob == [b"from-b%d" % i for i in range(8)]
            finally:
                a.close()
                b.close()
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# 4. shedding
# ---------------------------------------------------------------------------


class TestShedding:
    def test_inflight_cap_sheds_busy_in_position(self):
        cap = 4
        c = _wire_client(max_inflight_per_conn=cap)
        try:
            sock = _raw_connect(c)
            parser = proto.RespParser()
            try:
                total = 12
                payload = b"".join(
                    proto.resp_encode(b"SETBIT", b"shed:bits", str(i).encode(), b"1")
                    for i in range(total))
                sock.sendall(payload)
                frames = _raw_read_frames(sock, parser, total)
                assert len(frames) == total
                busy = [f for f in frames if isinstance(f, proto.RespError)]
                okay = [f for f in frames if not isinstance(f, proto.RespError)]
                assert len(okay) == cap and all(f == 0 for f in okay)
                assert len(busy) == total - cap
                assert all(str(e).startswith("BUSY") for e in busy)
                assert not any(isinstance(f, proto.RespError) for f in frames[:cap])
                assert c.get_bit_set("shed:bits").cardinality() == cap
                assert c.wire.snapshot()["sheds_total"] >= total - cap
            finally:
                parser.close()
                sock.close()
        finally:
            c.shutdown()

    def test_connection_limit_shed(self):
        c = _wire_client(max_connections=1)
        try:
            keeper = _connect(c)
            try:
                sock = _raw_connect(c)
                parser = proto.RespParser()
                try:
                    frames = _raw_read_frames(sock, parser, 1)
                    assert frames and isinstance(frames[0], proto.RespError)
                    assert str(frames[0]).startswith("BUSY")
                    assert sock.recv(1) == b""  # the server closes it
                finally:
                    parser.close()
                    sock.close()
                assert keeper.execute("PING") == b"PONG"
            finally:
                keeper.close()
        finally:
            c.shutdown()

    def test_rejected_error_renders_busy_with_retry_after(self):
        import types

        from redisson_tpu_torch.serve.errors import RejectedError
        from redisson_tpu_torch.wire.server import WireServer

        stub = types.SimpleNamespace(_cluster=None, sheds_total=0,
                                     redirects_rendered=0)
        state = types.SimpleNamespace(
            exc=RejectedError("queue full", retry_after_s=0.25))
        frame = WireServer._render_error(stub, state)
        assert frame.startswith(b"-BUSY retry_after=0.250s")
        assert stub.sheds_total == 1


# ---------------------------------------------------------------------------
# 5. chaos: the wire_conn fault seam
# ---------------------------------------------------------------------------


class TestWireChaos:
    def test_dropped_connection_loses_no_acks(self):
        inj = FaultInjector(FaultPlan(rules=[FaultRule(seam="wire_conn", nth=2,
                                                       times=1)]))
        inject.install(inj)
        c = _wire_client()
        try:
            sock = _raw_connect(c)
            parser = proto.RespParser()
            try:
                first = b"".join(
                    proto.resp_encode(b"SETBIT", b"chaos:bits", str(i).encode(), b"1")
                    for i in range(3))
                sock.sendall(first)
                assert _raw_read_frames(sock, parser, 3) == [0, 0, 0]
                sock.sendall(proto.resp_encode(b"SETBIT", b"chaos:bits", b"9", b"1"))
                assert _raw_read_frames(sock, parser, 1, deadline_s=3.0) == []
            finally:
                parser.close()
                sock.close()
            bits = c.get_bit_set("chaos:bits")
            assert bits.cardinality() == 3
            assert bits.get(9) is False
            assert c.wire.snapshot()["dropped_conns"] == 1
            cli = _connect(c)
            try:
                assert cli.execute("PING") == b"PONG"
                assert cli.execute("GETBIT", "chaos:bits", "2") == 1
            finally:
                cli.close()
        finally:
            inject.uninstall()
            c.shutdown()

    def test_partial_pipeline_never_misattributed(self):
        inj = FaultInjector(FaultPlan(rules=[FaultRule(seam="wire_conn", nth=1,
                                                       times=1)]))
        c = _wire_client()
        try:
            survivor = _connect(c)
            try:
                inject.install(inj)
                try:
                    sock = _raw_connect(c)
                    parser = proto.RespParser()
                    try:
                        sock.sendall(proto.resp_encode(b"ECHO", b"victim"))
                        assert _raw_read_frames(sock, parser, 1, 3.0) == []
                    finally:
                        parser.close()
                        sock.close()
                finally:
                    inject.uninstall()
                out = survivor.pipeline([("ECHO", "sv%d" % i) for i in range(6)])
                assert out == [b"sv%d" % i for i in range(6)]
            finally:
                survivor.close()
        finally:
            inject.uninstall()
            c.shutdown()


# ---------------------------------------------------------------------------
# 6. lifecycle + observability
# ---------------------------------------------------------------------------


class TestLifecycle:
    def test_shutdown_stops_listener(self):
        c = _wire_client()
        port = c.wire.port
        assert port > 0
        c.shutdown()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=1.0)

    def test_wire_gauges_registered(self):
        c = _wire_client()
        try:
            cli = _connect(c)
            try:
                cli.pipeline([("PFADD", "g:k", "a"), ("PFCOUNT", "g:k")])
            finally:
                cli.close()
            snap = c.metrics.snapshot()["gauges"]
            names = {k for k in snap if k.startswith("wire.")}
            for want in ("wire.connections", "wire.commands",
                         "wire.engine_commands", "wire.pipeline_depth",
                         "wire.sheds", "wire.dropped_conns"):
                assert want in names, want
            assert snap["wire.commands"] >= 2
            assert snap["wire.engine_commands"] >= 2
        finally:
            c.shutdown()

    def test_auth_gate(self):
        c = _wire_client(password="sekret")
        try:
            sock = _raw_connect(c)
            parser = proto.RespParser()
            try:
                sock.sendall(proto.resp_encode(b"PFADD", b"a:k", b"v"))
                frames = _raw_read_frames(sock, parser, 1)
                assert isinstance(frames[0], proto.RespError)
                assert str(frames[0]).startswith("NOAUTH")
                sock.sendall(proto.resp_encode(b"AUTH", b"wrong"))
                frames = _raw_read_frames(sock, parser, 1)
                assert str(frames[0]).startswith("WRONGPASS")
                sock.sendall(proto.resp_encode(b"AUTH", b"sekret"))
                assert _raw_read_frames(sock, parser, 1) == [b"OK"]
                sock.sendall(proto.resp_encode(b"PFADD", b"a:k", b"v"))
                assert _raw_read_frames(sock, parser, 1) == [1]
            finally:
                parser.close()
                sock.close()
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# 7. the cluster front-end
# ---------------------------------------------------------------------------


def _cluster_wire(tmp_path, num_shards=2):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_cluster(num_shards=num_shards, dir=str(tmp_path / "cl"))
    cfg.use_wire()
    return RedissonTorch.create(cfg)


def _connect_addr(addr):
    host, _, port = addr.rpartition(":")
    cli = SyncRespClient(host or "127.0.0.1", int(port), retry_attempts=1)
    cli.connect()
    return cli


def _key_owned_by(table, shard_id, prefix="wk"):
    i = 0
    while True:
        k = f"{prefix}{i}"
        if table[key_slot(k)] == shard_id:
            return k
        i += 1


def _parse_redirect(exc):
    """'MOVED 8579 127.0.0.1:4447' -> (kind, slot, addr)."""
    kind, slot, addr = str(exc).split()
    return kind, int(slot), addr


class TestClusterWire:
    def test_moved_redirect_is_followable(self, tmp_path):
        c = _cluster_wire(tmp_path)
        try:
            key = _key_owned_by(c.cluster.router.slot_table(), 1)
            slot = key_slot(key)
            wrong = _connect_addr(c.wire.addr_of(0))
            try:
                with pytest.raises(jproto.RespError) as ei:
                    wrong.execute("PFADD", key, "a", "b")
                kind, got_slot, addr = _parse_redirect(ei.value)
                assert kind == "MOVED"
                assert got_slot == slot
                assert addr == c.wire.addr_of(1)
            finally:
                wrong.close()
            right = _connect_addr(addr)
            try:
                assert right.execute("PFADD", key, "a", "b") == 1
                assert right.execute("PFCOUNT", key) == 2
            finally:
                right.close()
            assert c.get_hyper_log_log(key).count() == 2
        finally:
            c.shutdown()

    def test_cluster_introspection_over_wire(self, tmp_path):
        c = _cluster_wire(tmp_path)
        try:
            cli = _connect_addr(c.wire.addr_of(0))
            try:
                assert cli.execute("CLUSTER", "KEYSLOT", "foo") == key_slot(b"foo")
                info = cli.execute("CLUSTER", "INFO")
                assert b"cluster_enabled:1" in info
                assert b"cluster_state:ok" in info
                slots = cli.execute("CLUSTER", "SLOTS")
                covered = set()
                for entry in slots:
                    start, end, master = entry[0], entry[1], entry[2]
                    covered.update(range(start, end + 1))
                    host, port = master[0], master[1]
                    sid = int(master[2].split(b"-")[-1])
                    assert c.wire.addr_of(sid) == f"{host.decode()}:{port}"
                assert covered == set(range(16384))
                h = cli.execute("HELLO", "2")
                flat = dict(zip(h[::2], h[1::2]))
                assert flat[b"mode"] == b"cluster"
            finally:
                cli.close()
        finally:
            c.shutdown()

    def test_live_migration_moves_ownership_on_the_wire(self, tmp_path):
        c = _cluster_wire(tmp_path)
        try:
            key = _key_owned_by(c.cluster.router.slot_table(), 0, prefix="mig")
            slot = key_slot(key)
            old = _connect_addr(c.wire.addr_of(0))
            try:
                assert old.execute("PFADD", key, "x", "y", "z") == 1
                before = old.execute("PFCOUNT", key)
                c.cluster.migrate_slots([slot], 1)
                with pytest.raises(jproto.RespError) as ei:
                    old.execute("PFCOUNT", key)
                kind, got_slot, addr = _parse_redirect(ei.value)
                assert kind == "MOVED"
                assert got_slot == slot
                assert addr == c.wire.addr_of(1)
            finally:
                old.close()
            new = _connect_addr(c.wire.addr_of(1))
            try:
                assert new.execute("PFCOUNT", key) == before
            finally:
                new.close()
            assert c.wire.snapshot()["redirects_rendered"] >= 1
        finally:
            c.shutdown()

    def test_wire_frontend_snapshot_sums_shards(self, tmp_path):
        c = _cluster_wire(tmp_path)
        try:
            cli = _connect_addr(c.wire.addr_of(0))
            try:
                cli.execute("PING")
            finally:
                cli.close()
            snap = c.wire.snapshot()
            assert snap["shards"] == 2
            assert snap["commands_total"] >= 1
        finally:
            c.shutdown()


class TestAskRendering:
    """-ASK rendering pinned against stub cluster state: the router parks
    the slot in its cutover window while the importing shard's guard
    carries the migrate mark."""

    class _StubGuard:
        def __init__(self, slots):
            self._slots = set(slots)

        def migrating_slots(self):
            return self._slots

    class _StubShard:
        def __init__(self, slots):
            self.guard = TestAskRendering._StubGuard(slots)

    class _StubRouter:
        def __init__(self, table, ask):
            self._table = table
            self._ask = frozenset(ask)

        def slot_table(self):
            return self._table

        def ask_slots(self):
            return self._ask

    class _StubManager:
        def __init__(self, table, ask, importing):
            self.router = TestAskRendering._StubRouter(table, ask)
            self.shards = {0: TestAskRendering._StubShard(()),
                           1: TestAskRendering._StubShard(importing)}

    def _ctx(self, ask=(), importing=()):
        table = [0] * 16384
        table[5] = 1  # slot 5 owned elsewhere
        ctx = ShardWireContext(0, self._StubManager(table, ask, importing))
        ctx.addrs = {0: "127.0.0.1:7000", 1: "127.0.0.1:7001"}
        return ctx

    def test_ask_during_cutover_window(self):
        ctx = self._ctx(ask={7}, importing={7})
        assert ctx.redirect_for(7) == proto.ask(7, "127.0.0.1:7001")

    def test_moved_for_foreign_slot(self):
        assert self._ctx().redirect_for(5) == proto.moved(5, "127.0.0.1:7001")

    def test_owned_slot_passes(self):
        assert self._ctx().redirect_for(42) is None

    def test_ask_addr_prefers_import_target(self):
        ctx = self._ctx(ask={7}, importing={7})
        assert ctx.ask_addr(7) == "127.0.0.1:7001"
        assert self._ctx(ask={7}).ask_addr(7) == "127.0.0.1:7000"


# ---------------------------------------------------------------------------
# 8. the codec against the JAX package's
# ---------------------------------------------------------------------------


def _seeded_frames(seed, n=60):
    """Reply-shaped RESP2 frames (simple, error, integer, bulk, null bulk,
    null array, nested arrays), rendered by the JAX package's proto."""
    rng = np.random.default_rng(seed)

    def one(depth):
        r = int(rng.integers(0, 7 if depth < 3 else 5))
        if r == 0:
            return jproto.simple("s%d" % int(rng.integers(0, 1000)))
        if r == 1:
            return jproto.err("bad thing %d" % int(rng.integers(0, 9)))
        if r == 2:
            return jproto.integer(int(rng.integers(-2**62, 2**62)))
        if r == 3:
            return jproto.bulk(rng.bytes(int(rng.integers(0, 40))))
        if r == 4:
            return jproto.bulk(None)
        if r == 5:
            return b"*-1\r\n"
        return jproto.array([one(depth + 1)
                             for _ in range(int(rng.integers(0, 4)))])

    return [one(0) for _ in range(n)]


def _norm(frames):
    """Frames of either package's parser in one shape (their RespError
    classes differ)."""
    out = []
    for f in frames:
        if isinstance(f, list):
            out.append(_norm(f))
        elif isinstance(f, Exception):
            out.append(("error", str(f)))
        else:
            out.append(f)
    return out


def _parse_all(parser_cls, chunks):
    p = parser_cls()
    try:
        got = []
        for ch in chunks:
            got.extend(p.feed(ch))
        return _norm(got)
    finally:
        p.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_whole_frames_equal_jax(seed):
    stream = b"".join(_seeded_frames(seed))
    assert _parse_all(proto.RespParser, [stream]) == \
        _parse_all(JRespParser, [stream])
    cmds = [[bytes(np.random.default_rng(seed + i).bytes(i % 7))
             for _ in range(1 + i % 5)] for i in range(40)]
    assert proto.resp_encode_pipeline(cmds) == jencode_pipeline(cmds)
    assert proto.resp_encode(b"SET", "k", 7, 2.5) == \
        jproto.resp_encode(b"SET", "k", 7, 2.5)


def test_codec_split_at_every_byte_equal_jax():
    stream = b"".join(_seeded_frames(5, n=12))
    want = _parse_all(JRespParser, [stream])
    for cut in range(1, len(stream)):
        chunks = [stream[:cut], stream[cut:]]
        assert _parse_all(proto.RespParser, chunks) == want, cut
    # byte by byte
    assert _parse_all(proto.RespParser, [stream[i:i + 1]
                                         for i in range(len(stream))]) == want


@pytest.mark.parametrize("bad", [
    b"%1\r\n+a\r\n:1\r\n",       # RESP3 map
    b"_\r\n",                     # RESP3 null
    b",1.5\r\n",                  # RESP3 double
    b"#t\r\n",                    # RESP3 boolean
    b"!5\r\nerror\r\n",           # RESP3 blob error
    b"?junk\r\n",                 # no such type
    b"*1\r\n" * 70 + b":1\r\n",  # nesting deeper than 64
])
def test_codec_protocol_errors_equal_jax(bad):
    """The poisoned parser: both surface the same frames, then one error
    frame, then nothing more (framing is lost for good)."""
    good = b"+before\r\n:7\r\n"
    for chunks in ([good + bad + good], [good, bad, good]):
        got = _parse_all(proto.RespParser, chunks)
        assert got == _parse_all(JRespParser, chunks)
        assert got[-1][0] == "error"


# ---------------------------------------------------------------------------
# 9. one command stream to a JAX server and to the port's
# ---------------------------------------------------------------------------


def _exchange(sock, parser, frame):
    """Send one command frame, read exactly one reply; return its bytes."""
    sock.sendall(frame)
    data = b""
    frames = []
    while not frames:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed")
        data += chunk
        frames = parser.feed(chunk)
    return data


_STREAM = [
    ("PING",), ("PING", "hi"), ("ECHO", "x y"),
    ("PFADD", "h1", "a", "b", "c"), ("PFADD", "h1", "a"), ("PFADD", "h2", "c", "d"),
    ("PFCOUNT", "h1"), ("PFCOUNT", "h1", "h2"), ("PFCOUNT", "nope"),
    ("PFMERGE", "h3", "h1", "h2"), ("PFCOUNT", "h3"),
    ("SETBIT", "b1", "7", "1"), ("SETBIT", "b1", "7", "0"), ("SETBIT", "b1", "300", "1"),
    ("SETBIT", "b2", "7", "1"), ("GETBIT", "b1", "300"), ("GETBIT", "b1", "5"),
    ("BITCOUNT", "b1"), ("BITCOUNT", "b1", "0", "1"),
    ("BITOP", "OR", "b3", "b1", "b2"), ("BITCOUNT", "b3"),
    ("BITOP", "AND", "b1", "b1", "b2"), ("BITOP", "XOR", "b4", "b1", "b2"),
    ("BITOP", "NOT", "b2", "b2"), ("BITOP", "NOT", "b5", "b2"), ("BITOP", "NAND", "x", "y"),
    ("SETBIT", "b1", "-1", "1"), ("SETBIT", "b1", "1", "2"), ("SETBIT", "b1", "x", "1"),
    ("EXISTS", "h1", "b1", "zz"), ("DBSIZE",), ("KEYS", "h*"), ("KEYS", "*"),
    ("DEL", "h2", "zz"), ("UNLINK", "b4"), ("EXISTS", "h2"),
    ("SELECT", "0"), ("SELECT", "3"), ("COMMAND", "COUNT"), ("COMMAND",),
    ("CLUSTER", "KEYSLOT", "h1"), ("CLUSTER", "SLOTS"), ("CLUSTER", "INFO"),
    ("CLUSTER", "NODES"), ("CLIENT", "SETNAME", "n1"), ("CLIENT", "GETNAME"),
    ("CLIENT", "KILL"), ("AUTH", "pw"), ("HELLO", "4"), ("PFADD",), ("NOSUCH", "x"),
    ("MEMORY", "USAGE", "h1"), ("MEMORY", "USAGE", "zz"), ("MEMORY", "NOPE"),
    ("SLOWLOG", "RESET"), ("SLOWLOG", "NOPE"),
    ("FLUSHALL",), ("DBSIZE",), ("PFCOUNT", "h1"),
]


def _replies(client, stream):
    sock = _raw_connect(client)
    parser = proto.RespParser()
    try:
        return [_exchange(sock, parser, proto.resp_encode(*cmd)) for cmd in stream]
    finally:
        parser.close()
        sock.close()


def test_reply_bytes_equal_jax():
    jc, tc = _jax_wire_client(), _wire_client()
    try:
        want, got = _replies(jc, _STREAM), _replies(tc, _STREAM)
        for cmd, w, g in zip(_STREAM, want, got):
            assert g == w, (cmd, w, g)
        # HELLO 2: equal but for the fields DIFFERING names
        hello = [_replies(c, [("HELLO", "2")])[0] for c in (jc, tc)]
        parsed = []
        for raw in hello:
            p = proto.RespParser()
            flat = p.feed(raw)[0]
            p.close()
            fields = dict(zip(flat[::2], flat[1::2]))
            for k in DIFFERING["HELLO"]:
                fields.pop(k.encode())
            parsed.append(fields)
        assert parsed[0] == parsed[1]
    finally:
        tc.shutdown()
        jc.shutdown()


def _cluster_pair(tmp_path):
    jcfg = JConfig()
    jcfg.use_cluster(num_shards=2, dir=str(tmp_path / "jax"))
    jcfg.use_wire()
    return RedissonTPU.create(jcfg), _cluster_wire(tmp_path, 2)


def _unport(raw: bytes, addrs) -> bytes:
    """Replace each shard's port by its shard id (the field that differs)."""
    for sid, addr in addrs.items():
        port = addr.rpartition(":")[2].encode()
        raw = raw.replace(b":" + port + b"\r\n", b":<shard-%d>\r\n" % sid)
        raw = raw.replace(b":" + port + b"\r", b":<shard-%d>\r" % sid)
    return raw


def test_cluster_reply_bytes_equal_jax(tmp_path):
    jc, tc = _cluster_pair(tmp_path)
    try:
        assert tc.cluster.router.slot_table() == jc.cluster.router.slot_table()
        table = tc.cluster.router.slot_table()
        k0, k1 = _key_owned_by(table, 0), _key_owned_by(table, 1)
        stream = [("CLUSTER", "SLOTS"), ("CLUSTER", "INFO"),
                  ("CLUSTER", "KEYSLOT", k1), ("PFADD", k0, "a", "b"),
                  ("PFADD", k1, "a"), ("PFCOUNT", k1), ("PFCOUNT", k0),
                  ("SETBIT", k1, "3", "1"), ("PFCOUNT", "{t}a", "{t}b")]
        out = []
        for c in (jc, tc):
            srv = c.wire.servers[0]
            sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            sock.settimeout(5.0)
            parser = proto.RespParser()
            try:
                out.append([_unport(_exchange(sock, parser, proto.resp_encode(*cmd)),
                                    c.wire.addrs) for cmd in stream])
            finally:
                parser.close()
                sock.close()
        for cmd, w, g in zip(stream, *out):
            assert g == w, (cmd, w, g)
        assert out[1][4].startswith(b"-MOVED %d 127.0.0.1:<shard-1>" % key_slot(k1))
    finally:
        tc.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# 10. gauges and the loop witness
# ---------------------------------------------------------------------------


class _StubWire:
    def connections(self):
        return 0

    def inflight(self):
        return 0

    def snapshot(self):
        return {}


def test_wire_gauge_names_equal_jax():
    names = []
    for reg, fn in ((MetricsRegistry(), register_wire),
                    (JMetricsRegistry(), jregister_wire)):
        fn(reg, _StubWire())
        names.append(sorted(reg.snapshot()["gauges"]))
    assert names[0] == names[1]
    assert "wire.loop_lag_p99_us" in names[0]


def test_loop_witness_feeds_the_wire_gauges():
    """Unarmed, a server's loop is not watched and its gauges read zero;
    a forced watch records the loop's callbacks and heartbeat lag."""
    c = _wire_client()
    try:
        loop = c.wire._loop
        assert loopwitness.loop_gauges(loop) == {"loop_lag_p99_us": 0,
                                                 "loop_stalls": 0}
        assert loopwitness.watch_loop(loop, "test", force=True)
        cli = _connect(c)
        try:
            for _ in range(5):
                assert cli.execute("PING") == b"PONG"
        finally:
            cli.close()
        deadline = time.monotonic() + 10
        while True:
            snap = loopwitness.loop_witness_snapshot()["loops"]["test"]
            if snap["lag"]["beats"] >= 3 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert snap["lag"]["beats"] >= 3 and snap["callbacks"]
        assert set(c.wire.snapshot()) >= {"loop_lag_p99_us", "loop_stalls"}
    finally:
        c.shutdown()
        loopwitness.uninstall()
        loopwitness.loop_witness_reset()
