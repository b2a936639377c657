"""Embedded in-process Redis look-alike (asyncio RESP2 server; counterpart
of `redisson_tpu.interop.fake_server`, the same reply bytes).

The reference's test oracle is a real redis-server spawned per test class
(RedisRunner.java, SURVEY.md §4); this image has no redis binary, and the
survey explicitly calls for an in-process fake as the improvement. This
server speaks enough RESP2 for the durability/interop tier and its tests:

  strings:  SET GET DEL EXISTS STRLEN APPEND FLUSHALL KEYS TYPE
  bits:     SETBIT GETBIT BITCOUNT BITOP
  hashes:   HSET HGET HGETALL HDEL
  hll:      PFADD PFCOUNT PFMERGE (registers via interop/hyll.py, hashing
            via the host library's murmur3 fold (`native.hll_fold`, no
            Python fallback: PFADD raises when the library did not build)
            — self-consistent with the port's sketches, see hyll.py — or
            redis's MurmurHash64A with hll_hash="redis")
  admin:    PING AUTH SELECT ECHO DBSIZE
  scripts:  EVAL EVALSHA SCRIPT LOAD/EXISTS/FLUSH — real server-side
            execution via the mini-Lua interpreter (interop/mini_lua.py),
            the mechanism the reference's locks/semaphores/map-cache run on
            (RedissonLock.java:236-252, RedissonMapCache.java:75-87)
  pubsub:   SUBSCRIBE UNSUBSCRIBE PSUBSCRIBE PUNSUBSCRIBE PUBLISH — push
            frames to subscribed connections (lock wake-ups,
            pubsub/LockPubSub.java)
  blocking: BLPOP BRPOP with parked asyncio waiters (the reference's
            timeoutless command path, CommandAsyncService.java:514-577)
  fault injection: DROPCONN (closes the socket mid-stream, for watchdog
            tests — the in-process analogue of RedisRunner's process kill)

State is a plain dict per server; binary-safe; single-threaded asyncio.
"""

from __future__ import annotations

import asyncio
import fnmatch
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from redisson_tpu_torch import native
from redisson_tpu_torch.interop import hyll
from redisson_tpu_torch.interop import mini_lua
from redisson_tpu_torch.wire import proto
# Reply rendering comes from the shared RESP frame codec (wire/proto.py):
# the fake's hand-rolled encoders are gone, so its bytes-on-the-wire are
# definitionally identical to the real wire server's. Local names kept —
# they are used hundreds of times below.
from redisson_tpu_torch.wire.proto import array as _array
from redisson_tpu_torch.wire.proto import bulk as _bulk
from redisson_tpu_torch.wire.proto import err as _err
from redisson_tpu_torch.wire.proto import integer as _int
from redisson_tpu_torch.wire.proto import ok as _ok


def _readonly_for_replication() -> frozenset:
    """Commands a master must NOT forward to replicas: the router's read
    set (single source of truth — drift between read-routing and fake
    replication makes master/slave tests lie) plus pure-admin commands."""
    from redisson_tpu_torch.interop.topology_redis import READ_COMMANDS

    return READ_COMMANDS | {"ECHO", "SELECT", "AUTH", "SCRIPT", "PUBLISH",
                            "SENTINEL", "INFO", "CLUSTER"}


class _ZSet(dict):
    """member -> score; its own type so TYPE can tell it from a hash."""


class _Geo(dict):
    """member -> (lon, lat); its own type so TYPE can tell it from a hash."""


class FakeRedisServer:
    """asyncio RESP server over an in-memory dict. start()/stop(); the
    listening port is self.port (0 -> ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None, hll_hash: str = "murmur3"):
        self.host = host
        self.port = port
        self.password = password
        # PFADD hash family: "murmur3" (default — self-consistent with the
        # port's sketches, see module docstring) or "redis" (MurmurHash64A per
        # hyperloglog.c — emulates a REAL server for mixed-writer tests of
        # the durability path).
        self.hll_hash = hll_hash
        self.data: Dict[bytes, object] = {}
        self.expires: Dict[bytes, int] = {}  # key -> unix ms deadline
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections = 0
        self._writers: set = set()
        self._scripts: Dict[bytes, bytes] = {}  # sha1 hex -> source
        # writer -> (channels, patterns) for connections in subscribe mode
        self._subs: Dict[asyncio.StreamWriter, Tuple[set, set]] = {}
        # Signalled after every write command; parked BLPOP/BRPOP waiters
        # re-check their keys (the fake analogue of the reference's
        # blocking-command reattach machinery).
        self._push_cond = asyncio.Condition()
        self._stopping = False
        # -- topology fixtures (in-process master/slave + cluster fakes,
        # the SURVEY §4 "improve on the reference" fake-topology point) --
        # Write commands are forwarded to replicas (must share this
        # server's event loop — EmbeddedRedis.pair wires that up).
        self.replicas: List["FakeRedisServer"] = []
        # slot -> "host:port" owned elsewhere: keyed commands for these
        # slots get "-MOVED slot addr" (ClusterConnectionManager redirect).
        self.moved_slots: Dict[int, str] = {}
        # key (bytes) -> "host:port" mid-migration: replies "-ASK slot addr";
        # the importing side lists the key in `importing` and only serves it
        # on a connection that sent ASKING first.
        self.ask_keys: Dict[bytes, str] = {}
        self.importing: set = set()
        # Cluster fixture: shared ClusterState + this node's own address.
        # When set, keyed commands for slots this node does not own reply
        # -MOVED to the owner, and CLUSTER NODES renders the shared table
        # (`cluster/ClusterConnectionManager.java:599-637` parse format).
        self.cluster_state: Optional["ClusterState"] = None
        self.cluster_self: Optional[str] = None
        # Sentinel fixture: this server answers SENTINEL queries for these
        # monitored masters (name -> "host:port") and their slaves
        # (name -> ["host:port", ...]); failover tests publish
        # +switch-master on it like a real sentinel daemon.
        self.sentinel_masters: Dict[str, str] = {}
        self.sentinel_slaves: Dict[str, List[str]] = {}
        # INFO replication role: None = master; set to the master's
        # "host:port" when this server is a replica (EmbeddedRedis.pair
        # sets it; Elasticache-style role polling reads it).
        self.replicating_from: Optional[str] = None

    async def start(self) -> None:
        self._stopping = False
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._stopping = True
            self._server.close()
            # Force-close live client connections: wait_closed() blocks until
            # every handler returns, and handlers only return on client EOF.
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:
                    pass
            # Wake parked blocking-pop waiters so their handlers can exit.
            async with self._push_cond:
                self._push_cond.notify_all()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        self._writers.add(writer)
        parser = proto.RespParser()
        authed = self.password is None
        asking = False  # set by ASKING, whitelists exactly the next command
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                for cmd in parser.feed(data):
                    if not isinstance(cmd, list) or not cmd:
                        writer.write(_err("protocol"))
                        continue
                    name = bytes(cmd[0]).upper().decode()
                    args = cmd[1:]
                    if name == "AUTH":
                        authed = args and args[0].decode() == self.password
                        writer.write(_ok() if authed else _err("invalid password"))
                        continue
                    if not authed:
                        writer.write(_err("NOAUTH Authentication required"))
                        continue
                    if name == "DROPCONN":
                        writer.close()
                        return
                    if name == "ASKING":
                        asking = True
                        writer.write(_ok())
                        continue
                    try:
                        if name in ("SUBSCRIBE", "UNSUBSCRIBE", "PSUBSCRIBE",
                                    "PUNSUBSCRIBE"):
                            writer.write(self._do_subscribe(name, args, writer))
                        elif name in ("BLPOP", "BRPOP", "BRPOPLPUSH"):
                            reply = await self._blocking_pop(name, args)
                            # Replicate BEFORE the reply hits the wire:
                            # write() flushes eagerly, so a client that
                            # acts on the reply must already see replica
                            # state (synchronous replication — determinism
                            # the test fixture exists to provide; replying
                            # first raced every read-your-replica assert).
                            self._replicate_blocking_pop(name, args, reply)
                            writer.write(reply)
                        else:
                            redirect = self._redirect_for(name, args, asking)
                            if redirect is not None:
                                writer.write(redirect)
                            else:
                                reply = self._dispatch(name, args)
                                self._replicate(name, args)
                                writer.write(reply)
                                # Wake parked blocking-pop waiters to re-check.
                                async with self._push_cond:
                                    self._push_cond.notify_all()
                    except Exception as e:  # noqa: BLE001
                        writer.write(_err(str(e)))
                    finally:
                        asking = False
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            self._subs.pop(writer, None)
            parser.close()
            try:
                writer.close()
            except Exception:
                pass

    # -- topology fixtures ---------------------------------------------------

    # Commands whose first arg is NOT a key (redirect check skips them).
    _UNKEYED = frozenset({
        "PING", "ECHO", "SELECT", "DBSIZE", "FLUSHALL", "KEYS", "SCRIPT",
        "EVAL", "EVALSHA", "PUBLISH", "AUTH", "SCAN", "SENTINEL", "INFO",
        "CLUSTER",
    })

    def _redirect_for(self, name: str, a: List[bytes], asking: bool):
        """-MOVED / -ASK replies for the cluster-fixture maps (real cluster
        redirect semantics: `cluster/ClusterConnectionManager.java:543-558`,
        importing nodes demand ASKING)."""
        if name in self._UNKEYED or not a:
            return None
        key = bytes(a[0])
        if self.importing and key in self.importing and not asking:
            # Importing side: only an ASKING-prefixed command may touch it.
            return _err(f"key {key!r} is importing; ASKING required")
        if self.ask_keys and key in self.ask_keys:
            from redisson_tpu_torch.ops import crc16

            slot = crc16.key_slot(key.decode("utf-8", "replace"))
            return f"-ASK {slot} {self.ask_keys[key]}\r\n".encode()
        if self.moved_slots:
            from redisson_tpu_torch.ops import crc16

            slot = crc16.key_slot(key.decode("utf-8", "replace"))
            owner = self.moved_slots.get(slot)
            if owner is not None:
                return f"-MOVED {slot} {owner}\r\n".encode()
        if self.cluster_state is not None and self.cluster_self is not None:
            from redisson_tpu_torch.ops import crc16

            slot = crc16.key_slot(key.decode("utf-8", "replace"))
            owner = self.cluster_state.owner_of(slot)
            if owner is not None and owner != self.cluster_self:
                return f"-MOVED {slot} {owner}\r\n".encode()
        return None

    def _replicate(self, name: str, a: List[bytes]) -> None:
        """Forward write commands to replica servers (must share this
        server's event loop). The reference tests against real replicating
        redis-servers; this is the in-process equivalent."""
        if not self.replicas or name.upper() in _readonly_for_replication():
            return
        for r in self.replicas:
            try:
                r._dispatch(name, [bytes(x) for x in a])
            except Exception:  # noqa: BLE001 - a broken replica stays broken
                pass

    def _replicate_blocking_pop(self, name: str, a: List[bytes],
                                reply: bytes) -> None:
        """Blocking pops consume destructively on the master only; forward
        the equivalent non-blocking effect so replica lists don't diverge
        (replication of effects, as real Redis propagates LPOP for BLPOP)."""
        if not self.replicas or reply in (b"*-1\r\n", b"$-1\r\n"):
            return
        if name == "BRPOPLPUSH":
            self._replicate("RPOPLPUSH", [bytes(a[0]), bytes(a[1])])
            return
        # BLPOP/BRPOP reply: [key, value] — pop that key on the replicas.
        parser = proto.RespParser()
        try:
            vals = parser.feed(reply)
        finally:
            parser.close()
        popped_key = bytes(vals[0][0])
        self._replicate("LPOP" if name == "BLPOP" else "RPOP", [popped_key])

    def _cmd_info(self, a):
        """INFO [section] — enough of the replication section for role
        polling (`ElasticacheConnectionManager.java` reads role:)."""
        role = "slave" if self.replicating_from is not None else "master"
        body = (f"# Replication\r\nrole:{role}\r\n"
                f"connected_slaves:{len(self.replicas)}\r\n")
        return _bulk(body.encode())

    def _cmd_cluster(self, a):
        """CLUSTER NODES — renders the shared fixture topology in the wire
        format the reference parses (`ClusterConnectionManager.java:599-637`,
        `ClusterNodeInfo.java`)."""
        sub = bytes(a[0]).upper().decode() if a else ""
        if sub == "NODES":
            if self.cluster_state is None:
                return _err("this instance has cluster support disabled")
            return _bulk(
                self.cluster_state.nodes_text(self.cluster_self).encode())
        return _err(f"unsupported CLUSTER subcommand {sub!r}")

    def _cmd_sentinel(self, a):
        """SENTINEL GET-MASTER-ADDR-BY-NAME / SLAVES — the bootstrap
        queries of `SentinelConnectionManager.java:74-105`."""
        sub = bytes(a[0]).upper().decode()
        name = bytes(a[1]).decode() if len(a) > 1 else ""
        if sub == "GET-MASTER-ADDR-BY-NAME":
            addr = self.sentinel_masters.get(name)
            if addr is None:
                return b"*-1\r\n"
            host, _, port = addr.rpartition(":")
            return _array([_bulk(host.encode()), _bulk(port.encode())])
        if sub in ("SLAVES", "REPLICAS"):
            rows = []
            for s in self.sentinel_slaves.get(name, []):
                host, _, port = s.rpartition(":")
                rows.append(_array([
                    _bulk(b"name"), _bulk(s.encode()),
                    _bulk(b"ip"), _bulk(host.encode()),
                    _bulk(b"port"), _bulk(port.encode()),
                    _bulk(b"flags"), _bulk(b"slave"),
                ]))
            return _array(rows)
        return _err(f"unknown SENTINEL subcommand {sub}")

    # -- command handlers ---------------------------------------------------

    def _dispatch(self, name: str, a: List[bytes]) -> bytes:
        self._purge_expired()
        h = getattr(self, "_cmd_" + name.lower(), None)
        if h is None:
            return _err(f"unknown command '{name}'")
        return h(a)

    def _purge_expired(self) -> None:
        if not self.expires:
            return
        import time
        now = int(time.time() * 1000)
        for k in [k for k, ts in self.expires.items() if ts <= now]:
            self.expires.pop(k, None)
            self.data.pop(k, None)
        # Drop orphaned deadlines (key deleted by a path that didn't pop its
        # expiry): real Redis never lets a re-created key inherit an old TTL.
        for k in [k for k in self.expires if k not in self.data]:
            self.expires.pop(k, None)

    def _cmd_ping(self, a):
        return _bulk(a[0]) if a else b"+PONG\r\n"

    def _cmd_echo(self, a):
        return _bulk(a[0])

    def _cmd_select(self, a):
        return _ok()

    def _cmd_dbsize(self, a):
        return _int(len(self.data))

    def _cmd_flushall(self, a):
        self.data.clear()
        self.expires.clear()
        return _ok()

    def _cmd_set(self, a):
        k = bytes(a[0])
        self.data[k] = bytes(a[1])
        self.expires.pop(k, None)  # SET discards any TTL
        # optional PX ttl argument (SET k v PX ms)
        rest = [bytes(x).upper() for x in a[2:]]
        if b"PX" in rest:
            import time
            ms = int(a[2 + rest.index(b"PX") + 1])
            self.expires[k] = int(time.time() * 1000) + ms
        return _ok()

    def _cmd_get(self, a):
        v = self.data.get(bytes(a[0]))
        if v is not None and not isinstance(v, bytes):
            raise ValueError("WRONGTYPE")
        return _bulk(v)

    def _cmd_append(self, a):
        k = bytes(a[0])
        v = self.data.get(k, b"") + bytes(a[1])
        self.data[k] = v
        return _int(len(v))

    def _cmd_strlen(self, a):
        v = self.data.get(bytes(a[0]), b"")
        return _int(len(v) if isinstance(v, bytes) else 0)

    def _cmd_setnx(self, a):
        k = bytes(a[0])
        if k in self.data:
            return _int(0)
        self.data[k] = bytes(a[1])
        return _int(1)

    def _cmd_getrange(self, a):
        v = self.data.get(bytes(a[0]), b"")
        if not isinstance(v, bytes):
            raise ValueError("WRONGTYPE")
        s, e = int(a[1]), int(a[2])
        n = len(v)
        if s < 0:
            s = max(0, n + s)
        if e < 0:
            e = n + e
        return _bulk(v[s:e + 1] if e >= s else b"")

    def _cmd_setrange(self, a):
        k, off, val = bytes(a[0]), int(a[1]), bytes(a[2])
        buf = bytearray(self.data.get(k, b""))
        if len(buf) < off + len(val):
            buf.extend(b"\x00" * (off + len(val) - len(buf)))
        buf[off:off + len(val)] = val
        self.data[k] = bytes(buf)
        return _int(len(self.data[k]))

    def _cmd_getset(self, a):
        k = bytes(a[0])
        old = self.data.get(k)
        if old is not None and not isinstance(old, bytes):
            raise ValueError("WRONGTYPE")
        self.data[k] = bytes(a[1])
        self.expires.pop(k, None)  # SET-family write discards TTL
        return _bulk(old)

    def _cmd_incrby(self, a):
        k = bytes(a[0])
        v = int(self.data.get(k, b"0")) + int(a[1])
        self.data[k] = str(v).encode()
        return _int(v)

    def _cmd_incrbyfloat(self, a):
        k = bytes(a[0])
        v = float(self.data.get(k, b"0")) + float(a[1])
        self.data[k] = repr(v).encode()
        return _bulk(repr(v).encode())

    def _cmd_incr(self, a):
        return self._cmd_incrby([a[0], b"1"])

    def _cmd_decr(self, a):
        return self._cmd_incrby([a[0], b"-1"])

    def _cmd_decrby(self, a):
        return self._cmd_incrby([a[0], b"%d" % -int(a[1])])

    def _cmd_mget(self, a):
        out = []
        for k in a:
            v = self.data.get(bytes(k))
            out.append(_bulk(v if isinstance(v, bytes) else None))
        return _array(out)

    def _cmd_mset(self, a):
        for i in range(0, len(a) - 1, 2):
            k = bytes(a[i])
            self.data[k] = bytes(a[i + 1])
            self.expires.pop(k, None)
        return _ok()

    def _cmd_msetnx(self, a):
        keys = [bytes(a[i]) for i in range(0, len(a) - 1, 2)]
        if any(k in self.data for k in keys):
            return _int(0)
        self._cmd_mset(a)
        return _int(1)

    def _cmd_rename(self, a):
        k, nk = bytes(a[0]), bytes(a[1])
        if k not in self.data:
            raise ValueError("no such key")
        self.data[nk] = self.data.pop(k)
        # Destination inherits the SOURCE's TTL state (Redis semantics:
        # any previous TTL on the destination is discarded).
        self.expires.pop(nk, None)
        if k in self.expires:
            self.expires[nk] = self.expires.pop(k)
        return _ok()

    def _cmd_renamenx(self, a):
        if bytes(a[1]) in self.data:
            return _int(0)
        self._cmd_rename(a)
        return _int(1)

    def _cmd_pexpire(self, a):
        import time
        k = bytes(a[0])
        if k not in self.data:
            return _int(0)
        self.expires[k] = int(time.time() * 1000) + int(a[1])
        return _int(1)

    def _cmd_expire(self, a):
        return self._cmd_pexpire([a[0], str(int(a[1]) * 1000).encode()])

    def _cmd_pexpireat(self, a):
        k = bytes(a[0])
        if k not in self.data:
            return _int(0)
        self.expires[k] = int(a[1])
        return _int(1)

    def _cmd_persist(self, a):
        return _int(1 if self.expires.pop(bytes(a[0]), None) is not None else 0)

    def _cmd_pttl(self, a):
        import time
        k = bytes(a[0])
        if k not in self.data:
            return _int(-2)
        ts = self.expires.get(k)
        if ts is None:
            return _int(-1)
        return _int(max(0, ts - int(time.time() * 1000)))

    def _cmd_del(self, a):
        n = 0
        for k in a:
            kb = bytes(k)
            self.expires.pop(kb, None)
            n += 1 if self.data.pop(kb, None) is not None else 0
        return _int(n)

    def _cmd_exists(self, a):
        return _int(sum(1 for k in a if bytes(k) in self.data))

    def _cmd_keys(self, a):
        import fnmatch
        pat = bytes(a[0]).decode("utf-8", "replace")
        ks = [k for k in self.data
              if fnmatch.fnmatchcase(k.decode("utf-8", "replace"), pat)]
        return _array([_bulk(k) for k in sorted(ks)])

    def _cmd_type(self, a):
        v = self.data.get(bytes(a[0]))
        if v is None:
            return b"+none\r\n"
        if isinstance(v, _ZSet):
            return b"+zset\r\n"
        if isinstance(v, _Geo):
            return b"+zset\r\n"  # real Redis stores geo as a zset
        if isinstance(v, dict):
            return b"+hash\r\n"
        if isinstance(v, set):
            return b"+set\r\n"
        if isinstance(v, list):
            return b"+list\r\n"
        return b"+string\r\n"

    # bits

    def _cmd_setbit(self, a):
        k, off, val = bytes(a[0]), int(a[1]), int(a[2])
        buf = bytearray(self.data.get(k, b""))
        byte, bit = off >> 3, 7 - (off & 7)
        if len(buf) <= byte:
            buf.extend(b"\x00" * (byte + 1 - len(buf)))
        old = (buf[byte] >> bit) & 1
        if val:
            buf[byte] |= 1 << bit
        else:
            buf[byte] &= ~(1 << bit)
        self.data[k] = bytes(buf)
        return _int(old)

    def _cmd_getbit(self, a):
        k, off = bytes(a[0]), int(a[1])
        buf = self.data.get(k, b"")
        byte, bit = off >> 3, 7 - (off & 7)
        return _int((buf[byte] >> bit) & 1 if byte < len(buf) else 0)

    def _cmd_bitcount(self, a):
        buf = self.data.get(bytes(a[0]), b"")
        if len(a) >= 3:  # BITCOUNT key start end (byte offsets, negatives ok)
            start, end = int(a[1]), int(a[2])
            n = len(buf)
            if start < 0:
                start = max(0, n + start)
            if end < 0:
                end = max(0, n + end)  # redis clamps past-the-start to byte 0
            buf = buf[start:end + 1] if end >= start else b""
        if not buf:
            return _int(0)
        return _int(int(np.unpackbits(np.frombuffer(buf, np.uint8)).sum()))

    def _cmd_bitop(self, a):
        op = bytes(a[0]).upper()
        dest = bytes(a[1])
        srcs = [self.data.get(bytes(k), b"") for k in a[2:]]
        width = max((len(s) for s in srcs), default=0)
        arrs = [np.frombuffer(s.ljust(width, b"\x00"), np.uint8).astype(np.uint8)
                for s in srcs]
        if op == b"NOT":
            out = ~arrs[0]
        else:
            out = arrs[0].copy()
            for x in arrs[1:]:
                if op == b"AND":
                    out &= x
                elif op == b"OR":
                    out |= x
                elif op == b"XOR":
                    out ^= x
                else:
                    raise ValueError(f"bad BITOP {op!r}")
        self.data[dest] = out.tobytes()
        return _int(width)

    # hashes

    def _hash(self, k: bytes) -> dict:
        v = self.data.setdefault(k, {})
        if not isinstance(v, dict) or isinstance(v, (_ZSet, _Geo)):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_hset(self, a):
        h = self._hash(bytes(a[0]))
        added = 0
        for i in range(1, len(a) - 1, 2):
            added += 0 if bytes(a[i]) in h else 1
            h[bytes(a[i])] = bytes(a[i + 1])
        return _int(added)

    def _cmd_hget(self, a):
        v = self._hash_read(bytes(a[0]))
        if v is None:
            return _bulk(None)
        return _bulk(v.get(bytes(a[1])))

    def _cmd_hgetall(self, a):
        v = self._hash_read(bytes(a[0])) or {}
        out = []
        for k, val in v.items():
            out.append(_bulk(k))
            out.append(_bulk(val))
        return _array(out)

    def _cmd_hdel(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, dict):
            return _int(0)
        n = 0
        for f in a[1:]:
            n += 1 if v.pop(bytes(f), None) is not None else 0
        return _int(n)

    def _cmd_hsetnx(self, a):
        h = self._hash(bytes(a[0]))
        f = bytes(a[1])
        if f in h:
            return _int(0)
        h[f] = bytes(a[2])
        return _int(1)

    def _hash_read(self, k: bytes):
        """Read-side hash lookup; WRONGTYPE on zsets (dict subclasses)."""
        v = self.data.get(k)
        if v is not None and (not isinstance(v, dict) or isinstance(v, (_ZSet, _Geo))):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_hexists(self, a):
        v = self._hash_read(bytes(a[0]))
        return _int(1 if v is not None and bytes(a[1]) in v else 0)

    def _cmd_hmget(self, a):
        v = self._hash_read(bytes(a[0]))
        out = []
        for f in a[1:]:
            item = v.get(bytes(f)) if isinstance(v, dict) else None
            out.append(_bulk(item))
        return _array(out)

    def _cmd_hlen(self, a):
        v = self._hash_read(bytes(a[0]))
        return _int(len(v) if v is not None else 0)

    def _cmd_hkeys(self, a):
        v = self._hash_read(bytes(a[0])) or {}
        return _array([_bulk(f) for f in v])

    def _cmd_hvals(self, a):
        v = self._hash_read(bytes(a[0])) or {}
        return _array([_bulk(x) for x in v.values()])

    def _cmd_hincrby(self, a):
        h = self._hash(bytes(a[0]))
        f = bytes(a[1])
        v = int(h.get(f, b"0")) + int(a[2])
        h[f] = str(v).encode()
        return _int(v)

    def _cmd_hincrbyfloat(self, a):
        h = self._hash(bytes(a[0]))
        f = bytes(a[1])
        v = float(h.get(f, b"0")) + float(a[2])
        h[f] = repr(v).encode()
        return _bulk(repr(v).encode())

    # sets

    def _set(self, k: bytes) -> set:
        v = self.data.setdefault(k, set())
        if not isinstance(v, set):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_sadd(self, a):
        s = self._set(bytes(a[0]))
        n = 0
        for m in a[1:]:
            mb = bytes(m)
            if mb not in s:
                s.add(mb)
                n += 1
        return _int(n)

    def _cmd_srem(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, set):
            return _int(0)
        n = 0
        for m in a[1:]:
            if bytes(m) in v:
                v.discard(bytes(m))
                n += 1
        if not v:  # real Redis deletes a set that empties
            self.data.pop(bytes(a[0]), None)
        return _int(n)

    def _cmd_sismember(self, a):
        v = self.data.get(bytes(a[0]))
        return _int(1 if isinstance(v, set) and bytes(a[1]) in v else 0)

    def _cmd_smembers(self, a):
        v = self.data.get(bytes(a[0]), set())
        return _array([_bulk(m) for m in sorted(v)]) if isinstance(v, set) else _array([])

    def _cmd_scard(self, a):
        v = self.data.get(bytes(a[0]))
        return _int(len(v) if isinstance(v, set) else 0)

    # lists

    def _list(self, k: bytes) -> list:
        v = self.data.setdefault(k, [])
        if not isinstance(v, list):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_rpush(self, a):
        lst = self._list(bytes(a[0]))
        lst.extend(bytes(x) for x in a[1:])
        return _int(len(lst))

    def _cmd_lpush(self, a):
        lst = self._list(bytes(a[0]))
        for x in a[1:]:
            lst.insert(0, bytes(x))
        return _int(len(lst))

    def _cmd_lrange(self, a):
        v = self.data.get(bytes(a[0]), [])
        if not isinstance(v, list):
            raise ValueError("WRONGTYPE")
        start, stop = int(a[1]), int(a[2])
        n = len(v)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        start = max(0, start)
        if stop < start:  # Redis returns empty, incl. stop < -n
            return _array([])
        return _array([_bulk(x) for x in v[start:stop + 1]])

    def _cmd_llen(self, a):
        v = self.data.get(bytes(a[0]))
        return _int(len(v) if isinstance(v, list) else 0)

    def _cmd_lindex(self, a):
        v = self.data.get(bytes(a[0]))
        i = int(a[1])
        if not isinstance(v, list) or not -len(v) <= i < len(v):
            return _bulk(None)
        return _bulk(v[i])

    def _cmd_lset(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list):
            raise ValueError("no such key")
        v[int(a[1])] = bytes(a[2])
        return _ok()

    def _cmd_lrem(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list):
            return _int(0)
        count, val = int(a[1]), bytes(a[2])
        removed = 0
        if count >= 0:
            limit = count if count else len(v)
            i = 0
            while i < len(v) and removed < limit:
                if v[i] == val:
                    v.pop(i)
                    removed += 1
                else:
                    i += 1
        else:
            limit = -count
            i = len(v) - 1
            while i >= 0 and removed < limit:
                if v[i] == val:
                    v.pop(i)
                    removed += 1
                i -= 1
        return _int(removed)

    def _cmd_lpop(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list) or not v:
            return _bulk(None)
        return _bulk(v.pop(0))

    def _cmd_rpop(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list) or not v:
            return _bulk(None)
        return _bulk(v.pop())

    # zsets (score dict; order computed on read)

    def _zset(self, k: bytes) -> dict:
        v = self.data.get(k)
        if v is None:
            v = self.data[k] = _ZSet()
        if not isinstance(v, _ZSet):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_zadd(self, a):
        args = a[1:]
        nx = False
        if args and bytes(args[0]).upper() == b"NX":
            nx = True
            args = args[1:]
        z = self._zset(bytes(a[0]))
        added = 0
        for i in range(0, len(args) - 1, 2):
            score, member = float(args[i]), bytes(args[i + 1])
            if member not in z:
                z[member] = score
                added += 1
            elif not nx:
                z[member] = score
        return _int(added)

    def _cmd_zscore(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet) or bytes(a[1]) not in v:
            return _bulk(None)
        return _bulk(repr(v[bytes(a[1])]).encode())

    def _cmd_zincrby(self, a):
        z = self._zset(bytes(a[0]))
        m = bytes(a[2])
        z[m] = z.get(m, 0.0) + float(a[1])
        return _bulk(repr(z[m]).encode())

    def _cmd_zrem(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet):
            return _int(0)
        n = 0
        for m in a[1:]:
            if v.pop(bytes(m), None) is not None:
                n += 1
        return _int(n)

    def _cmd_zcard(self, a):
        v = self.data.get(bytes(a[0]))
        return _int(len(v) if isinstance(v, _ZSet) else 0)

    def _cmd_zrange(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet):
            return _array([])
        withscores = len(a) > 3 and bytes(a[3]).upper() == b"WITHSCORES"
        ordered = sorted(v.items(), key=lambda kv: (kv[1], kv[0]))
        start, stop = int(a[1]), int(a[2])
        n = len(ordered)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        start = max(0, start)
        window = [] if stop < start else ordered[start:stop + 1]
        out = []
        for m, s in window:
            out.append(_bulk(m))
            if withscores:
                out.append(_bulk(repr(s).encode()))
        return _array(out)

    # HLL (registers via our codec; hash = native murmur3 low half — the
    # same family the port's sketches use, so PFCOUNT here agrees with the
    # framework's estimates on identical key sets)

    def _regs(self, k: bytes) -> np.ndarray:
        v = self.data.get(k)
        if v is None:
            return np.zeros(hyll.M, np.uint8)
        if not isinstance(v, bytes):
            raise ValueError("WRONGTYPE")
        return hyll.decode(v)

    def _cmd_pfadd(self, a):
        k = bytes(a[0])
        existed = k in self.data
        regs = self._regs(k)
        before = regs.copy()
        keys = [bytes(x) for x in a[1:]]
        if keys:
            if self.hll_hash == "redis":
                hyll.fold_redis(keys, regs)  # real-server semantics
            else:
                native.hll_fold(keys, regs)
        self.data[k] = hyll.encode_dense(
            regs, family="redis" if self.hll_hash == "redis" else "m3")
        return _int(1 if (regs != before).any() or not existed else 0)

    def _cmd_pfcount(self, a):
        regs = np.zeros(hyll.M, np.uint8)
        for k in a:
            regs = np.maximum(regs, self._regs(bytes(k)))
        # Pure-numpy estimator: the server thread must never touch a device
        # (a first-compile stall here would blow client response timeouts).
        return _int(int(round(hyll.estimate(regs))))

    def _cmd_pfmerge(self, a):
        dest = bytes(a[0])
        regs = self._regs(dest)
        for k in a[1:]:
            regs = np.maximum(regs, self._regs(bytes(k)))
        self.data[dest] = hyll.encode_dense(
            regs, family="redis" if self.hll_hash == "redis" else "m3")
        return _ok()

    # zset range-by-score family (mapcache TTL zsets + eviction scripts)

    @staticmethod
    def _parse_score_bound(raw: bytes) -> Tuple[float, bool]:
        """Returns (score, exclusive) for min/max syntax: 1.5, (1.5, -inf, +inf."""
        s = bytes(raw)
        exclusive = s.startswith(b"(")
        if exclusive:
            s = s[1:]
        if s in (b"-inf", b"-INF"):
            return float("-inf"), exclusive
        if s in (b"+inf", b"inf", b"+INF", b"INF"):
            return float("inf"), exclusive
        return float(s), exclusive

    def _zrangebyscore_items(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet):
            return []
        lo, lo_ex = self._parse_score_bound(a[1])
        hi, hi_ex = self._parse_score_bound(a[2])
        items = sorted(v.items(), key=lambda kv: (kv[1], kv[0]))
        return [
            (m, s) for m, s in items
            if (s > lo if lo_ex else s >= lo) and (s < hi if hi_ex else s <= hi)
        ]

    def _cmd_zrangebyscore(self, a):
        items = self._zrangebyscore_items(a)
        withscores = b"WITHSCORES" in [bytes(x).upper() for x in a[3:]]
        items = self._apply_limit(items, a, 3)
        out = []
        for m, s in items:
            out.append(_bulk(m))
            if withscores:
                out.append(_bulk(repr(s).encode()))
        return _array(out)

    def _cmd_zcount(self, a):
        return _int(len(self._zrangebyscore_items(a)))

    def _cmd_zremrangebyscore(self, a):
        items = self._zrangebyscore_items(a)
        v = self.data.get(bytes(a[0]))
        for m, _ in items:
            v.pop(m, None)
        if isinstance(v, _ZSet) and not v:
            self.data.pop(bytes(a[0]), None)
        return _int(len(items))

    # -- set algebra / sampling (RedisCommands.java:60-128 families) --------

    def _cmd_spop(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, set) or not v:
            return _array([]) if len(a) > 1 else _bulk(None)
        if len(a) > 1:
            n = min(int(a[1]), len(v))
            out = [v.pop() for _ in range(n)]
            if not v:
                self.data.pop(bytes(a[0]), None)
            return _array([_bulk(m) for m in out])
        m = v.pop()
        if not v:
            self.data.pop(bytes(a[0]), None)
        return _bulk(m)

    def _cmd_srandmember(self, a):
        import random as _random

        v = self.data.get(bytes(a[0]))
        if not isinstance(v, set) or not v:
            return _array([]) if len(a) > 1 else _bulk(None)
        members = list(v)
        if len(a) > 1:
            n = int(a[1])
            if n < 0:
                picks = [_random.choice(members) for _ in range(-n)]
            else:
                picks = _random.sample(members, min(n, len(members)))
            return _array([_bulk(m) for m in picks])
        return _bulk(_random.choice(members))

    def _cmd_smove(self, a):
        src = self.data.get(bytes(a[0]))
        m = bytes(a[2])
        if not isinstance(src, set) or m not in src:
            return _int(0)
        src.discard(m)
        if not src:
            self.data.pop(bytes(a[0]), None)
        self._set(bytes(a[1])).add(m)
        return _int(1)

    def _sets_for(self, keys):
        out = []
        for k in keys:
            v = self.data.get(bytes(k))
            out.append(v if isinstance(v, set) else set())
        return out

    def _set_algebra(self, which: str, keys) -> set:
        sets = self._sets_for(keys)
        if not sets:
            return set()
        if which == "inter":
            return set.intersection(*sets)
        if which == "union":
            return set.union(*sets)
        return sets[0].difference(*sets[1:])

    def _cmd_sinter(self, a):
        return _array([_bulk(m) for m in sorted(self._set_algebra("inter", a))])

    def _cmd_sunion(self, a):
        return _array([_bulk(m) for m in sorted(self._set_algebra("union", a))])

    def _cmd_sdiff(self, a):
        return _array([_bulk(m) for m in sorted(self._set_algebra("diff", a))])

    def _store_set(self, which: str, a):
        result = self._set_algebra(which, a[1:])
        dst = bytes(a[0])
        if result:
            self.data[dst] = set(result)
        else:
            self.data.pop(dst, None)
        return _int(len(result))

    def _cmd_sinterstore(self, a):
        return self._store_set("inter", a)

    def _cmd_sunionstore(self, a):
        return self._store_set("union", a)

    def _cmd_sdiffstore(self, a):
        return self._store_set("diff", a)

    # -- SCAN family --------------------------------------------------------
    # COUNT is a hint in Redis; returning the full collection in one page
    # with cursor 0 is valid protocol (real Redis does it for small keys).

    @staticmethod
    def _apply_limit(items, a, start: int):
        """Shared [LIMIT off cnt] tail parsing for the range-by families."""
        rest = [bytes(x).upper() for x in a[start:]]
        if b"LIMIT" in rest:
            i = rest.index(b"LIMIT")
            off, cnt = int(a[start + i + 1]), int(a[start + i + 2])
            items = items[off:] if cnt < 0 else items[off : off + cnt]
        return items

    @staticmethod
    def _scan_match(a, start: int):
        pat = None
        rest = [bytes(x).upper() for x in a[start:]]
        if b"MATCH" in rest:
            pat = bytes(a[start + rest.index(b"MATCH") + 1])
        return pat

    @staticmethod
    def _matches(m: bytes, pat) -> bool:
        return pat is None or fnmatch.fnmatchcase(
            m.decode("latin-1"), pat.decode("latin-1"))

    def _cmd_sscan(self, a):
        v = self.data.get(bytes(a[0]))
        pat = self._scan_match(a, 2)
        members = sorted(v) if isinstance(v, set) else []
        members = [m for m in members if self._matches(m, pat)]
        return _array([_bulk(b"0"), _array([_bulk(m) for m in members])])

    def _cmd_hscan(self, a):
        v = self.data.get(bytes(a[0]))
        pat = self._scan_match(a, 2)
        flat = []
        if isinstance(v, dict) and not isinstance(v, (_ZSet, _Geo)):
            for f, val in v.items():
                if self._matches(f, pat):
                    flat += [_bulk(f), _bulk(val)]
        return _array([_bulk(b"0"), _array(flat)])

    def _cmd_zscan(self, a):
        v = self.data.get(bytes(a[0]))
        pat = self._scan_match(a, 2)
        flat = []
        if isinstance(v, _ZSet):
            for m, s in sorted(v.items(), key=lambda kv: (kv[1], kv[0])):
                if self._matches(m, pat):
                    flat += [_bulk(m), _bulk(repr(s).encode())]
        return _array([_bulk(b"0"), _array(flat)])

    # -- zset rank / pop / lex / store --------------------------------------

    def _cmd_zrank(self, a, rev=False):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet) or bytes(a[1]) not in v:
            return _bulk(None)
        ordered = sorted(v.items(), key=lambda kv: (kv[1], kv[0]))
        if rev:
            ordered = ordered[::-1]
        for i, (m, _) in enumerate(ordered):
            if m == bytes(a[1]):
                return _int(i)
        return _bulk(None)

    def _cmd_zrevrank(self, a):
        return self._cmd_zrank(a, rev=True)

    def _zpop(self, a, last: bool):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet) or not v:
            return _array([])
        n = int(a[1]) if len(a) > 1 else 1
        ordered = sorted(v.items(), key=lambda kv: (kv[1], kv[0]))
        if last:
            ordered = ordered[::-1]
        out = []
        for m, s in ordered[:n]:
            del v[m]
            out += [_bulk(m), _bulk(repr(s).encode())]
        if not v:
            self.data.pop(bytes(a[0]), None)
        return _array(out)

    def _cmd_zpopmin(self, a):
        return self._zpop(a, last=False)

    def _cmd_zpopmax(self, a):
        return self._zpop(a, last=True)

    def _cmd_zmscore(self, a):
        v = self.data.get(bytes(a[0]))
        out = []
        for m in a[1:]:
            if isinstance(v, _ZSet) and bytes(m) in v:
                out.append(_bulk(repr(v[bytes(m)]).encode()))
            else:
                out.append(_bulk(None))
        return _array(out)

    @staticmethod
    def _parse_lex_bound(raw: bytes, is_min: bool):
        """(value, inclusive) for -, +, [m, (m syntax."""
        s = bytes(raw)
        if s == b"-":
            return (None, True) if is_min else (b"", True)
        if s == b"+":
            return (None, True)
        if s.startswith(b"["):
            return s[1:], True
        if s.startswith(b"("):
            return s[1:], False
        raise ValueError("min or max not valid string range item")

    def _lex_items(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet):
            return []
        lo, lo_inc = self._parse_lex_bound(a[1], True)
        hi, hi_inc = self._parse_lex_bound(a[2], False)
        out = []
        for m in sorted(v):
            if lo is not None and (m < lo if lo_inc else m <= lo):
                continue
            if bytes(a[2]) != b"+":
                if hi_inc and m > hi:
                    continue
                if not hi_inc and m >= hi:
                    continue
            out.append(m)
        return out

    def _cmd_zrangebylex(self, a):
        items = self._lex_items(a)
        items = self._apply_limit(items, a, 3)
        return _array([_bulk(m) for m in items])

    def _cmd_zrevrangebylex(self, a):
        # args come as key max min
        items = self._lex_items([a[0], a[2], a[1]])[::-1]
        items = self._apply_limit(items, a, 3)
        return _array([_bulk(m) for m in items])

    def _cmd_zremrangebylex(self, a):
        items = self._lex_items(a)
        v = self.data.get(bytes(a[0]))
        for m in items:
            v.pop(m, None)
        if isinstance(v, _ZSet) and not v:
            self.data.pop(bytes(a[0]), None)
        return _int(len(items))

    def _cmd_zremrangebyrank(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _ZSet):
            return _int(0)
        ordered = sorted(v.items(), key=lambda kv: (kv[1], kv[0]))
        start, stop = int(a[1]), int(a[2])
        n = len(ordered)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        doomed = [] if stop < start else ordered[max(0, start) : stop + 1]
        for m, _ in doomed:
            del v[m]
        if not v:
            self.data.pop(bytes(a[0]), None)
        return _int(len(doomed))

    def _cmd_zrevrangebyscore(self, a):
        # args: key max min [...] — reuse the ascending path with swapped
        # bounds, then reverse.
        items = self._zrangebyscore_items([a[0], a[2], a[1]])[::-1]
        withscores = b"WITHSCORES" in [bytes(x).upper() for x in a[3:]]
        items = self._apply_limit(items, a, 3)
        out = []
        for m, s in items:
            out.append(_bulk(m))
            if withscores:
                out.append(_bulk(repr(s).encode()))
        return _array(out)

    def _zstore(self, which: str, a):
        dst = bytes(a[0])
        numkeys = int(a[1])
        maps = []
        for k in a[2 : 2 + numkeys]:
            v = self.data.get(bytes(k))
            maps.append(dict(v) if isinstance(v, _ZSet) else {})
        if which == "union":
            out = {}
            for m in maps:
                for member, score in m.items():
                    out[member] = out.get(member, 0.0) + score
        else:
            common = set(maps[0]) if maps else set()
            for m in maps[1:]:
                common &= set(m)
            out = {member: sum(m.get(member, 0.0) for m in maps) for member in common}
        if out:
            z = _ZSet()
            z.update(out)
            self.data[dst] = z
        else:
            self.data.pop(dst, None)
        return _int(len(out))

    def _cmd_zunionstore(self, a):
        return self._zstore("union", a)

    def _cmd_zinterstore(self, a):
        return self._zstore("inter", a)

    # -- list surgery -------------------------------------------------------

    def _cmd_linsert(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list):
            return _int(0)
        where = bytes(a[1]).upper()
        pivot, val = bytes(a[2]), bytes(a[3])
        try:
            idx = v.index(pivot)
        except ValueError:
            return _int(-1)
        v.insert(idx if where == b"BEFORE" else idx + 1, val)
        return _int(len(v))

    def _cmd_ltrim(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list):
            return _ok()
        start, stop = int(a[1]), int(a[2])
        n = len(v)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        v[:] = [] if stop < max(0, start) else v[max(0, start) : stop + 1]
        if not v:
            self.data.pop(bytes(a[0]), None)
        return _ok()

    def _cmd_rpoplpush(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, list) or not v:
            return _bulk(None)
        item = v.pop()
        if not v:
            self.data.pop(bytes(a[0]), None)
        self._list(bytes(a[1])).insert(0, item)
        return _bulk(item)

    def _cmd_lpos(self, a):
        v = self.data.get(bytes(a[0]))
        val = bytes(a[1])
        rank = 1
        rest = [bytes(x).upper() for x in a[2:]]
        if b"RANK" in rest:
            rank = int(a[2 + rest.index(b"RANK") + 1])
        if not isinstance(v, list):
            return _bulk(None)
        order = range(len(v)) if rank > 0 else range(len(v) - 1, -1, -1)
        for i in order:
            if v[i] == val:
                return _int(i)
        return _bulk(None)

    # -- geo (member -> (lon, lat); haversine, not geohash zsets) -----------

    def _geo(self, k: bytes) -> "_Geo":
        v = self.data.get(k)
        if v is None:
            v = self.data[k] = _Geo()
        if not isinstance(v, _Geo):
            raise ValueError("WRONGTYPE")
        return v

    def _cmd_geoadd(self, a):
        g = self._geo(bytes(a[0]))
        added = 0
        for i in range(1, len(a) - 2, 3):
            member = bytes(a[i + 2])
            if member not in g:
                added += 1
            g[member] = (float(a[i]), float(a[i + 1]))
        return _int(added)

    def _cmd_geopos(self, a):
        v = self.data.get(bytes(a[0]))
        out = []
        for m in a[1:]:
            if isinstance(v, _Geo) and bytes(m) in v:
                lon, lat = v[bytes(m)]
                out.append(_array([_bulk(repr(lon).encode()),
                                   _bulk(repr(lat).encode())]))
            else:
                out.append(b"*-1\r\n")
        return _array(out)

    @staticmethod
    def _geo_unit_m(u: bytes) -> float:
        return {b"M": 1.0, b"KM": 1000.0, b"MI": 1609.344, b"FT": 0.3048}[u.upper()]

    def _cmd_geodist(self, a):
        from redisson_tpu_torch.structures.extended import _haversine_m

        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _Geo):
            return _bulk(None)
        p1, p2 = v.get(bytes(a[1])), v.get(bytes(a[2]))
        if p1 is None or p2 is None:
            return _bulk(None)
        d = float(_haversine_m(p1[0], p1[1], p2[0], p2[1]))
        if len(a) > 3:
            d /= self._geo_unit_m(bytes(a[3]))
        return _bulk(repr(d).encode())

    def _georadius(self, key: bytes, lon0: float, lat0: float, radius: float,
                   unit: bytes, rest_args) -> bytes:
        from redisson_tpu_torch.structures.extended import _haversine_m

        v = self.data.get(key)
        if not isinstance(v, _Geo) or not v:
            return _array([])
        rest = [bytes(x).upper() for x in rest_args]
        withcoord = b"WITHCOORD" in rest
        withdist = b"WITHDIST" in rest
        count = None
        if b"COUNT" in rest:
            count = int(rest_args[rest.index(b"COUNT") + 1])
        unit_m = self._geo_unit_m(unit)
        radius_m = radius * unit_m
        hits = []
        for m, (lon, lat) in v.items():
            d = float(_haversine_m(lon0, lat0, lon, lat))
            if d <= radius_m:
                hits.append((m, d / unit_m, lon, lat))
        hits.sort(key=lambda h: h[1])
        if count is not None:
            hits = hits[:count]
        out = []
        for m, d, lon, lat in hits:
            if not withcoord and not withdist:
                out.append(_bulk(m))
                continue
            row = [_bulk(m)]
            if withdist:
                row.append(_bulk(repr(d).encode()))
            if withcoord:
                row.append(_array([_bulk(repr(lon).encode()),
                                   _bulk(repr(lat).encode())]))
            out.append(_array(row))
        return _array(out)

    def _cmd_georadius(self, a):
        return self._georadius(bytes(a[0]), float(a[1]), float(a[2]),
                               float(a[3]), bytes(a[4]), a[5:])

    def _cmd_georadiusbymember(self, a):
        v = self.data.get(bytes(a[0]))
        if not isinstance(v, _Geo) or bytes(a[1]) not in v:
            return _array([])
        lon0, lat0 = v[bytes(a[1])]
        return self._georadius(bytes(a[0]), lon0, lat0, float(a[2]),
                               bytes(a[3]), a[4:])

    # -- scripting (EVAL via the mini-Lua interpreter) ----------------------

    # Structured value -> RESP bytes, for script return values.
    def _encode_value(self, v) -> bytes:
        if v is None:
            return _bulk(None)
        if isinstance(v, bool):
            return _int(1) if v else _bulk(None)
        if isinstance(v, int):
            return _int(v)
        if isinstance(v, (bytes, bytearray, memoryview)):
            return _bulk(bytes(v))
        if isinstance(v, list):
            return _array([self._encode_value(x) for x in v])
        if isinstance(v, dict):
            if "ok" in v:
                ok = v["ok"]
                return b"+" + (ok if isinstance(ok, bytes) else str(ok).encode()) + b"\r\n"
            if "err" in v:
                err = v["err"]
                return b"-" + (err if isinstance(err, bytes) else str(err).encode()) + b"\r\n"
        raise ValueError(f"unencodable script return {type(v).__name__}")

    # redis.call bridge: run a command through _dispatch and convert its
    # RESP bytes back into a structured value for the interpreter.
    _SCRIPT_FORBIDDEN = frozenset({
        "EVAL", "EVALSHA", "SCRIPT", "SUBSCRIBE", "UNSUBSCRIBE", "PSUBSCRIBE",
        "PUNSUBSCRIBE", "BLPOP", "BRPOP", "AUTH", "DROPCONN",
    })

    def _script_redis_call(self, args: List[bytes]):
        if not args:
            raise mini_lua.LuaError(b"wrong number of arguments")
        name = bytes(args[0]).upper().decode()
        if name in self._SCRIPT_FORBIDDEN:
            raise mini_lua.LuaError(
                b"This Redis command is not allowed from scripts: " + bytes(args[0])
            )
        try:
            raw = self._dispatch(name, [bytes(a) for a in args[1:]])
        except mini_lua.LuaError:
            raise
        except Exception as e:  # noqa: BLE001 - surface as a script error
            raise mini_lua.LuaError(str(e).encode())
        if raw.startswith(b"-"):
            raise mini_lua.LuaError(raw[1:].split(b"\r\n", 1)[0])
        if raw.startswith(b"+"):
            return {"ok": raw[1:].split(b"\r\n", 1)[0]}
        parser = proto.RespParser()
        try:
            vals = parser.feed(raw)
        finally:
            parser.close()
        v = vals[0]
        if isinstance(v, proto.RespError):
            raise mini_lua.LuaError(str(v).encode())
        return v

    def _run_script(self, source: bytes, a: List[bytes]) -> bytes:
        numkeys = int(a[1])
        keys = [bytes(k) for k in a[2 : 2 + numkeys]]
        argv = [bytes(x) for x in a[2 + numkeys :]]
        try:
            result = mini_lua.run_script(source, keys, argv, self._script_redis_call)
        except mini_lua.LuaError as e:
            return _err(f"Error running script: {e}")
        return self._encode_value(result)

    def _cmd_eval(self, a):
        source = bytes(a[0])
        self._scripts[hashlib.sha1(source).hexdigest().encode()] = source
        return self._run_script(source, a)

    def _cmd_evalsha(self, a):
        source = self._scripts.get(bytes(a[0]).lower())
        if source is None:
            return b"-NOSCRIPT No matching script. Please use EVAL.\r\n"
        return self._run_script(source, a)

    def _cmd_script(self, a):
        sub = bytes(a[0]).upper()
        if sub == b"LOAD":
            source = bytes(a[1])
            sha = hashlib.sha1(source).hexdigest().encode()
            self._scripts[sha] = source
            return _bulk(sha)
        if sub == b"EXISTS":
            return _array([
                _int(1 if bytes(s).lower() in self._scripts else 0) for s in a[1:]
            ])
        if sub == b"FLUSH":
            self._scripts.clear()
            return _ok()
        return _err(f"unknown SCRIPT subcommand {sub.decode()}")

    # -- pub/sub ------------------------------------------------------------

    def _do_subscribe(self, name: str, a: List[bytes], writer) -> bytes:
        chans, pats = self._subs.setdefault(writer, (set(), set()))
        out = []
        if name == "SUBSCRIBE":
            for c in a:
                chans.add(bytes(c))
                out.append(_array([_bulk(b"subscribe"), _bulk(bytes(c)),
                                   _int(len(chans) + len(pats))]))
        elif name == "PSUBSCRIBE":
            for p in a:
                pats.add(bytes(p))
                out.append(_array([_bulk(b"psubscribe"), _bulk(bytes(p)),
                                   _int(len(chans) + len(pats))]))
        elif name == "UNSUBSCRIBE":
            targets = [bytes(c) for c in a] or sorted(chans)
            for c in targets:
                chans.discard(c)
                out.append(_array([_bulk(b"unsubscribe"), _bulk(c),
                                   _int(len(chans) + len(pats))]))
        else:  # PUNSUBSCRIBE
            targets = [bytes(p) for p in a] or sorted(pats)
            for p in targets:
                pats.discard(p)
                out.append(_array([_bulk(b"punsubscribe"), _bulk(p),
                                   _int(len(chans) + len(pats))]))
        return b"".join(out)

    def _cmd_publish(self, a):
        channel, payload = bytes(a[0]), bytes(a[1])
        receivers = self._deliver_publish(channel, payload)
        # Redis Cluster broadcasts PUBLISH over the cluster bus: a
        # subscriber on ANY node receives messages published on any other.
        # The reply, like real Redis, counts only THIS node's receivers.
        state = getattr(self, "cluster_state", None)
        for peer in getattr(state, "servers", []) if state else ():
            if peer is not self:
                peer._deliver_publish(channel, payload)
        return _int(receivers)

    def _deliver_publish(self, channel: bytes, payload: bytes) -> int:
        receivers = 0
        for writer, (chans, pats) in list(self._subs.items()):
            frames = []
            if channel in chans:
                frames.append(_array([_bulk(b"message"), _bulk(channel),
                                      _bulk(payload)]))
            for p in pats:
                if fnmatch.fnmatchcase(channel.decode("latin-1"),
                                       p.decode("latin-1")):
                    frames.append(_array([_bulk(b"pmessage"), _bulk(p),
                                          _bulk(channel), _bulk(payload)]))
            if frames:
                receivers += 1
                try:
                    writer.write(b"".join(frames))
                except Exception:  # noqa: BLE001 - dying subscriber
                    self._subs.pop(writer, None)
        return receivers

    # -- blocking pops ------------------------------------------------------

    async def _blocking_pop(self, name: str, a: List[bytes]) -> bytes:
        if name == "BRPOPLPUSH":
            keys = [bytes(a[0])]
            dest = bytes(a[1])
        else:
            keys = [bytes(k) for k in a[:-1]]
            dest = None
        timeout = float(a[-1])
        loop = asyncio.get_running_loop()
        deadline = None if timeout == 0 else loop.time() + timeout
        while True:
            self._purge_expired()
            for k in keys:
                v = self.data.get(k)
                if isinstance(v, list) and v:
                    item = v.pop(0) if name == "BLPOP" else v.pop()
                    if not v:
                        self.data.pop(k, None)
                    if dest is not None:
                        self._list(dest).insert(0, item)
                        async with self._push_cond:
                            self._push_cond.notify_all()
                        return _bulk(item)
                    return _array([_bulk(k), _bulk(item)])
            nil = _bulk(None) if dest is not None else b"*-1\r\n"
            if self._stopping:
                return nil
            remaining = None if deadline is None else deadline - loop.time()
            if remaining is not None and remaining <= 0:
                return nil
            try:
                async with self._push_cond:
                    await asyncio.wait_for(self._push_cond.wait(), remaining)
            except asyncio.TimeoutError:
                return nil


class EmbeddedRedis:
    """Run a FakeRedisServer on a background event-loop thread — the
    test fixture analogue of RedisRunner.startDefaultRedisServerInstance."""

    def __init__(self, password: Optional[str] = None, port: int = 0,
                 share_with: Optional["EmbeddedRedis"] = None,
                 hll_hash: str = "murmur3"):
        import threading
        if share_with is None:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(target=self._loop.run_forever,
                                            name="rtpu-fake-redis", daemon=True)
            self._thread.start()
            self._owns_loop = True
        else:
            # Same event loop as the peer: replication forwards between the
            # two servers with plain calls, no cross-thread races.
            self._loop = share_with._loop
            self._thread = share_with._thread
            self._owns_loop = False
        self.server = FakeRedisServer(password=password, port=port,
                                      hll_hash=hll_hash)
        asyncio.run_coroutine_threadsafe(self.server.start(), self._loop).result(10)

    @classmethod
    def on_port(cls, port: int, password: Optional[str] = None) -> "EmbeddedRedis":
        """Restart fixture: bind an explicit port (kill/restart tests)."""
        return cls(password=password, port=port)

    @classmethod
    def pair(cls, password: Optional[str] = None):
        """(master, slave) on one event loop with write replication — the
        in-process analogue of the reference's replicating redis-server
        fixtures (RedisRunner master/slave configs). Stop the slave first;
        the master owns the loop."""
        master = cls(password=password)
        slave = cls(password=password, share_with=master)
        master.server.replicas.append(slave.server)
        slave.server.replicating_from = f"127.0.0.1:{master.port}"
        return master, slave

    @property
    def port(self) -> int:
        return self.server.port

    def kill(self) -> None:
        """Fault injection: stop just the server (sockets die), leaving the
        event loop running — required when this instance shares its loop
        with a peer (pair()); the process-kill analogue."""
        asyncio.run_coroutine_threadsafe(self.server.stop(), self._loop).result(10)

    def stop(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(), self._loop).result(10)
        if self._owns_loop:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            self._loop.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class ClusterState:
    """Shared fixture topology for an in-process cluster: slot-range
    ownership + roles, rendered as CLUSTER NODES wire text.

    The reference never CI-tests a real cluster (SURVEY §4 weak spot —
    its cluster methods are @Test-disabled); this state object plus N
    FakeRedisServers on one event loop is the in-process fake topology the
    survey calls for. Mutations (move_slots, fail_over) take effect on
    every node at once, like a settled cluster epoch.
    """

    MAX_SLOT = 16384

    def __init__(self):
        # addr -> {"id": str, "role": "master"|"slave", "master": addr|None}
        self.nodes: Dict[str, Dict] = {}
        # live FakeRedisServer peers for the cluster-bus PUBLISH broadcast
        self.servers: List[FakeRedisServer] = []
        # (start, end) inclusive -> master addr
        self.ranges: List[Tuple[int, int, str]] = []

    def add_master(self, addr: str, ranges: List[Tuple[int, int]]) -> None:
        self.nodes[addr] = {"id": hashlib.sha1(addr.encode()).hexdigest(),
                            "role": "master", "master": None}
        for s, e in ranges:
            self.ranges.append((s, e, addr))

    def add_slave(self, addr: str, master_addr: str) -> None:
        self.nodes[addr] = {"id": hashlib.sha1(addr.encode()).hexdigest(),
                            "role": "slave", "master": master_addr}

    def owner_of(self, slot: int) -> Optional[str]:
        for s, e, addr in self.ranges:
            if s <= slot <= e:
                return addr
        return None

    def move_slots(self, start: int, end: int, new_owner: str) -> None:
        """Live slot migration (ClusterConnectionManager.java:508-541): the
        [start, end] range changes hands; every node redirects at once."""
        out: List[Tuple[int, int, str]] = []
        for s, e, addr in self.ranges:
            if e < start or s > end:
                out.append((s, e, addr))
                continue
            if s < start:
                out.append((s, start - 1, addr))
            if e > end:
                out.append((end + 1, e, addr))
        out.append((start, end, new_owner))
        self.ranges = out

    def fail_over(self, master_addr: str, slave_addr: str) -> None:
        """Swap roles: the slave takes the master's ranges (the settled
        state after a cluster failover; ClusterConnectionManager.java:
        429-455 diffs exactly this)."""
        self.ranges = [(s, e, slave_addr if a == master_addr else a)
                       for s, e, a in self.ranges]
        self.nodes[slave_addr]["role"] = "master"
        self.nodes[slave_addr]["master"] = None
        self.nodes[master_addr]["role"] = "slave"
        self.nodes[master_addr]["master"] = slave_addr

    def nodes_text(self, self_addr: Optional[str]) -> str:
        """CLUSTER NODES format: `<id> <addr> <flags> <master-id|-> <ping>
        <pong> <epoch> <state> [slots...]` per node."""
        lines = []
        for addr, n in self.nodes.items():
            flags = n["role"]
            if addr == self_addr:
                flags = "myself," + flags
            master_id = "-"
            if n["master"] is not None:
                master_id = self.nodes[n["master"]]["id"]
            slots = ""
            if n["role"] == "master":
                parts = [f"{s}-{e}" if s != e else str(s)
                         for s, e, a in sorted(self.ranges) if a == addr]
                slots = " " + " ".join(parts) if parts else ""
            lines.append(
                f"{n['id']} {addr} {flags} {master_id} 0 0 1 connected{slots}")
        return "\n".join(lines) + "\n"


class ClusterFixture:
    """N fake masters on one event loop, slots split evenly, shared
    ClusterState — stop() tears all of them down."""

    def __init__(self, n_masters: int = 3):
        self.state = ClusterState()
        self.embedded: List[EmbeddedRedis] = []
        first = EmbeddedRedis()
        self.embedded.append(first)
        for _ in range(n_masters - 1):
            self.embedded.append(EmbeddedRedis(share_with=first))
        per = ClusterState.MAX_SLOT // n_masters
        for i, er in enumerate(self.embedded):
            start = i * per
            end = (i + 1) * per - 1 if i < n_masters - 1 else ClusterState.MAX_SLOT - 1
            addr = f"127.0.0.1:{er.port}"
            self.state.add_master(addr, [(start, end)])
            er.server.cluster_state = self.state
            er.server.cluster_self = addr
            self.state.servers.append(er.server)
        self.addresses = [f"127.0.0.1:{er.port}" for er in self.embedded]

    def server_for(self, addr: str) -> FakeRedisServer:
        for er in self.embedded:
            if f"127.0.0.1:{er.port}" == addr:
                return er.server
        raise KeyError(addr)

    def add_replica(self, master_addr: str) -> str:
        """Boot a replica of `master_addr`, register it in the topology."""
        er = EmbeddedRedis(share_with=self.embedded[0])
        self.embedded.append(er)
        addr = f"127.0.0.1:{er.port}"
        master = self.server_for(master_addr)
        master.replicas.append(er.server)
        er.server.replicating_from = master_addr
        er.server.cluster_state = self.state
        er.server.cluster_self = addr
        self.state.servers.append(er.server)
        self.state.add_slave(addr, master_addr)
        self.addresses.append(addr)
        return addr

    def stop(self) -> None:
        for er in reversed(self.embedded[1:]):
            er.kill()
        self.embedded[0].stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
