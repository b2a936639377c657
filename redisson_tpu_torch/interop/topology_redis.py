"""Multi-endpoint redis topology: master/slave routing, failover promotion,
and cluster MOVED/ASK redirects (counterpart of
`redisson_tpu.interop.topology_redis`).

The reference's L1 layer: `connection/MasterSlaveEntry.java:53-250` (write
pool on master, read pool per ReadMode with a slave balancer),
`balancer/LoadBalancerManagerImpl.java:39-90` (round-robin slave choice +
freeze/unfreeze), `cluster/ClusterConnectionManager.java:543-558` (CRC16
key-slot routing) and `command/CommandAsyncService.java:593-600, 657-685`
(MOVED re-route / ASK with ASKING prefix).

Design: one `RespConnectionPool` per endpoint — each already
carries freeze-after-N-connect-failures and a background PING re-probe
(`ConnectionPool.java:184-186, 297-386`) — and a thin sync router on top:

  * writes -> master pool; a master whose pool is frozen (or that raises a
    connect error) triggers PROMOTION of the first live slave, then one
    retry (`MasterSlaveEntry.changeMaster`, the pool-freeze-driven analogue
    of sentinel's +switch-master).
  * reads  -> per ReadMode: SLAVE (balanced round-robin over live slaves,
    master fallback when none), MASTER, or MASTER_SLAVE (master joins the
    rotation) — `ReadMode` semantics from the reference's
    `BaseMasterSlaveServersConfig`.
  * MOVED slot host:port -> re-route to (possibly new) endpoint, cache
    slot -> endpoint so later keyed commands go direct; ASK -> one-shot
    redirect prefixed with ASKING, no cache — exactly the reference's
    redirect contract.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from redisson_tpu_torch.cluster.split import split_by_owner
from redisson_tpu_torch.native import RespError
from redisson_tpu_torch.ops import crc16

# Commands safe to serve from a replica (the read-command subset of
# `client/protocol/RedisCommands.java` the structure tier emits).
READ_COMMANDS = frozenset({
    "GET", "MGET", "STRLEN", "EXISTS", "TYPE", "KEYS", "PTTL", "TTL",
    "DBSIZE", "GETBIT", "BITCOUNT", "BITPOS",
    "HGET", "HMGET", "HGETALL", "HLEN", "HKEYS", "HVALS", "HEXISTS", "HSCAN",
    "SMEMBERS", "SCARD", "SISMEMBER", "SRANDMEMBER", "SSCAN", "SINTER",
    "SUNION", "SDIFF",
    "LRANGE", "LLEN", "LINDEX", "LPOS",
    "ZSCORE", "ZMSCORE", "ZCARD", "ZCOUNT", "ZRANGE", "ZRANGEBYSCORE",
    "ZREVRANGEBYSCORE", "ZRANGEBYLEX", "ZREVRANGEBYLEX", "ZRANK", "ZREVRANK",
    "ZSCAN", "PFCOUNT", "GEOPOS", "GEODIST", "GEORADIUS",
    "GEORADIUSBYMEMBER", "SCAN", "PING",
})


# Commands whose first argument is NOT a key: never slot-route these (a
# cached MOVED entry must not hijack an EVALSHA/SCAN/PUBLISH whose arg
# happens to hash into the moved slot).
UNKEYED_COMMANDS = frozenset({
    "PING", "ECHO", "SELECT", "DBSIZE", "FLUSHALL", "KEYS", "SCRIPT",
    "EVAL", "EVALSHA", "PUBLISH", "AUTH", "SCAN", "ASKING", "SUBSCRIBE",
    "UNSUBSCRIBE", "PSUBSCRIBE", "PUNSUBSCRIBE", "INFO", "CONFIG",
})


class RoundRobinBalancer:
    """Cycle through live slaves (`RoundRobinLoadBalancer.java`)."""

    def __init__(self):
        self._i = 0

    def choose(self, live: List[str]) -> str:
        self._i += 1
        return live[self._i % len(live)]


class RandomBalancer:
    """Uniform random choice (`RandomLoadBalancer.java`)."""

    def __init__(self, seed: Optional[int] = None):
        import random

        self._rng = random.Random(seed)

    def choose(self, live: List[str]) -> str:
        return self._rng.choice(live)


class WeightedRoundRobinBalancer:
    """Weighted rotation (`WeightedRoundRobinBalancer.java`): each address
    appears `weights.get(addr, default_weight)` times per cycle. Weight
    keys accept any address form the config does ('redis://h:p', 'h:p') —
    normalized here so a weight can never be silently ignored."""

    def __init__(self, weights: Dict[str, int], default_weight: int = 1):
        self.weights = {_addr_key(k): max(1, int(v))
                        for k, v in weights.items()}
        self.default_weight = max(1, int(default_weight))
        self._i = 0
        # wheel cached per live-set: rebuilding an O(sum-of-weights) list on
        # every read (under the router lock) was hot-path waste (advisor r3)
        self._wheel_key: tuple = ()
        self._wheel: List[str] = []

    def choose(self, live: List[str]) -> str:
        key = tuple(live)
        if key != self._wheel_key:
            wheel: List[str] = []
            for a in live:
                wheel.extend([a] * self.weights.get(a, self.default_weight))
            self._wheel, self._wheel_key = wheel, key
        self._i += 1
        return self._wheel[self._i % len(self._wheel)]


def make_balancer(spec: str, weights: Optional[Dict[str, int]] = None,
                  default_weight: int = 1):
    """'round_robin' | 'random' | 'weighted' -> balancer instance."""
    if spec == "round_robin":
        return RoundRobinBalancer()
    if spec == "random":
        return RandomBalancer()
    if spec == "weighted":
        return WeightedRoundRobinBalancer(weights or {}, default_weight)
    raise ValueError(f"unknown load balancer {spec!r}")


def _addr_key(addr: str) -> str:
    """Normalize 'redis://h[:p]' / 'h[:p]' to 'h:p' (default port 6379)."""
    a = addr
    if "://" in a:
        a = a.split("://", 1)[1]
    host, _, port = a.rpartition(":")
    if not host or not port.isdigit():
        a = f"{a}:6379"
    return a


def _parse_redirect(msg: str):
    """'MOVED 1234 127.0.0.1:7001' -> (1234, '127.0.0.1:7001')."""
    parts = msg.split()
    return int(parts[1]), parts[2]


class MasterSlaveRouter:
    """Sync facade (execute/pipeline/execute_blocking/connect/close) that
    routes across endpoint pools. Drop-in where RespConnectionPool is used.

    pool_factory(host, port) -> RespConnectionPool (constructed by the
    client with its configured timeouts/sizes).
    """

    def __init__(self, pool_factory: Callable[[str, int], Any],
                 master_address: str,
                 slave_addresses: Sequence[str] = (),
                 read_mode: str = "SLAVE",
                 balancer=None):
        self._factory = pool_factory
        self._lock = threading.Lock()
        self._pools: Dict[str, Any] = {}  # "host:port" -> pool
        self._master = _addr_key(master_address)
        self._slaves: List[str] = [_addr_key(a) for a in slave_addresses]
        self.read_mode = read_mode.upper()
        self.balancer = balancer if balancer is not None else RoundRobinBalancer()
        self._slot_table: Dict[int, str] = {}  # slot -> "host:port" (MOVED)
        self.promotions = 0  # observability: master changes
        self.redirects = 0   # observability: MOVED/ASK followed
        self.closed = False  # parked blocking ops bail once set

    # -- pool bookkeeping ----------------------------------------------------

    def _pool(self, addr: str):
        with self._lock:
            p = self._pools.get(addr)
            if p is None:
                host, _, port = addr.rpartition(":")
                p = self._factory(host, int(port))
                try:
                    p.connect()
                except Exception:
                    # Reclaim the pool's IO thread NOW: an unregistered
                    # pool is unreachable from close(), and topology scan
                    # loops re-dial dead seeds every interval — leaking a
                    # thread per scan otherwise.
                    try:
                        p.close()
                    except Exception:  # noqa: BLE001
                        pass
                    raise
                self._pools[addr] = p
            return p

    def connect(self) -> None:
        self._pool(self._master)
        for a in self._slaves:
            try:
                self._pool(a)
            except Exception:  # noqa: BLE001 - a dead slave must not block boot
                pass

    def close(self) -> None:
        self.closed = True  # parked blocking ops bail instead of re-driving
        with self._lock:
            pools, self._pools = list(self._pools.values()), {}
        for p in pools:
            try:
                p.close()
            except Exception:  # noqa: BLE001
                pass

    @property
    def timeout(self) -> float:
        return self._pool(self._master).timeout

    @property
    def master_address(self) -> str:
        """Current primary endpoint. The client's coordination pub/sub
        dials through this, so subscribe connections FOLLOW topology
        changes (master promotion, sentinel switch, cluster failover) —
        the reference migrates pub/sub listeners the same way
        (MasterSlaveEntry.java:158-250)."""
        return self._master

    # -- routing -------------------------------------------------------------

    @staticmethod
    def _key_of(args) -> Optional[str]:
        if len(args) < 2 or str(args[0]).upper() in UNKEYED_COMMANDS:
            return None
        k = args[1]
        return k.decode("utf-8", "replace") if isinstance(k, bytes) else str(k)

    def _endpoint_for(self, args, write: bool) -> str:
        key = self._key_of(args)
        if key is not None and self._slot_table:
            owner = self._slot_table.get(crc16.key_slot(key))
            if owner is not None:
                return owner
        if write or self.read_mode == "MASTER":
            return self._master
        candidates = list(self._slaves)
        if self.read_mode == "MASTER_SLAVE":
            candidates.append(self._master)
        live = [a for a in candidates if not self._frozen(a)]
        if not live:
            return self._master
        return self.balancer.choose(live)

    def _frozen(self, addr: str) -> bool:
        p = self._pools.get(addr)
        return p is not None and getattr(p, "frozen", False)

    def set_master(self, addr: str) -> None:
        """Externally-driven master change (sentinel +switch-master /
        Elasticache role flip): the reference's `changeMaster`
        (`MasterSlaveConnectionManager.java:585-587`). The old master joins
        the slave rotation."""
        addr = _addr_key(addr)
        with self._lock:
            if addr == self._master:
                return
            old = self._master
            self._slaves = [a for a in self._slaves if a != addr] + [old]
            self._master = addr
            self.promotions += 1

    def add_slave(self, addr: str) -> None:
        """Sentinel +slave / -sdown: a replica (re)joins the read rotation
        (`LoadBalancerManagerImpl.java:39-90` unfreeze/add)."""
        addr = _addr_key(addr)
        with self._lock:
            if addr != self._master and addr not in self._slaves:
                self._slaves.append(addr)

    def remove_slave(self, addr: str) -> None:
        """Sentinel +sdown on a slave: drop it from the read rotation
        (`MasterSlaveEntry.slaveDown`, `MasterSlaveEntry.java:117-156`)."""
        addr = _addr_key(addr)
        with self._lock:
            self._slaves = [a for a in self._slaves if a != addr]

    def _promote(self) -> bool:
        """Master unreachable: promote the first live slave
        (`MasterSlaveEntry.changeMaster` / `slaveDown` promotion,
        `MasterSlaveEntry.java:99-156`). The old master re-enters as a
        slave — its pool's PING re-probe revives it if it comes back."""
        with self._lock:
            live = [a for a in self._slaves if not self._frozen(a)]
            if not live:
                return False
            new_master = live[0]
            old = self._master
            self._slaves = [a for a in self._slaves if a != new_master] + [old]
            self._master = new_master
            self.promotions += 1
            return True

    # -- execution with redirect/failover ------------------------------------

    def _run_on(self, addr: str, fn_name: str, *args, **kwargs):
        pool = self._pool(addr)
        return getattr(pool, fn_name)(*args, **kwargs)

    def _execute_routed(self, args, write: bool, depth: int = 0):
        addr = self._endpoint_for(args, write)
        try:
            result = self._run_on(addr, "execute", *args)
        except RespError as e:
            return self._maybe_redirect(e, args, write, depth)
        except (ConnectionError, OSError, TimeoutError):
            if write and addr == self._master and depth < 1 and self._promote():
                return self._execute_routed(args, write, depth + 1)
            if not write and depth < 2:
                # Read fallback: drop the dead endpoint from this attempt by
                # retrying — the balancer skips frozen pools.
                return self._execute_routed(args, write, depth + 1)
            raise
        if isinstance(result, RespError):
            return self._maybe_redirect(result, args, write, depth)
        return result

    def _maybe_redirect(self, err: RespError, args, write: bool, depth: int):
        msg = str(err)
        if depth >= 3:
            raise err
        if msg.startswith("MOVED"):
            slot, addr = _parse_redirect(msg)
            self._slot_table[slot] = addr
            self.redirects += 1
            try:
                result = self._run_on(addr, "execute", *args)
            except RespError as e2:
                return self._maybe_redirect(e2, args, write, depth + 1)
            if isinstance(result, RespError):
                return self._maybe_redirect(result, args, write, depth + 1)
            return result
        if msg.startswith("ASK"):
            _, addr = _parse_redirect(msg)
            self.redirects += 1
            # One-shot: ASKING + command on the importing node, no cache
            # (`CommandAsyncService.java:593-600`).
            out = self._run_on(addr, "pipeline", [("ASKING",), tuple(args)])
            result = out[1]
            if isinstance(result, RespError):
                raise result
            return result
        raise err

    def execute(self, *args) -> Any:
        name = str(args[0]).upper()
        return self._execute_routed(args, write=name not in READ_COMMANDS)

    def pipeline(self, commands: Sequence[Sequence]) -> List[Any]:
        """Per-slot pipeline split (`CommandBatchService.java:142-182`):
        group commands by owner endpoint with the same splitter the
        in-process cluster tier uses (cluster/split.py), dispatch one
        sub-pipeline per owner, reassemble replies in submission order.
        With no slot table learned yet every command resolves to the
        master, so the split degenerates to the single master pipeline
        (plus the promote-and-retry failover path)."""
        groups = split_by_owner(
            commands, lambda _i, cmd: self._endpoint_for(cmd, write=True))
        if len(groups) <= 1:
            addr = next(iter(groups), self._master)
            try:
                return self._run_on(addr, "pipeline", commands)
            except (ConnectionError, OSError, TimeoutError):
                if addr == self._master and self._promote():
                    return self._run_on(self._master, "pipeline", commands)
                raise
        out = self._pipeline_groups(commands, groups)
        return self._pipeline_redirects(commands, out)

    def _pipeline_groups(self, commands: Sequence[Sequence],
                         groups: Dict[str, List[int]]) -> List[Any]:
        """Dispatch one sub-pipeline per owner group; on a connection blip
        re-resolve EVERY command of the failed group (a concurrent rescan
        may have split its slots across owners) and resend per new owner; a
        second failure lands per-command RespErrors in the reply list,
        keeping the pipeline contract of in-list errors.
        NOTE at-least-once semantics: a command that already applied on the
        half-failed first attempt is applied again by the resend — the
        reference's batch resend carries the same caveat
        (CommandBatchService.java:332-343)."""
        out: List[Any] = [None] * len(commands)
        for addr, idxs in groups.items():
            cmds = [commands[i] for i in idxs]
            try:
                replies = self._run_on(addr, "pipeline", cmds)
            except (ConnectionError, OSError, TimeoutError):
                retry_groups: Dict[str, List[int]] = {}
                for i in idxs:
                    try:
                        raddr = self._endpoint_for(commands[i], write=True)
                    except Exception:  # noqa: BLE001 — no owner resolvable
                        raddr = addr
                    retry_groups.setdefault(raddr, []).append(i)
                for raddr, ridxs in retry_groups.items():
                    rcmds = [commands[i] for i in ridxs]
                    try:
                        rs = self._run_on(raddr, "pipeline", rcmds)
                    except Exception as exc:  # noqa: BLE001
                        rs = [RespError(f"CONNECTIONFAIL {raddr}: {exc}")
                              for _ in rcmds]
                    for i, r in zip(ridxs, rs):
                        out[i] = r
                continue
            for i, r in zip(idxs, replies):
                out[i] = r
        return out

    def _pipeline_redirects(self, commands: Sequence[Sequence],
                            out: List[Any]) -> List[Any]:
        """Resend per-command MOVED/ASK replies individually to the right
        node — the reference's batch redirect contract
        (`CommandBatchService.java:184-293` clears errors and resends only
        unfinished commands)."""
        for i, r in enumerate(out):
            if isinstance(r, RespError) and (
                str(r).startswith("MOVED") or str(r).startswith("ASK")
            ):
                # A genuine error from the redirected resend stays in the
                # reply list (same contract as untouched replies) — raising
                # here would discard every other command's result.
                try:
                    out[i] = self._maybe_redirect(r, tuple(commands[i]),
                                                  write=True, depth=0)
                except RespError as exc:
                    out[i] = exc
        return out

    def execute_blocking(self, *args, response_timeout: float) -> Any:
        addr = self._master
        try:
            return self._run_on(addr, "execute_blocking", *args,
                                response_timeout=response_timeout)
        except (ConnectionError, OSError):
            # A dead master would park blocking pops forever: promote (the
            # failed-write policy) and re-raise so the caller's re-drive
            # loop lands on the NEW master — the reference reattaches
            # in-flight blocking commands the same way on failover
            # (connection/MasterSlaveEntry.java:158-250). Promote only if
            # the failed endpoint is STILL the master: a second parked pop
            # racing the same death must not promote again (and possibly
            # reinstate the dead node).
            if addr == self._master:
                self._promote()
            raise


class SentinelManager:
    """Sentinel-driven topology (`connection/SentinelConnectionManager.java:
    50-192`): bootstrap master/slaves from any answering sentinel
    (`SENTINEL GET-MASTER-ADDR-BY-NAME` + `SENTINEL SLAVES`), then keep a
    subscribe connection to EVERY sentinel: `+switch-master` re-points the
    master, `+slave`/`-sdown` (re)admit a replica to the read rotation,
    `+sdown` drops it.

    Wraps (and owns) a MasterSlaveRouter; exposes the same execute facade
    by delegation, so it drops into the client's `_resp` seam.
    """

    def __init__(self, pool_factory, sentinel_addresses: Sequence[str],
                 master_name: str, read_mode: str = "SLAVE",
                 pubsub_factory=None, timeout: float = 3.0,
                 sentinel_password: Optional[str] = None,
                 balancer=None):
        from redisson_tpu_torch.interop.resp_client import SyncRespClient

        self.master_name = master_name
        self._sentinels = [_addr_key(a) for a in sentinel_addresses]
        self._pubsub_factory = pubsub_factory
        self._watchers: List[Any] = []
        master = None
        slaves: List[str] = []
        errors: List[Exception] = []
        for addr in self._sentinels:
            host, _, port = addr.rpartition(":")
            probe = SyncRespClient(host=host, port=int(port), timeout=timeout,
                                   password=sentinel_password)
            # Per-attempt isolation: a sentinel that answers half the
            # bootstrap must not leak partial topology into the next try.
            attempt_master = None
            attempt_slaves: List[str] = []
            try:
                probe.connect()
                reply = probe.execute(
                    "SENTINEL", "GET-MASTER-ADDR-BY-NAME", master_name)
                if reply is None:
                    continue
                attempt_master = (
                    f"{bytes(reply[0]).decode()}:{bytes(reply[1]).decode()}")
                for info in probe.execute("SENTINEL", "SLAVES", master_name) or []:
                    # flat field-value pairs per slave, like real sentinel
                    d = {bytes(info[i]): bytes(info[i + 1])
                         for i in range(0, len(info), 2)}
                    attempt_slaves.append(
                        f"{d[b'ip'].decode()}:{d[b'port'].decode()}")
                master, slaves = attempt_master, attempt_slaves
                break
            except Exception as e:  # noqa: BLE001 - try the next sentinel
                errors.append(e)
            finally:
                probe.close()
        if master is None:
            raise ConnectionError(
                f"no sentinel answered for master '{master_name}' "
                f"({errors[:1]!r})")
        self.router = MasterSlaveRouter(
            pool_factory, master, slaves, read_mode=read_mode,
            balancer=balancer)

    def connect(self) -> None:
        self.router.connect()
        self._watch_sentinels()

    def _watch_sentinels(self) -> None:
        """Subscribe to every sentinel's event channels
        (`SentinelConnectionManager.java:143-192`)."""
        if self._pubsub_factory is None:
            return
        for addr in self._sentinels:
            host, _, port = addr.rpartition(":")
            try:
                ps = self._pubsub_factory(host, int(port))
                ps.connect()
                ps.subscribe("+switch-master", self._on_switch_master)
                ps.subscribe("+slave", self._on_slave_event)
                ps.subscribe("-sdown", self._on_slave_event)
                ps.subscribe("+sdown", self._on_sdown)
                self._watchers.append(ps)
            except Exception:  # noqa: BLE001 - a dead sentinel is tolerated
                pass

    def _on_switch_master(self, channel: str, payload: bytes) -> None:
        # "+switch-master <name> <oldip> <oldport> <newip> <newport>"
        parts = payload.decode("utf-8", "replace").split()
        if len(parts) >= 5 and parts[0] == self.master_name:
            self.router.set_master(f"{parts[3]}:{parts[4]}")

    def _slave_of_mine(self, payload: bytes) -> Optional[str]:
        # "slave <name> <ip> <port> @ <master-name> <master-ip> <...>"
        parts = payload.decode("utf-8", "replace").split()
        if (len(parts) >= 6 and parts[0] == "slave" and parts[4] == "@"
                and parts[5] == self.master_name):
            return f"{parts[2]}:{parts[3]}"
        return None

    def _on_slave_event(self, channel: str, payload: bytes) -> None:
        addr = self._slave_of_mine(payload)
        if addr is not None:
            self.router.add_slave(addr)

    def _on_sdown(self, channel: str, payload: bytes) -> None:
        addr = self._slave_of_mine(payload)
        if addr is not None:
            self.router.remove_slave(addr)

    # -- facade delegation ---------------------------------------------------

    @property
    def master_address(self) -> str:
        return self.router.master_address

    @property
    def promotions(self) -> int:
        return self.router.promotions

    @property
    def timeout(self) -> float:
        return self.router.timeout

    def execute(self, *args):
        return self.router.execute(*args)

    def pipeline(self, commands):
        return self.router.pipeline(commands)

    def execute_blocking(self, *args, response_timeout: float):
        return self.router.execute_blocking(
            *args, response_timeout=response_timeout)

    def close(self) -> None:
        for ps in self._watchers:
            try:
                ps.close()
            except Exception:  # noqa: BLE001
                pass
        self._watchers.clear()
        self.router.close()


class RolePollingMonitor:
    """Elasticache-style failure detection
    (`connection/ElasticacheConnectionManager.java`): no sentinel protocol —
    poll `INFO replication` on every known endpoint and re-point the router
    when the AWS-side (or test-side) promotion flips a replica's role to
    master while the configured master stopped answering as one."""

    def __init__(self, router: MasterSlaveRouter, scan_interval_s: float = 1.0):
        self.router = router
        self.scan_interval_s = scan_interval_s
        self.scans = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="rtpu-role-poll", daemon=True)
        self._thread.start()

    def _role_of(self, addr: str) -> Optional[str]:
        """INFO through the router's per-endpoint pool: the pool carries
        the credentials and freeze/re-probe state, and the probe reuses its
        live connections instead of dialing fresh sockets every scan."""
        try:
            info = self.router._pool(addr).execute("INFO", "replication")
            for line in bytes(info).decode("utf-8", "replace").splitlines():
                if line.startswith("role:"):
                    return line.split(":", 1)[1].strip()
            return None
        except Exception:  # noqa: BLE001 - unreachable node has no role
            return None

    def _loop(self) -> None:
        while not self._stop.wait(self.scan_interval_s):
            self.scans += 1
            master = self.router.master_address
            if self._role_of(master) == "master":
                continue  # configured master still answers as master
            with self.router._lock:
                candidates = list(self.router._slaves)
            for addr in candidates:
                if self._role_of(addr) == "master":
                    self.router.set_master(addr)
                    break

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def parse_cluster_nodes(text: str) -> List[Dict]:
    """Parse CLUSTER NODES wire text into partitions:
    [{"master": addr, "slaves": [addr...], "ranges": [(s, e)...]}].

    Format per node line (`cluster/ClusterNodeInfo.java` fields):
    `<id> <addr> <flags,csv> <master-id|-> <ping> <pong> <epoch> <state>
    [slot | start-end | [importing/migrating annotations]]...`. Nodes
    flagged fail/noaddr are skipped like the reference's FAIL filter
    (`ClusterConnectionManager.java:581-587`).
    """
    masters: Dict[str, Dict] = {}   # node-id -> partition
    slaves: List[Tuple[str, str]] = []  # (addr, master-id)
    for line in text.strip().splitlines():
        parts = line.split()
        if len(parts) < 8:
            continue
        node_id, addr, flags = parts[0], parts[1], set(parts[2].split(","))
        # cluster-enabled redis reports addr as ip:port@cport; strip @cport
        addr = addr.split("@", 1)[0]
        if {"fail", "noaddr", "handshake"} & flags:
            continue
        if "master" in flags:
            ranges: List[Tuple[int, int]] = []
            for tok in parts[8:]:
                if tok.startswith("["):  # migrating/importing annotation
                    continue
                if "-" in tok:
                    s, _, e = tok.partition("-")
                    ranges.append((int(s), int(e)))
                else:
                    ranges.append((int(tok), int(tok)))
            masters[node_id] = {"master": addr, "slaves": [], "ranges": ranges}
        elif "slave" in flags and parts[3] != "-":
            slaves.append((addr, parts[3]))
    for addr, master_id in slaves:
        if master_id in masters:
            masters[master_id]["slaves"].append(addr)
    return list(masters.values())


class ClusterRouter(MasterSlaveRouter):
    """Slot-table-first router for cluster topologies.

    Where MasterSlaveRouter learns slot owners lazily from MOVED replies,
    this router is seeded with the full 16384-slot table by the
    ClusterTopologyManager (the reference routes every keyed command
    through its slot->MasterSlaveEntry map, `MasterSlaveConnectionManager
    .java:125` + `calcSlot`); MOVED replies still update single entries
    between rescans. Keyed pipelines split per owner and reassemble in
    submission order (`CommandBatchService.java:142-182` semantics).
    """

    def __init__(self, pool_factory: Callable[[str, int], Any],
                 seed_addresses: Sequence[str]):
        seeds = [_addr_key(a) for a in seed_addresses]
        super().__init__(pool_factory, seeds[0], [], read_mode="MASTER")
        self.seeds = seeds
        self.topology_applied = 0

    def apply_topology(self, partitions: List[Dict]) -> None:
        """Install a freshly scanned topology (full slot table swap)."""
        table: Dict[int, str] = {}
        masters: List[str] = []
        for p in partitions:
            addr = _addr_key(p["master"])
            masters.append(addr)
            for s, e in p["ranges"]:
                for slot in range(s, e + 1):
                    table[slot] = addr
        if not masters:
            return
        with self._lock:
            self._slot_table = table
            self._master = masters[0]
            # Other masters join _slaves only as fallback endpoints for
            # unkeyed reads; keyed routing always goes via the table.
            self._slaves = masters[1:]
            self.topology_applied += 1

    def known_addresses(self) -> List[str]:
        with self._lock:
            return list({*self.seeds, self._master, *self._slaves,
                         *self._slot_table.values()})

    def pipeline(self, commands: Sequence[Sequence]) -> List[Any]:
        """Split a keyed pipeline by slot owner; unkeyed commands ride with
        the master group. Always takes the split path (never the base
        class's single-master fast path) so one blip cannot void the other
        groups' results — the grouping, group dispatch with re-resolve
        retry, and per-command MOVED/ASK resend all live in the shared
        MasterSlaveRouter helpers."""
        groups = split_by_owner(
            commands, lambda _i, cmd: self._endpoint_for(cmd, write=True))
        out = self._pipeline_groups(commands, groups)
        return self._pipeline_redirects(commands, out)

    def execute_blocking(self, *args, response_timeout: float) -> Any:
        # Blocking pops are keyed: route to the key's owner.
        addr = self._endpoint_for(args, write=True)
        return self._run_on(addr, "execute_blocking", *args,
                            response_timeout=response_timeout)


class ClusterTopologyManager:
    """The cluster control plane: bootstrap from CLUSTER NODES on any seed,
    then re-scan on an interval and swap the router's slot table when the
    topology diffs — failover, slot migration, node add/remove
    (`cluster/ClusterConnectionManager.java:64-117` bootstrap, `:265-341`
    scheduled check, `:429-541` diff handling)."""

    def __init__(self, router: ClusterRouter, scan_interval_s: float = 0.0):
        self.router = router
        self.scan_interval_s = scan_interval_s
        self.scans = 0
        self.changes = 0
        self._last: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bootstrap(self) -> None:
        last_exc: Optional[Exception] = None
        for addr in self.router.seeds:
            try:
                self._scan_from(addr)
                if self.scan_interval_s > 0:
                    self._thread = threading.Thread(
                        target=self._loop, name="rtpu-cluster-scan",
                        daemon=True)
                    self._thread.start()
                return
            except Exception as exc:  # noqa: BLE001 - try the next seed
                last_exc = exc
        raise ConnectionError(
            f"no cluster seed answered CLUSTER NODES: {last_exc!r}")

    def _scan_from(self, addr: str) -> None:
        text = bytes(
            self.router._pool(addr).execute("CLUSTER", "NODES")
        ).decode("utf-8", "replace")
        partitions = parse_cluster_nodes(text)
        if not partitions:
            raise ConnectionError(f"{addr} reported an empty topology")
        key = sorted((p["master"], tuple(sorted(p["ranges"])),
                      tuple(sorted(p["slaves"]))) for p in partitions)
        old = sorted((p["master"], tuple(sorted(p["ranges"])),
                      tuple(sorted(p["slaves"]))) for p in self._last)
        if key != old:
            self.router.apply_topology(partitions)
            if self._last:
                self.changes += 1
            self._last = partitions

    def _loop(self) -> None:
        while not self._stop.wait(self.scan_interval_s):
            self.scans += 1
            for addr in self.router.known_addresses():
                try:
                    self._scan_from(addr)
                    break
                except Exception:  # noqa: BLE001 - rotate to the next node
                    continue

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
