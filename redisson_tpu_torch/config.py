"""Client configuration: the counterpart of `redisson_tpu.config` for the
single-device sketch engine on a CUDA card.

`Config.use_cuda()` is the builder, like `Config.use_tpu()`: it creates (or
returns) the `CudaConfig` section, applies any keyword overrides, and
returns that section. `use_persist(dir)`, `use_faults()`, `use_serve()`,
`use_trace()`, `use_memstat()`, `use_replicas()`, `use_cluster()` and
`use_wire()` do the same for the durability, fault, serving, trace, memory,
read-replica, cluster and RESP wire sections (the JAX package's fields and
defaults). `use_pod()` is the pod tier (`PodConfig`, a CudaConfig with the
mesh fields): the HLL bank and the BitSets / Bloom filters sharded over a
logical mesh of `num_shards` entries on the card (or the CPU with
`device="cpu"`); `mode()` says "pod". `use_redis()` returns the
`RedisConfig` section like JAX's (no overrides; set its fields): beside a
compute section it is the durability tier, which flushes the card's
sketches to a RESP server every `flush_interval_s` seconds (0 = on demand
only); alone it is the passthrough mode ("redis"): every op runs on the
RESP server and the client holds no device state.
`to_dict` / `from_dict` / `to_json` / `from_json` round-trip a Config
through plain data.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

#: ingest paths: "auto" lets the planner pick per batch size from timings
#: taken on the device and the measured link profile; "device" uses
#: `hll_impl`; "scatter" / "sort" / "segment" force that device insert
#: ("segment" = the CUDA segmented-insert kernel); "hostfold" folds keys on
#: the host (HLL registers, the Bloom host mirror); "delta" folds the three
#: write kinds into planes merged on the device by the delta_merge kernel;
#: "tape" retires such a window with one window_merge launch.
INGEST_CHOICES = ("auto", "device", "hostfold", "delta", "scatter", "sort",
                  "segment", "tape")
#: ingest paths that need the host fold library (`native.py`)
HOST_INGEST = ("hostfold", "delta", "tape")
HLL_IMPLS = ("scatter", "sort", "segment")
HLL_HASHES = ("murmur3", "redis")


def check_ingest(ingest: str) -> None:
    if ingest not in INGEST_CHOICES:
        raise ValueError(f"unknown ingest policy: {ingest!r}")


@dataclass
class CudaConfig:
    """Single-device sketch engine (mirrors `redisson_tpu.config.TpuConfig`)."""

    # "cuda:N", or "cpu" to run the same engine on the CPU (tests).
    device: str = "cuda:0"
    hll_impl: str = "scatter"  # insert used by ingest="device"
    # "murmur3" (murmur3 x64 128, the framework's family) or "redis"
    # (MurmurHash64A seed 0xadc83b19, what a Redis server's PFADD computes).
    hll_hash: str = "murmur3"
    ingest: str = "auto"
    hash_seed: int = 0
    # Coalescing cap for one dispatcher run; kernels still chunk at
    # engine.MAX_BUCKET keys per call.
    max_batch_keys: int = 1 << 23
    key_width_buckets: tuple = (16, 32, 64, 128, 256)
    # Epoch-stamped read cache entries (memoized PFCOUNT); 0 disables.
    read_cache_entries: int = 1024


@dataclass
class PodConfig(CudaConfig):
    """Mesh-sharded sketch engine (mirrors `redisson_tpu.config.PodConfig`):
    the card's HLL bank and bit arrays sharded over a logical mesh. It
    inherits `device`, so a pod asks for the card unless the caller passes
    `device="cpu"`."""

    mesh_axis: str = "shards"
    num_shards: int = 0  # mesh entries; 0 = one per card (one on the CPU)
    bank_capacity: int = 4096  # sketch rows in the sharded bank


@dataclass
class RedisConfig:
    """RESP target of the durability tier and of the passthrough mode
    (mirrors `redisson_tpu.config.RedisConfig`, every field and default)."""

    address: str = "redis://127.0.0.1:6379"
    # Master/slave topology (BaseMasterSlaveServersConfig): writes go to
    # `address`, reads balance over `slave_addresses` per `read_mode`
    # (SLAVE | MASTER | MASTER_SLAVE). Empty = single endpoint.
    slave_addresses: List[str] = field(default_factory=list)
    read_mode: str = "SLAVE"
    # Slave read balancing (reference `connection/balancer/`):
    # "round_robin" | "random" | "weighted" (weighted uses slave_weights,
    # address -> weight, with default_slave_weight for unlisted addresses).
    load_balancer: str = "round_robin"
    slave_weights: Dict[str, int] = field(default_factory=dict)
    default_slave_weight: int = 1
    # Cluster mode (ClusterServersConfig): bootstrap the slot topology with
    # CLUSTER NODES from any of these seeds, route keyed commands by CRC16
    # slot, and re-scan every cluster_scan_interval_ms (0 = bootstrap
    # only). Takes precedence over sentinel and master/slave settings.
    cluster_addresses: List[str] = field(default_factory=list)
    cluster_scan_interval_ms: int = 1000
    # Sentinel mode (SentinelServersConfig): discover the master/slaves by
    # name from these sentinels and follow +switch-master events. When set,
    # `address`/`slave_addresses` are ignored.
    sentinel_addresses: List[str] = field(default_factory=list)
    master_name: str = "mymaster"
    # Elasticache-style detection: poll INFO replication roles every N ms
    # (0 = off); needs slave_addresses.
    role_scan_interval_ms: int = 0
    # Murmur3 seed for passthrough-mode bloom index derivation; must match
    # CudaConfig.hash_seed when filters cross tiers via durability flushes.
    hash_seed: int = 0
    timeout_ms: int = 3000  # BaseConfig.timeout
    retry_attempts: int = 3  # BaseConfig.retryAttempts
    retry_interval_ms: int = 1000  # BaseConfig.retryInterval
    password: Optional[str] = None
    database: int = 0
    # Connection pool (connection/pool/ConnectionPool.java semantics):
    connection_pool_size: int = 4  # masterConnectionPoolSize
    connection_minimum_idle_size: int = 1  # masterConnectionMinimumIdleSize
    failed_attempts: int = 3  # freeze threshold (ConnectionPool.java:184-186)
    reconnection_timeout_ms: int = 3000  # re-probe period (:297-386)
    idle_connection_timeout_ms: int = 10000  # reaper (IdleConnectionWatcher)


@dataclass
class PersistConfig:
    """Durability subsystem (`persist/`): write-ahead op journal, snapshots
    and crash recovery (mirrors `redisson_tpu.config.PersistConfig`)."""

    # Journal + snapshot directory ("" disables persistence even when the
    # section is present).
    dir: str = ""
    # appendfsync analogue: "always" (group-committed write-ahead fsync,
    # durability lag bounded by the in-flight window), "everysec"
    # (background fsync every fsync_interval_s), "off" (OS-paced).
    fsync: str = "everysec"
    fsync_interval_s: float = 1.0
    # Group-commit size for fsync="always"; 0 = follow Config.inflight_runs
    # (one fsync per in-flight window). 1 = strict fsync-per-run.
    group_commit_runs: int = 0
    segment_max_bytes: int = 64 << 20
    # Background snapshot cadence (0 = on demand via
    # client.persist.snapshot() only). Each snapshot truncates wholly
    # covered journal segments.
    snapshot_interval_s: float = 0.0
    snapshot_keep: int = 2
    # Replay snapshot + journal suffix at client create when the directory
    # holds prior state (also the way back from a lost CUDA context: a new
    # process on the same directory).
    auto_recover: bool = True


@dataclass
class FaultConfig:
    """Fault subsystem (`fault/`): classification is always on; this
    section controls injection, the run watchdog and the self-healing
    rebuild (mirrors `redisson_tpu.config.FaultConfig`)."""

    # Declarative injection schedule: FaultRule dicts ({"seam", "fault",
    # "nth", "times", "kind", "target"}); empty = no injection.
    plan: List[Dict[str, Any]] = field(default_factory=list)
    seed: int = 0  # documents how a random plan was generated
    # Run watchdog over the executor's in-flight window: deadlines of
    # margin x the serving layer's cost-model estimate (the floor without
    # a serving layer).
    watchdog: bool = False
    watchdog_margin: float = 8.0
    watchdog_floor_s: float = 2.0
    watchdog_poll_s: float = 0.05
    # Self-healing rebuild on StateUncertain/DeviceLost retirement; needs
    # Config.persist for host truth, else faulted targets degrade.
    rebuild: bool = True


@dataclass
class ServeConfig:
    """QoS serving layer (`serve/`) in front of the executor (mirrors
    `redisson_tpu.config.ServeConfig`): Redisson's `retryAttempts`,
    `retryInterval` and `timeout`, plus admission and batching knobs."""

    # -- admission ----------------------------------------------------------
    # Per-tenant token-bucket rate in keys/sec (0 = unlimited); a tenant is
    # whatever string the caller passes ("" = the default tenant).
    default_tenant_rate: float = 0.0
    default_tenant_burst: float = 0.0  # 0 = one second's worth of rate
    tenant_rates: Dict[str, float] = field(default_factory=dict)
    tenant_bursts: Dict[str, float] = field(default_factory=dict)
    # Bounded global queue: shed on depth, or once the cost model's
    # estimated queueing delay passes the budget (0 = depth only).
    max_queue_ops: int = 10000
    max_queue_delay_s: float = 0.0
    # -- adaptive batching --------------------------------------------------
    max_linger_s: float = 0.002  # hold a batch open at most this long
    target_batch_service_s: float = 0.005  # size batches to this service time
    min_batch_keys: int = 4096
    # -- deadlines / retry / breaker ----------------------------------------
    default_timeout_ms: int = 3000  # 0 = no deadline
    retry_attempts: int = 3  # retries, not tries
    retry_interval_ms: int = 50  # base backoff
    breaker_failure_threshold: int = 5
    breaker_reset_timeout_ms: int = 1000
    breaker_half_open_probes: int = 1


@dataclass
class TraceConfig:
    """Trace subsystem (`trace/`): sampled per-op spans, latency
    histograms, SLOWLOG / MONITOR / LATENCY surfaces and Chrome-trace
    export (mirrors `redisson_tpu.config.TraceConfig`)."""

    # Sample 1 op in `sample_every` (counter stride seeded by `seed`).
    sample_every: int = 128
    seed: int = 0
    ring: int = 4096  # finished spans kept for chrome_trace()
    slowlog_threshold_ms: float = 10.0
    slowlog_max_len: int = 128
    monitor_queue: int = 1024  # per-subscriber MONITOR queue bound
    latency_threshold_ms: float = 100.0  # LATENCY HISTORY spike threshold
    latency_history_len: int = 160


@dataclass
class MemConfig:
    """Memory watermarks and pressure behaviour (`memstat/`; mirrors
    `redisson_tpu.config.MemConfig`). The byte ledger is always on; this
    section configures the pressure gate. high_watermark_bytes == 0
    disables shedding."""

    high_watermark_bytes: int = 0  # shed growing writes at/above this total
    # Hysteresis: once shedding, resume only below this (0 = the high mark).
    low_watermark_bytes: int = 0
    include_overhead: bool = True  # count cache/scratch/staging meters
    ewma_halflife_s: float = 30.0  # growth-rate EWMA for the forecast
    retry_after_s: float = 1.0  # hint on shed RejectedErrors
    meter_refresh_s: float = 0.05  # meter sampling throttle on admission
    doctor_watermark_ratio: float = 0.9  # MEMORY DOCTOR near-watermark rule


@dataclass
class ReplicaConfig:
    """Read-replica fleet (`replica/`): N serving replicas, each a full
    engine stack tailing the primary's journal, fronted by a ReplicaRouter
    that sends read-only op kinds to a replica whose applied watermark
    satisfies the read's staleness bound — the engine-owned analogue of
    `readMode=SLAVE` in `MasterSlaveConnectionManager.java` (mirrors
    `redisson_tpu.config.ReplicaConfig`). Requires `Config.persist` with a
    dir (replicas tail that journal). Replicas run on the primary's device."""

    num_replicas: int = 2
    # Bounded-staleness defaults; per-read `max_lag=`/`max_lag_s=` override.
    # A replica is eligible when primary_seq - applied_seq <= max_lag_seqs
    # AND (max_lag_s == 0 or time since it was last caught up <= max_lag_s).
    max_lag_seqs: int = 1024
    max_lag_s: float = 0.0
    # Pin a tenant's reads at/above the highest journal seq acked to it.
    read_your_writes: bool = True
    # Follower tail cadence / apply batch (JournalFollower knobs).
    poll_interval_s: float = 0.01
    apply_window: int = 1024
    # Failover: promote the highest-watermark replica when the primary
    # dies (DeviceLostFault through the fault manager, or health_failures
    # consecutive failed probes at health_interval_s cadence).
    auto_failover: bool = True
    health_interval_s: float = 0.25
    health_failures: int = 3
    promote_timeout_s: float = 30.0


@dataclass
class ClusterConfig:
    """Slot-sharded namespace (`cluster/`): N full engine stacks each owning
    contiguous ranges of the 16384 CRC16 slots, fronted by a ClusterRouter
    that splits batches per owner and handles MOVED/ASK redirects — the
    engine-owned analogue of ClusterServersConfig /
    `ClusterConnectionManager.java` (mirrors `redisson_tpu.config.
    ClusterConfig`). Each shard runs the Config's `cuda` section: the card
    by default (shards round-robin over the visible cards, all on `cuda:0`
    with one), the CPU only with `device="cpu"`. Live slot migration
    (`client.cluster.migrate_slots`) requires `dir` so each shard journals."""

    num_shards: int = 4
    # Root persist directory; each shard journals under <dir>/shard-NN.
    # "" = no per-shard persistence (migration unavailable).
    dir: str = ""
    fsync: str = "off"
    # Per-shard admission control: front every shard with a ServingLayer
    # built from Config.serve (which must then be present).
    shard_serve: bool = False
    # MOVED redirect retry depth before an op's future fails.
    redirect_retries: int = 5
    # Shard-level HA: each shard gets its own replica fleet tailing the
    # shard journal (requires `dir`); tuning knobs inherit from
    # Config.replicas when that section is set on the facade config.
    replicas_per_shard: int = 0
    # Quarantine-then-migrate on topology node_down events (parallel/
    # topology.py watcher): drain the lost shard's slots onto survivors.
    auto_heal: bool = True
    # Shard data plane: "stacks" (N full engine stacks) or "mesh" (N logical
    # shards over one engine whose bank is sharded over a logical mesh of
    # N entries on the card, cluster/shard.py MeshShard).
    data_plane: str = "stacks"
    # INTERNAL: >= 0 marks a config built by the ClusterManager for one
    # shard member (installs the slot-ownership guard); users leave it -1.
    shard_id: int = -1


@dataclass
class WireConfig:
    """RESP2/RESP3 network front-end (`wire/`): a TCP server real redis
    clients (redis-cli, redis-py, Redisson) connect to; pipelined commands
    from all connections coalesce into `execute_many` windows. In cluster
    mode one server fronts every shard (base `port` + i, or all-ephemeral
    when port=0) and keyed commands answer real -MOVED/-ASK redirects
    during live slot migration (mirrors `redisson_tpu.config.WireConfig`)."""

    host: str = "127.0.0.1"
    # 0 = bind an ephemeral port (read it back from client.wire.port).
    port: int = 0
    # Require AUTH/HELLO AUTH before any other command (None = open).
    password: Optional[str] = None
    # Accept-time shed bound: further connections get -BUSY + close
    # (0 = unlimited).
    max_connections: int = 1024
    # Per-connection pipelined command cap: commands past this many
    # unanswered get -BUSY in their reply position (RejectedError shape).
    max_inflight_per_conn: int = 128
    # Listen backlog handed to the OS.
    backlog: int = 128
    # retry-after hint rendered into wire -BUSY sheds.
    shed_retry_after_s: float = 0.05


@dataclass
class GeoConfig:
    """Active-active geo-replication (geo/): this site is one of N
    independent engine stacks that each accept local writes and converge
    asynchronously. The persist journal is the transport: a SiteLink per
    peer tails it, folds the sketch-tier writes into stamped delta planes
    and ships them; the peer applies them as `geo_*` kinds through the
    fused delta_merge path. Requires `Config.persist` with a dir."""

    # Unique site name in the fleet ("" = the persist dir's parent name).
    # Stamps are (origin_seq, site_id); ties break on the id string.
    site_id: str = ""
    # Link tail cadence and the most journal records folded per poll.
    poll_interval_s: float = 0.01
    batch_records: int = 4096
    # Cadence of the LWW sidecar flush (geo_state.json).
    anti_entropy_interval_s: float = 0.5
    # Bound on unresolved remote-apply futures tracked per applier.
    apply_window: int = 4096


def _apply(section, overrides: dict):
    names = {f.name for f in fields(section)}
    for key, value in overrides.items():
        if key not in names:
            raise TypeError(f"{type(section).__name__} has no field {key!r}")
        setattr(section, key, value)
    return section


@dataclass
class Config:
    cuda: Optional[CudaConfig] = None
    codec: str = "json"  # default value codec
    # How many coalesced runs may be in flight at once (staged and
    # dispatched, futures unresolved); per-target order holds at any depth.
    inflight_runs: int = 2
    persist: Optional[PersistConfig] = None
    faults: Optional[FaultConfig] = None
    serve: Optional[ServeConfig] = None
    trace: Optional[TraceConfig] = None
    memory: Optional[MemConfig] = None
    replicas: Optional[ReplicaConfig] = None
    # Slot-sharded cluster tier (None = one engine owns all slots).
    cluster: Optional[ClusterConfig] = None
    # RESP wire front-end (None = facade-only access, no TCP listener).
    wire: Optional[WireConfig] = None
    # Active-active geo-replication (None = this engine is not a site).
    geo: Optional[GeoConfig] = None
    # RESP server the durability tier flushes to (None = no redis tier).
    redis: Optional[RedisConfig] = None
    # Durability: flush sketch state to redis every N seconds (0 = off).
    flush_interval_s: float = 0.0
    # The pod tier (None = not a pod): exclusive with `cuda`.
    pod: Optional[PodConfig] = None

    _MODES = ("cuda", "pod", "redis")

    def mode(self) -> str:
        """The active backend mode, validated like JAX's `mode()`: one
        compute section ("cuda" or "pod"), with redis beside it as the
        durability tier; redis alone is the passthrough mode ("redis");
        nothing is the default device engine ("cuda")."""
        active = [m for m in self._MODES if getattr(self, m) is not None]
        compute = [m for m in active if m != "redis"]
        if len(compute) > 1:
            raise ValueError(f"multiple backend modes configured: {active}")
        if compute:
            return compute[0]
        if not active:
            return "cuda"
        return active[0]

    def use_cuda(self, **overrides) -> CudaConfig:
        self.cuda = _apply(self.cuda or CudaConfig(), overrides)
        check_ingest(self.cuda.ingest)
        return self.cuda

    def use_pod(self, **overrides) -> PodConfig:
        """The pod section (JAX's `use_pod()`; keyword overrides as the
        other builders take them)."""
        self.pod = _apply(self.pod or PodConfig(), overrides)
        check_ingest(self.pod.ingest)
        return self.pod

    def use_redis(self) -> RedisConfig:
        """The redis section (JAX's `use_redis()`): the durability tier's
        flush target beside `use_cuda`, `address` and the topology fields
        set on the returned section."""
        self.redis = self.redis or RedisConfig()
        return self.redis

    def use_persist(self, dir: str = "", **overrides) -> PersistConfig:
        """The durability section: journal and snapshots under `dir`."""
        self.persist = self.persist or PersistConfig()
        if dir:
            self.persist.dir = dir
        _apply(self.persist, overrides)
        if self.persist.fsync not in ("always", "everysec", "off"):
            raise ValueError(f"unknown fsync policy {self.persist.fsync!r}")
        return self.persist

    def use_faults(self, **overrides) -> FaultConfig:
        """The fault section: injection plan, watchdog, rebuild."""
        self.faults = _apply(self.faults or FaultConfig(), overrides)
        return self.faults

    def use_serve(self, **overrides) -> ServeConfig:
        """The serving section: admission, batching, deadlines, retries,
        breakers."""
        self.serve = _apply(self.serve or ServeConfig(), overrides)
        return self.serve

    def use_trace(self, **overrides) -> TraceConfig:
        """The trace section: sampling stride, slowlog, latency events."""
        self.trace = _apply(self.trace or TraceConfig(), overrides)
        return self.trace

    def use_memstat(self, **overrides) -> MemConfig:
        """The memory section: the pressure gate's watermarks."""
        self.memory = _apply(self.memory or MemConfig(), overrides)
        return self.memory

    def use_replicas(self, num_replicas: int = 0, **overrides) -> ReplicaConfig:
        """The read-replica section: fleet size, staleness bounds,
        failover (JAX's `use_replicas(num_replicas)`; keyword overrides as
        the other builders take them)."""
        self.replicas = self.replicas or ReplicaConfig()
        if num_replicas:
            self.replicas.num_replicas = num_replicas
        return _apply(self.replicas, overrides)

    def use_cluster(self, num_shards: int = 0, dir: str = "",
                    replicas_per_shard: int = 0, data_plane: str = "",
                    **overrides) -> ClusterConfig:
        """The cluster section: shard count, the shards' persist root,
        per-shard replica fleets (JAX's `use_cluster`; keyword overrides as
        the other builders take them)."""
        self.cluster = self.cluster or ClusterConfig()
        if num_shards:
            self.cluster.num_shards = num_shards
        if dir:
            self.cluster.dir = dir
        if replicas_per_shard:
            self.cluster.replicas_per_shard = replicas_per_shard
        if data_plane:
            if data_plane not in ("stacks", "mesh"):
                raise ValueError(
                    f"cluster.data_plane must be 'stacks' or 'mesh', "
                    f"got {data_plane!r}")
            self.cluster.data_plane = data_plane
        return _apply(self.cluster, overrides)

    def use_wire(self, host: str = "", port: int = -1,
                 **overrides) -> WireConfig:
        """The RESP wire section: listen address (port 0 = ephemeral)."""
        self.wire = self.wire or WireConfig()
        if host:
            self.wire.host = host
        if port >= 0:
            self.wire.port = port
        return _apply(self.wire, overrides)

    def use_geo(self, site_id: str = "", **overrides) -> GeoConfig:
        """The geo section: this engine becomes one site of an
        active-active mesh (needs `use_persist`: the journal is the
        transport). Peering is wired at run time with
        `geo.connect_sites([...])`."""
        self.geo = self.geo or GeoConfig()
        if site_id:
            self.geo.site_id = site_id
        return _apply(self.geo, overrides)

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        kwargs: Dict[str, Any] = {}
        for key, value in d.items():
            sec = SECTION_TYPES.get(key)
            if sec is not None:
                value = dict(value)
                if "key_width_buckets" in value:
                    value["key_width_buckets"] = tuple(value["key_width_buckets"])
                kwargs[key] = sec(**value)
            else:
                kwargs[key] = value
        return cls(**kwargs)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls.from_dict(json.loads(text))


#: Config attribute -> section type (the dict round trip's schema)
SECTION_TYPES = {"cuda": CudaConfig, "pod": PodConfig,
                 "persist": PersistConfig,
                 "faults": FaultConfig, "serve": ServeConfig,
                 "trace": TraceConfig, "memory": MemConfig,
                 "replicas": ReplicaConfig, "cluster": ClusterConfig,
                 "wire": WireConfig, "geo": GeoConfig,
                 "redis": RedisConfig}
