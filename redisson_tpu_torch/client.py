"""The client facade (counterpart of `redisson_tpu.client.RedissonTPU`).

`RedissonTorch.create(config)` resolves the device (a CUDA card by default;
`device="cpu"` only when asked), builds the sketch backend and the structure
engine, the tier router and the executor waist around them, and hands out
objects bound to it: the sketches (HyperLogLog, BitSet, Bloom) on the device
and every structure object (buckets, maps, caches, sets, lists, queues,
sorted sets, multimaps, geo, topics, locks, semaphores, latches, scripts,
keys) on the in-process engine, plus `create_batch()`.

`Config.use_persist(dir)` turns on the write-ahead journal, snapshots and
crash recovery (`client.persist`, `snapshot_now`), `Config.use_faults()`
the fault injection, run watchdog and self-healing rebuild
(`client.fault`); `save_checkpoint` / `load_checkpoint` work either way.
`Config.use_serve()` puts the serving layer (`client.serve`: admission,
deadlines, retries, breakers) in front of the executor for every object
getter, `Config.use_trace()` the sampled tracer (`client.trace`: SLOWLOG,
LATENCY, commandstats, Chrome trace). The metrics registry
(`client.metrics`) and the byte ledger (`client.memstat`, `memory_usage` /
`memory_stats` / `memory_doctor` / `memory_verify`, `info`) are always on;
`Config.use_memstat()` sets its watermarks. `get_nodes_group()` pings the
client's device. `Config.use_replicas()` (with `use_persist`) starts a
read-replica fleet on the same device (`client.replicas`,
`wait_for_replicas`): each replica tails the journal through its own
engine, and the object getters bind to the ReplicaRouter, which sends
reads to a replica inside the staleness bound and writes to the primary.
`get_remote_service()` and `get_cache_manager()` are the services tier
(`services/`); `reactive.create_reactive()` is the asyncio client.
`get_topology_manager()` is the failure-detection poller over the client's
nodes.

`Config.use_geo(site_id)` (with `use_persist`) makes this engine one site
of an active-active mesh (`client.geo`, the GeoManager; peer sites with
`geo.connect_sites([...])`): its journal ships to the peers as stamped
delta planes, and theirs arrive through the delta_merge window.

`Config.use_redis()` beside the `cuda` section is the redis durability tier
(`client.durability`, the DurabilityManager; `flush_to_redis()`): the
card's HLL bank rows, Bloom filters and BitSets flush to a RESP server
(one endpoint, master/slave, sentinel or cluster) as blobs a real server
reads natively, every `Config.flush_interval_s` seconds when that is set,
and load back with `durability.load_hll` / `load_bloom` / `load_bitset`.
A config whose only section is redis is the passthrough mode: every op runs
on the RESP server (`interop/backend_redis.RedisBackend`), coordination
objects (locks, semaphores, latches, topics, map caches, scripts) run as
server-side Lua with pub/sub wake-ups (`interop/coordination_redis`), and
the client holds no device state.

`Config.use_pod()` is the pod tier (`parallel/backend_pod.PodBackend`): the
HLL bank, BitSets and Bloom filters sharded over a logical mesh of
`num_shards` entries on the card (the CPU with `device="cpu"`);
`client._pod_backend()` is the PodBackend, whose `reshard(n)` moves every
sharded array onto a mesh of n entries.

`Config.use_cluster()` makes this client a cluster FACADE: it builds N shard
clients (each a full engine stack behind a slot-ownership guard; on one card
all on `cuda:0`) and binds every object getter to the ClusterRouter
(`client.cluster` is the ClusterManager: `migrate_slots`, `add_shard`,
`rebalance`, `cluster_info`; `cluster_keyslot` / `cluster_slots` /
`cluster_info` here); `data_plane="mesh"` runs the shards as logical
shards of one engine whose bank is row-sharded over a mesh
(`client.cluster.mesh_client`). `Config.use_wire()` starts the RESP front-end last,
after the whole stack: one server, or one per shard behind a cluster facade
(`client.wire`).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Union

import numpy as np

from redisson_tpu_torch import checkpoint
from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch.backend_torch import TorchBackend
from redisson_tpu_torch.codecs import get_codec
from redisson_tpu_torch.config import Config, CudaConfig
from redisson_tpu_torch.eviction import EvictionScheduler
from redisson_tpu_torch.executor import CommandExecutor
from redisson_tpu_torch.models.batch import RBatch
from redisson_tpu_torch.models.bitset import RBitSet
from redisson_tpu_torch.models.bloomfilter import RBloomFilter
from redisson_tpu_torch.models.bucket import (RAtomicDouble, RAtomicLong,
                                              RBucket, RBuckets)
from redisson_tpu_torch.models.collections import RList, RSet
from redisson_tpu_torch.models.geo import RGeo
from redisson_tpu_torch.models.hyperloglog import RHyperLogLog
from redisson_tpu_torch.models.keys import RKeys
from redisson_tpu_torch.models.lock import (LockWatchdog, RCountDownLatch,
                                            RFairLock, RLock, RMultiLock,
                                            RReadWriteLock, RSemaphore,
                                            new_client_id)
from redisson_tpu_torch.models.map import RMap
from redisson_tpu_torch.models.mapcache import RMapCache, RSetCache
from redisson_tpu_torch.models.multimap import (RListMultimap,
                                                RListMultimapCache,
                                                RSetMultimap,
                                                RSetMultimapCache)
from redisson_tpu_torch.models.queue import (RBlockingDeque, RBlockingQueue,
                                             RDeque, RQueue)
from redisson_tpu_torch.models.scoredsortedset import (RLexSortedSet,
                                                       RScoredSortedSet)
from redisson_tpu_torch.models.script import RScript
from redisson_tpu_torch.models.sortedset import RSortedSet
from redisson_tpu_torch.models.topic import RPatternTopic, RTopic
from redisson_tpu_torch.memstat import MemLedger, MemoryReport, PressureMonitor
from redisson_tpu_torch.memstat.pressure import device_memory
from redisson_tpu_torch.observability import (ExecutorMetrics, MetricsRegistry,
                                              NodesGroup, register_delta_ingest,
                                              register_geo, register_memstat,
                                              register_read_cache,
                                              register_replica,
                                              register_trace)
from redisson_tpu_torch.routing import RoutingBackend
from redisson_tpu_torch.store import SketchStore


class RedissonTorch:
    """The RedissonClient analogue on one CUDA device."""

    def __init__(self, config: Union[Config, CudaConfig, None] = None):
        from redisson_tpu_torch.config import PodConfig

        if isinstance(config, PodConfig):
            pod, config = config, Config()
            config.pod = pod
        elif isinstance(config, CudaConfig):
            config = Config(cuda=config)
        self.config = config or Config()
        mode = self.config.mode()
        ccfg = (self.config.pod if mode == "pod"
                else self.config.cuda or CudaConfig())
        self._codec = get_codec(self.config.codec)
        self.id = new_client_id()
        self._widths = tuple(ccfg.key_width_buckets)
        # The ClusterManager on a cluster facade, None everywhere else
        # (shard members included); the RESP front-end when Config.wire.
        self.cluster = None
        self.wire = None
        # The GeoManager when Config.geo makes this engine a site (_init_geo).
        self._geo = None
        # The redis durability tier (_connect_durability): the manager, the
        # pool or router it writes through, and the router's watchers.
        self._durability = None
        self._resp = None
        self._role_monitor = None
        self._cluster_manager = None
        # The passthrough mode's coordination plumbing (_init_redis_mode).
        self._passthrough = False
        self._redis_pubsub = None
        self._redis_watchdog = None
        self._is_shutdown = False
        self._is_shutting_down = False
        clcfg = self.config.cluster
        if clcfg is not None and clcfg.shard_id == -1:
            # Slot-sharded namespace: this client is the FACADE. It builds
            # N shard clients (each re-enters __init__ with shard_id >= 0)
            # and dispatches through the ClusterRouter; the `cuda` section
            # configures the shards, not this client.
            self._init_cluster_mode()
            self._start_wire()
            return
        if mode == "redis":
            # Passthrough: every op translates to Redis commands over RESP,
            # the reference's own execution model (the server executes, the
            # client holds no state).
            self._init_redis_mode()
            self._start_wire()
            return
        if mode == "pod":
            if ccfg.hll_hash == "redis":
                raise NotImplementedError(
                    "hll_hash='redis' is a single-device mode feature; the "
                    "pod bank inserts implement the murmur3 family")
            from redisson_tpu_torch.parallel.backend_pod import PodBackend

            self.sketch = PodBackend(ccfg)
            self.device = self.sketch.device
            self._store = self.sketch.store
        else:
            self.device = device_mod.resolve(ccfg.device)
            self._store = SketchStore(self.device)
            self.sketch = TorchBackend(
                self._store, hll_impl=ccfg.hll_impl, seed=ccfg.hash_seed,
                ingest=ccfg.ingest, hll_hash=ccfg.hll_hash,
                read_cache_entries=ccfg.read_cache_entries)
        self._routing = RoutingBackend(self.sketch)
        if clcfg is not None and clcfg.shard_id >= 0:
            # Shard member of a cluster: slot ownership is enforced at the
            # dispatch waist, installed before the executor and before
            # persist recovery, so replayed journal records cross the same
            # accept / reject line live traffic did.
            from redisson_tpu_torch.cluster.shard import SlotOwnershipBackend

            self._routing = SlotOwnershipBackend(self._routing, clcfg.shard_id)
        elif clcfg is not None and clcfg.shard_id == -2:
            # Mesh data plane: this client is the ONE engine stack behind
            # every logical shard. The guard holds the whole slot -> shard
            # table, and the bank goes onto a logical mesh of num_shards
            # entries BEFORE any bank-touching op (persist recovery
            # included), so every row the engine makes is mesh-sharded.
            from redisson_tpu_torch.cluster.shard import MeshOwnershipBackend
            from redisson_tpu_torch.parallel.mesh import SLOT_AXIS, get_mesh

            guard = MeshOwnershipBackend(self._routing, clcfg.num_shards)
            self._routing = guard
            self.sketch.attach_mesh(
                get_mesh(clcfg.num_shards, axis=SLOT_AXIS, device=ccfg.device),
                clcfg.num_shards, guard.shard_of_key)
        # JAX's name for the dispatch waist's backend (tests read it).
        self._backend = self._routing
        self.metrics = MetricsRegistry()
        # The byte ledger is always on and wired before any traffic (a
        # persist recovery replays through the same seams).
        self.memstat = MemLedger()
        self._store.accounting = self.memstat
        self.sketch.accounting = self.memstat
        self.sketch._account_bank()
        self.memstat.register_meter(
            "backend.bloom_mirrors",
            lambda: self.sketch.scratch_bytes()["bloom_mirrors"], "scratch")
        self.memstat.register_meter(
            "backend.delta_scratch",
            lambda: self.sketch.scratch_bytes()["delta_scratch"], "scratch")
        self._build_executor(ccfg.max_batch_keys)
        self.memstat.register_meter(
            "executor.staging", self._executor.staging_bytes, "staging")
        mcfg = self.config.memory
        self._pressure = None
        if mcfg is not None and mcfg.high_watermark_bytes > 0:
            self._pressure = PressureMonitor(
                self.memstat, mcfg,
                device_fn=lambda: self._device_memory(mcfg.high_watermark_bytes))
        self._memreport = MemoryReport(self.memstat, store=self._store,
                                       backend=self.sketch,
                                       pressure=self._pressure)
        register_memstat(self.metrics, self.memstat, self._pressure)
        if self.serve is not None:
            self.serve.attach_memstat(self.memstat, self._pressure)
        if self.trace is not None:
            self.trace.attach_memstat(self.memstat)
        register_read_cache(self.metrics, self.sketch.read_cache)
        self.memstat.register_meter(
            "backend.read_cache", self.sketch.read_cache.content_bytes,
            "cache")
        register_delta_ingest(self.metrics, self.sketch)
        self._pubsub = self._routing.pubsub
        self._watchdog = LockWatchdog(self._executor)
        self._eviction = EvictionScheduler(self._executor)
        self._persist = None
        self._fault = None
        self._replicas = None
        self._remote_services = {}
        # Durability first (recovery replays before any user traffic and
        # before the journal attaches), then faults (the rebuild path needs
        # the recovered journal); a failure unwinds the whole client.
        pcfg = self.config.persist
        if pcfg is not None and pcfg.dir:
            from redisson_tpu_torch.persist import PersistenceManager

            self._persist = PersistenceManager(self, pcfg)
            try:
                self._persist.start()
            except Exception:
                self.shutdown()
                raise
            journal = self._executor.journal
            if journal is not None:
                if self.trace is not None:
                    # Every fsync's duration, sampled op or not.
                    journal.set_trace(self.trace)
                self.memstat.register_meter(
                    "persist.journal", journal.disk_bytes, "disk")
            if self._persist.snapshotter is not None:
                self.memstat.register_meter(
                    "persist.snapshots", self._persist.snapshotter.disk_bytes,
                    "disk")
        fcfg = self.config.faults
        if fcfg is not None:
            from redisson_tpu_torch.fault import FaultManager

            self._fault = FaultManager(self, fcfg)
            try:
                self._fault.start()
            except Exception:
                self.shutdown()
                raise
        # Read-replica fleet (replica/): N serving replicas tailing the
        # journal (persist IS the replication stream) + bounded-staleness
        # read routing + failover. Wired after fault so the DeviceLost
        # trigger can chain onto the fault listener fan-out.
        repcfg = self.config.replicas
        if repcfg is not None:
            if self._persist is None:
                self.shutdown()
                raise ValueError(
                    "Config.replicas requires Config.persist with a dir — "
                    "replicas tail that journal as the replication stream")
            from redisson_tpu_torch.replica import ReplicaManager

            self._replicas = ReplicaManager(self, repcfg)
            try:
                self._replicas.start()
            except Exception:
                self.shutdown()
                raise
            # Model getters bind to _dispatch when called, so every object
            # created from here on routes reads through the fleet.
            self._dispatch = self._replicas.router
            register_replica(self.metrics, self._replicas)
        self._init_geo()
        if self.config.redis is not None:
            try:
                self._connect_durability()
            except Exception:
                # A failed first dial must not leak the background threads
                # already running.
                self.shutdown()
                raise
        # The RESP front-end last, so the first socket read finds the whole
        # stack (serve admission, persist, replicas) standing.
        self._start_wire()

    def _init_geo(self) -> None:
        """Geo-replication site (geo/): this engine becomes one active site
        of a cross-site mesh whose journal ships to peers as stamped delta
        planes. Wired after the replicas (both tail the same journal);
        peering happens at run time through `geo.connect_sites([...])`."""
        gcfg = self.config.geo
        if gcfg is None:
            return
        if self._persist is None:
            self.shutdown()
            raise ValueError(
                "Config.geo requires Config.persist with a dir — the "
                "persist journal is the geo replication transport")
        from redisson_tpu_torch.geo import GeoManager

        self._geo = GeoManager(self, gcfg)
        try:
            self._geo.start()
        except Exception:
            self.shutdown()
            raise
        register_geo(self.metrics, self._geo)

    def _make_resp_pool(self):
        """Connection pool to the configured redis endpoint, which the
        durability flushes write through (ConnectionPool.java role). With
        cluster_addresses, a ClusterRouter over a bootstrapped
        ClusterTopologyManager; with sentinel_addresses, a SentinelManager;
        with slave_addresses, a MasterSlaveRouter (write-to-master,
        balanced reads, freeze-driven promotion, MOVED/ASK redirects) over
        one pool per endpoint, plus a RolePollingMonitor when
        role_scan_interval_ms is set (JAX's `_make_resp_pool`)."""
        from urllib.parse import urlparse

        from redisson_tpu_torch.interop.pool import RespConnectionPool

        rcfg = self.config.redis

        def factory(host: str, port: int) -> RespConnectionPool:
            return RespConnectionPool(
                host=host or "127.0.0.1",
                port=port or 6379,
                password=rcfg.password,
                db=rcfg.database,
                timeout=rcfg.timeout_ms / 1000.0,
                retry_attempts=rcfg.retry_attempts,
                retry_interval=rcfg.retry_interval_ms / 1000.0,
                size=rcfg.connection_pool_size,
                min_idle=rcfg.connection_minimum_idle_size,
                failed_attempts=rcfg.failed_attempts,
                reconnection_timeout=rcfg.reconnection_timeout_ms / 1000.0,
                idle_timeout=rcfg.idle_connection_timeout_ms / 1000.0,
            )

        u = urlparse(rcfg.address)
        if rcfg.cluster_addresses:
            from redisson_tpu_torch.interop.topology_redis import (
                ClusterRouter, ClusterTopologyManager)

            router = ClusterRouter(factory, rcfg.cluster_addresses)
            mgr = ClusterTopologyManager(
                router,
                scan_interval_s=rcfg.cluster_scan_interval_ms / 1000.0)
            try:
                mgr.bootstrap()
            except Exception:
                # bootstrap dialed pools through the router; nobody above
                # holds a reference yet, so reclaim them (and the scan
                # thread) here or they leak per failed create().
                mgr.close()
                router.close()
                raise
            self._cluster_manager = mgr
            return router
        from redisson_tpu_torch.interop.topology_redis import make_balancer

        balancer = make_balancer(rcfg.load_balancer, rcfg.slave_weights,
                                 rcfg.default_slave_weight)
        if rcfg.sentinel_addresses:
            from redisson_tpu_torch.interop.resp_client import SyncPubSubClient
            from redisson_tpu_torch.interop.topology_redis import SentinelManager

            def pubsub_factory(host: str, port: int) -> SyncPubSubClient:
                return SyncPubSubClient(
                    host=host, port=port, password=rcfg.password,
                    timeout=rcfg.timeout_ms / 1000.0)

            return SentinelManager(
                factory, rcfg.sentinel_addresses, rcfg.master_name,
                read_mode=rcfg.read_mode, pubsub_factory=pubsub_factory,
                timeout=rcfg.timeout_ms / 1000.0,
                sentinel_password=rcfg.password, balancer=balancer)
        if rcfg.slave_addresses:
            from redisson_tpu_torch.interop.topology_redis import (
                MasterSlaveRouter, RolePollingMonitor)

            router = MasterSlaveRouter(
                factory,
                f"{u.hostname or '127.0.0.1'}:{u.port or 6379}",
                rcfg.slave_addresses,
                read_mode=rcfg.read_mode, balancer=balancer)
            if rcfg.role_scan_interval_ms > 0:
                self._role_monitor = RolePollingMonitor(
                    router,
                    scan_interval_s=rcfg.role_scan_interval_ms / 1000.0)
            return router
        return factory(u.hostname, u.port)

    def _connect_durability(self) -> None:
        """The redis durability tier: dial the pool, wire the manager to the
        store, the executor and the bank-owning backend (HLL rows flush and
        load through dispatcher-serialized hll_export / hll_import), and
        start the periodic flusher when flush_interval_s > 0."""
        from redisson_tpu_torch.interop.durability import DurabilityManager

        self._resp = self._make_resp_pool()
        self._resp.connect()
        pod = self._pod_backend()
        self._durability = DurabilityManager(
            self._store, self._resp, executor=self._executor,
            pod_backend=pod, hll_family=getattr(pod, "family", "m3"))
        if self.config.flush_interval_s > 0:
            self._durability.start_periodic(self.config.flush_interval_s)

    def _device_memory(self, capacity: int) -> dict:
        """{device name: `device_memory`} for every device the client's
        state lives on, its own device first: each distinct card of the
        engine's mesh (a pod's blocks, read anew after a reshard), else
        the client's device."""
        mesh = getattr(self.sketch, "mesh", None)
        devices = mesh.devices if mesh is not None else (self.device,)
        return {str(d): device_memory(d, capacity) for d in dict.fromkeys(devices)}

    def _pod_backend(self):
        """The backend that owns the HLL bank (`bank_names`, `row_version`,
        `family`): the durability tier's view of it, the PodBackend in pod
        mode (with `reshard` and the sharded bit objects); None on a
        cluster facade and in the passthrough mode."""
        return self.sketch

    def _init_redis_mode(self) -> None:
        """The passthrough mode (JAX's `_init_redis_mode`): the pool (or
        topology router) to the configured server, the RedisBackend behind
        the executor waist, and no device, store, memory ledger or engine
        pub/sub: coordination objects run as server-side Lua with pub/sub
        wake-ups over a lazily dialed subscribe connection."""
        from redisson_tpu_torch.interop.backend_redis import RedisBackend
        from redisson_tpu_torch.interop.coordination_redis import ScriptRunner

        if self.config.persist is not None and self.config.persist.dir:
            raise NotImplementedError(
                "persist/ journals an engine-owned state tier; in redis "
                "passthrough mode the server owns the state (use the "
                "server's own AOF/RDB)")
        self._passthrough = True
        self._persist = None
        self._fault = None
        self._replicas = None
        self._resp = self._make_resp_pool()
        try:
            self._resp.connect()
        except Exception:
            # Reclaim every background resource already started (the role
            # monitor would otherwise poll forever).
            if self._role_monitor is not None:
                self._role_monitor.close()
                self._role_monitor = None
            if self._cluster_manager is not None:
                self._cluster_manager.close()
                self._cluster_manager = None
            self._resp.close()  # the IO-loop thread
            raise
        self._backend = self._routing = RedisBackend(
            self._resp, hash_seed=self.config.redis.hash_seed)
        self.device = None
        self._store = None
        self.sketch = None
        self._widths = (16, 32, 64, 128, 256)
        # The server owns memory introspection (MEMORY USAGE et al.).
        self.memstat = None
        self._pressure = None
        self._memreport = None
        self.metrics = MetricsRegistry()
        self._build_executor(CudaConfig().max_batch_keys)
        # The blocking-pop silent-loss window (the reply window expires as
        # the server pops, or a mid-reply drop forces a re-drive): per
        # backend instance, so two clients never pool their counts.
        self.metrics.gauge("redis.blocking_pop_loss_windows",
                           lambda: self._routing.blocking_pop_loss_windows)
        self._pubsub = None
        self._watchdog = None
        # Redis-mode map caches register their Lua sweep here, so TTL
        # entries are removed without manual evict_expired calls.
        self._eviction = EvictionScheduler()
        self._remote_services = {}
        self._redis_scripts = ScriptRunner(self._resp)
        self._redis_coord_lock = threading.Lock()

    def _redis_coordination(self):
        """(scripts, pubsub, watchdog) of the passthrough mode's coordination
        objects; the subscribe connection and the lease-renewal thread
        start on first use."""
        from urllib.parse import urlparse

        from redisson_tpu_torch.interop.coordination_redis import (
            RedisLockWatchdog)
        from redisson_tpu_torch.interop.resp_client import SyncPubSubClient

        with self._redis_coord_lock:
            if self._redis_pubsub is None:
                rcfg = self.config.redis
                u = urlparse(rcfg.address)
                # Follow master promotion: behind a MasterSlaveRouter every
                # (re)dial asks it for the current master, so lock wake-ups
                # survive a failover.
                addr_provider = None
                if getattr(self._resp, "master_address", None) is not None:
                    def addr_provider():
                        host, _, port = self._resp.master_address.rpartition(":")
                        return host, int(port)
                pubsub = SyncPubSubClient(
                    host=u.hostname or "127.0.0.1", port=u.port or 6379,
                    password=rcfg.password, timeout=rcfg.timeout_ms / 1000.0,
                    addr_provider=addr_provider)
                try:
                    pubsub.connect()
                except Exception:
                    pubsub.close()  # reclaim the IO thread of a failed dial
                    raise
                self._redis_pubsub = pubsub
            if self._redis_watchdog is None:
                self._redis_watchdog = RedisLockWatchdog(self._redis_scripts)
            return self._redis_scripts, self._redis_pubsub, self._redis_watchdog

    def _require_pubsub(self, feature: str):
        if self._pubsub is None:
            raise NotImplementedError(
                f"{feature} needs the in-process engine's pub/sub hub, which "
                "this mode does not run")
        return self._pubsub

    def _init_cluster_mode(self) -> None:
        """The facade's own state: the ClusterManager (shard clients,
        router, migrations, topology) and the router as the dispatch every
        object getter binds to, like the JAX facade. Per-shard subsystems
        (memstat, trace, serve, persist, faults, replicas) live on the shard
        clients; pub/sub and lock coordination are per-shard hubs, so the
        facade has none."""
        from redisson_tpu_torch.cluster import ClusterManager

        self.cluster = ClusterManager(self.config)
        self._dispatch = self._routing = self.cluster.router
        self._executor = None
        shard0 = self.cluster.shards[min(self.cluster.shards)]
        self.device = shard0.client.device
        self._store = None
        self.sketch = None
        self.metrics = MetricsRegistry()
        self.metrics.gauge("cluster.queue_depth",
                           self.cluster.router.queue_depth)
        self.memstat = None
        self._pressure = None
        self._memreport = None
        self.serve = None
        self.trace = None
        self._pubsub = None
        self._watchdog = None
        self._eviction = EvictionScheduler(self.cluster.router)
        self._remote_services = {}
        self._persist = None
        self._fault = None
        self._replicas = None

    def _start_wire(self) -> None:
        """Start the RESP front-end when `Config.wire` is set: one
        WireServer, or one per shard behind a shared -MOVED / -ASK address
        table on a cluster facade. A failure unwinds the whole client."""
        wcfg = self.config.wire
        if wcfg is None:
            return
        from redisson_tpu_torch.observability import register_wire
        from redisson_tpu_torch.wire import ClusterWireFrontend, WireServer

        if self.cluster is not None:
            self.wire = ClusterWireFrontend(self, wcfg)
        else:
            self.wire = WireServer(self, wcfg)
        try:
            self.wire.start()
        except Exception:
            self.wire = None
            self.shutdown()
            raise
        register_wire(self.metrics, self.wire)

    def _build_executor(self, max_batch_keys: int) -> None:
        """The executor waist and, when `Config.serve` is set, the serving
        layer in front of it. `self._executor` is the raw waist (for
        maintenance traffic: lock watchdog renewals and eviction sweeps,
        which must never be shed or expire); `self._dispatch` is what the
        object getters bind to (the serving layer when configured)."""
        scfg = self.config.serve
        policy = None
        if scfg is not None:
            from redisson_tpu_torch.serve import AdaptiveBatchPolicy, CostModel

            policy = AdaptiveBatchPolicy(
                CostModel(), max_linger_s=scfg.max_linger_s,
                target_batch_service_s=scfg.target_batch_service_s,
                min_batch_keys=scfg.min_batch_keys)
        # The tracer is built before the executor, so every op (maintenance
        # traffic included) passes its sampling hook.
        self.trace = None
        if self.config.trace is not None:
            from redisson_tpu_torch.trace import TraceManager

            self.trace = TraceManager(self.config.trace, registry=self.metrics)
            register_trace(self.metrics, self.trace)
        self._executor = CommandExecutor(
            self._routing, max_batch_keys=max_batch_keys,
            metrics=ExecutorMetrics(self.metrics), policy=policy,
            inflight_runs=self.config.inflight_runs, trace=self.trace)
        self.metrics.gauge("executor.queue_depth", self._executor.queue_depth)
        self.metrics.gauge(
            "executor.overlap_ratio",
            lambda: self._executor.pipeline_stats()["overlap_ratio"])
        if scfg is not None:
            from redisson_tpu_torch.serve import ServingLayer

            self.serve = ServingLayer(self._executor, scfg,
                                      registry=self.metrics)
            self._dispatch = self.serve
        else:
            self.serve = None
            self._dispatch = self._executor

    @classmethod
    def create(cls, config: Union[Config, CudaConfig, None] = None) -> "RedissonTorch":
        """Build a client; accepts a Config or the CudaConfig section that
        `Config().use_cuda(...)` returns."""
        return cls(config)

    def _resolve_codec(self, codec):
        """Per-object codec: a Codec instance or a registry name; the client
        default (Config.codec) otherwise."""
        return get_codec(codec) if codec is not None else self._codec

    # -- sketch objects (the device tier) -----------------------------------

    def get_hyper_log_log(self, name: str, codec=None) -> RHyperLogLog:
        return RHyperLogLog(name, self._dispatch, self._resolve_codec(codec),
                            self._widths)

    def get_bit_set(self, name: str) -> RBitSet:
        return RBitSet(name, self._dispatch, self._codec, self._widths)

    def get_bloom_filter(self, name: str, codec=None) -> RBloomFilter:
        return RBloomFilter(name, self._dispatch, self._resolve_codec(codec),
                            self._widths)

    def create_batch(self, **submit_kwargs) -> RBatch:
        """RBatch over every object family; `submit_kwargs` (a `deadline`)
        budget the whole pipeline."""
        return RBatch(self._dispatch, self._codec, self._widths,
                      **submit_kwargs)

    # -- structure objects (the in-process engine) --------------------------

    def get_bucket(self, name: str, codec=None) -> RBucket:
        return RBucket(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_buckets(self, codec=None) -> RBuckets:
        return RBuckets(self._dispatch, self._resolve_codec(codec))

    def get_atomic_long(self, name: str) -> RAtomicLong:
        return RAtomicLong(name, self._dispatch, self._codec, self._widths)

    def get_atomic_double(self, name: str) -> RAtomicDouble:
        return RAtomicDouble(name, self._dispatch, self._codec, self._widths)

    def get_map(self, name: str, codec=None) -> RMap:
        return RMap(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_map_cache(self, name: str, codec=None) -> RMapCache:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisMapCache

            cache = RedisMapCache(name, self._redis_scripts,
                                  self._resolve_codec(codec))
            self._eviction.schedule(name, cache.evict_expired)
            return cache
        return RMapCache(name, self._dispatch, self._resolve_codec(codec),
                         self._widths, eviction_scheduler=self._eviction)

    def get_set(self, name: str, codec=None) -> RSet:
        return RSet(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_set_cache(self, name: str, codec=None) -> RSetCache:
        return RSetCache(name, self._dispatch, self._resolve_codec(codec),
                         self._widths, eviction_scheduler=self._eviction)

    def get_list(self, name: str, codec=None) -> RList:
        return RList(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_queue(self, name: str, codec=None) -> RQueue:
        return RQueue(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_deque(self, name: str, codec=None) -> RDeque:
        return RDeque(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_blocking_queue(self, name: str, codec=None) -> RBlockingQueue:
        return RBlockingQueue(name, self._dispatch, self._resolve_codec(codec),
                              self._widths)

    def get_blocking_deque(self, name: str, codec=None) -> RBlockingDeque:
        return RBlockingDeque(name, self._dispatch, self._resolve_codec(codec),
                              self._widths)

    def get_sorted_set(self, name: str, codec=None,
                       key: Optional[Callable] = None) -> RSortedSet:
        return RSortedSet(
            name, self._dispatch, self._resolve_codec(codec), self._widths,
            key=key, guard_lock=self.get_lock(name + "__sortedset_guard"))

    def get_scored_sorted_set(self, name: str, codec=None) -> RScoredSortedSet:
        return RScoredSortedSet(name, self._dispatch, self._resolve_codec(codec),
                                self._widths)

    def get_lex_sorted_set(self, name: str) -> RLexSortedSet:
        return RLexSortedSet(name, self._dispatch, self._codec, self._widths)

    def get_set_multimap(self, name: str, codec=None) -> RSetMultimap:
        return RSetMultimap(name, self._dispatch, self._resolve_codec(codec),
                            self._widths)

    def get_list_multimap(self, name: str, codec=None) -> RListMultimap:
        return RListMultimap(name, self._dispatch, self._resolve_codec(codec),
                             self._widths)

    def get_set_multimap_cache(self, name: str, codec=None) -> RSetMultimapCache:
        return RSetMultimapCache(name, self._dispatch,
                                 self._resolve_codec(codec), self._widths)

    def get_list_multimap_cache(self, name: str, codec=None) -> RListMultimapCache:
        return RListMultimapCache(name, self._dispatch,
                                  self._resolve_codec(codec), self._widths)

    def get_geo(self, name: str, codec=None) -> RGeo:
        return RGeo(name, self._dispatch, self._resolve_codec(codec), self._widths)

    def get_topic(self, name: str, codec=None) -> RTopic:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisTopic

            _, pubsub, _ = self._redis_coordination()
            return RedisTopic(name, self._resp, pubsub, self._resolve_codec(codec))
        return RTopic(name, self._dispatch, self._resolve_codec(codec),
                      self._require_pubsub("topics"))

    def get_pattern_topic(self, pattern: str, codec=None) -> RPatternTopic:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import (
                RedisPatternTopic)

            _, pubsub, _ = self._redis_coordination()
            return RedisPatternTopic(pattern, self._resp, pubsub,
                                     self._resolve_codec(codec))
        return RPatternTopic(pattern, self._dispatch, self._resolve_codec(codec),
                             self._require_pubsub("topics"))

    # -- coordination -------------------------------------------------------

    def get_lock(self, name: str) -> RLock:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisLock

            scripts, pubsub, watchdog = self._redis_coordination()
            return RedisLock(name, scripts, pubsub, self.id, watchdog)
        return RLock(name, self._dispatch, self._require_pubsub("locks"),
                     self.id, self._watchdog)

    def get_fair_lock(self, name: str) -> RFairLock:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisFairLock

            scripts, pubsub, watchdog = self._redis_coordination()
            return RedisFairLock(name, scripts, pubsub, self.id, watchdog)
        return RFairLock(name, self._dispatch, self._require_pubsub("locks"),
                         self.id, self._watchdog)

    def get_read_write_lock(self, name: str) -> RReadWriteLock:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import (
                RedisReadWriteLock)

            scripts, pubsub, watchdog = self._redis_coordination()
            return RedisReadWriteLock(name, scripts, pubsub, self.id, watchdog)
        return RReadWriteLock(name, self._dispatch,
                              self._require_pubsub("locks"), self.id,
                              self._watchdog)

    def get_multi_lock(self, *locks: RLock) -> RMultiLock:
        return RMultiLock(*locks)

    def get_semaphore(self, name: str) -> RSemaphore:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisSemaphore

            scripts, pubsub, _ = self._redis_coordination()
            return RedisSemaphore(name, scripts, pubsub)
        return RSemaphore(name, self._dispatch, self._require_pubsub("semaphores"))

    def get_count_down_latch(self, name: str) -> RCountDownLatch:
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import (
                RedisCountDownLatch)

            scripts, pubsub, _ = self._redis_coordination()
            return RedisCountDownLatch(name, scripts, pubsub)
        return RCountDownLatch(name, self._dispatch,
                               self._require_pubsub("latches"))

    def get_script(self) -> RScript:
        """Atomic scripting: python functions run on the dispatcher over the
        structure engine; real server-side Lua (EVAL / EVALSHA) in the
        passthrough mode."""
        if self._passthrough:
            from redisson_tpu_torch.interop.coordination_redis import RedisScript

            return RedisScript(self._resp, self._codec)
        return RScript(self._dispatch)

    # -- bucket batch helpers -----------------------------------------------

    def find_buckets(self, pattern: str):
        """Buckets whose names match the glob."""
        return [self.get_bucket(n)
                for n in self.get_keys().get_keys_by_pattern(pattern)]

    def load_bucket_values(self, *keys):
        """name -> decoded value for existing keys; accepts names varargs or
        one iterable."""
        if len(keys) == 1 and not isinstance(keys[0], str):
            keys = tuple(keys[0])
        return self.get_buckets().get(*keys)

    def save_buckets(self, values) -> None:
        """Atomic multi-bucket MSET."""
        self.get_buckets().set(dict(values))

    # -- durability / checkpoint --------------------------------------------

    @property
    def persist(self):
        """The PersistenceManager when Config.persist is set, else None."""
        return self._persist

    @property
    def fault(self):
        """The FaultManager when Config.faults is set, else None."""
        return self._fault

    @property
    def geo(self):
        """The GeoManager when Config.geo is set, else None."""
        return self._geo

    @property
    def replicas(self):
        """The ReplicaManager when Config.replicas is set, else None."""
        return self._replicas

    def wait_for_replicas(self, n: int, timeout_s: float = 5.0) -> int:
        """Redis WAIT analogue: block until n replicas have applied at
        least the primary's current committed journal seq; returns how
        many have (possibly < n on timeout)."""
        if self._replicas is None:
            raise RuntimeError("no replica fleet configured (Config.replicas)")
        return self._replicas.wait_for_replicas(n, timeout_s=timeout_s)

    @property
    def durability(self):
        """The DurabilityManager when a redis tier is configured, else None."""
        return self._durability

    def flush_to_redis(self, names=None) -> int:
        """Flush the named sketches (default: all) to the redis tier; the
        number of objects written."""
        if self._durability is None:
            raise RuntimeError("no redis durability tier configured")
        return self._durability.flush(names)

    def snapshot_now(self) -> str:
        """On-demand persistent snapshot (BGSAVE analogue): cuts through
        the dispatcher barrier, writes via checkpoint.py, truncates covered
        journal segments. Returns the snapshot directory."""
        if self._persist is None:
            raise RuntimeError("no persistence configured (Config.persist)")
        return self._persist.snapshot()

    def save_checkpoint(self, path: str, names=None) -> int:
        """Snapshot sketch state to a local checkpoint directory (the JAX
        package's format). Every object is exported through the executor,
        so each is a copy taken on the dispatcher: bank rows by hll_export,
        BitSets and Blooms (host mirror bits pushed down first) by
        bits_export. In pod mode the sharded BitSets and Blooms (outside the
        store) are exported the same way."""
        self._require_store("checkpointing")
        extra = {}
        wanted = lambda n: names is None or n in names  # noqa: E731
        for n in self.sketch.bank_names():
            if wanted(n):
                exported = self._executor.execute_sync(n, "hll_export", None)
                if exported is not None:
                    regs, version = exported
                    extra[n] = ("hll", regs, {}, version)
        sharded = getattr(self.sketch, "sharded_bits_names", lambda: [])
        for n in list(sharded()) + list(self._store.keys()):
            if wanted(n):
                exported = self._executor.execute_sync(n, "bits_export", None)
                if exported is not None:
                    otype, host, meta, version = exported
                    extra[n] = (otype, host, meta, version)
        return checkpoint.save(self._store, path, names=[], extra_objects=extra)

    def load_checkpoint(self, path: str, names=None) -> int:
        """Restore sketch state from a local checkpoint directory (written
        by either package). Each object is imported through the executor:
        HLLs into bank rows (hll_import), BitSets and Blooms onto the
        device (bits_import; in pod mode into sharded arrays); then every
        restored name's read-cache epoch is bumped."""
        self._require_store("checkpointing")

        def put(name, otype, host, meta) -> bool:
            if otype == "hll":
                self._executor.execute_sync(name, "hll_import", {"regs": host})
                return True
            if otype in ("bitset", "bloom"):
                self._executor.execute_sync(
                    name, "bits_import",
                    {"otype": otype, "array": host, "meta": meta})
                return True
            return False  # the store's own path

        restored = checkpoint.load(self._store, path, names, put=put)
        for n in checkpoint.info(path).get("objects", {}):
            if names is None or n in names:
                self.sketch.notify_restored(n)
        return restored

    def _require_store(self, feature: str) -> None:
        if self._store is None:
            raise NotImplementedError(
                f"{feature} needs a device-resident store; not available in "
                "redis passthrough mode")

    # -- memory facade (the MEMORY command family; memstat/) ----------------

    def _require_memreport(self, command: str):
        if self._memreport is None:
            raise RuntimeError(
                f"{command} requires a device-backed mode; in redis "
                "passthrough the server owns memory introspection")
        return self._memreport

    def memory_usage(self, name: str) -> Optional[int]:
        """MEMORY USAGE: exact device bytes plus metadata overhead for one
        key, or None when the key does not exist."""
        return self._require_memreport("MEMORY USAGE").memory_usage(name)

    def memory_stats(self):
        """MEMORY STATS over the byte ledger."""
        return self._require_memreport("MEMORY STATS").memory_stats()

    def memory_doctor(self):
        """MEMORY DOCTOR: rule-based findings."""
        return self._require_memreport("MEMORY DOCTOR").memory_doctor()

    def memory_verify(self):
        """The ledger invariant: ledger totals against the live tensors'
        nbytes (zero drift when healthy)."""
        if self.memstat is None or self._store is None:
            raise RuntimeError("memory_verify requires a device-backed mode")
        return self.memstat.verify(self._store, self.sketch)

    def info(self, section: Optional[str] = None):
        """INFO: dict of section dicts (server, memory, persistence,
        replication, cluster); `section` filters to one block, like INFO
        MEMORY. A cluster facade has no memory section of its own (each
        shard keeps its ledger)."""
        if self.cluster is not None:
            mode = "cluster"
        else:
            mode = self.config.mode()
        sections = {
            "server": {"mode": mode, "device": str(self.device),
                       "client_id": str(self.id)},
        }
        if self._memreport is not None:
            sections["memory"] = self._memreport.info_memory()
        if self._persist is not None:
            sections["persistence"] = self._persist.stats()
        replication = None
        if self._geo is not None:
            replication = self._geo.info()
        elif self._replicas is not None:
            replication = {"role": "primary"}
        if replication is not None:
            if self._replicas is not None:
                replication["connected_replicas"] = len(
                    self._replicas.replicas)
            sections["replication"] = replication
        if self.cluster is not None:
            sections["cluster"] = self.cluster.cluster_info()
        if section is not None:
            key = section.lower()
            if key not in sections:
                raise ValueError(f"unknown INFO section '{section}'")
            return {key: sections[key]}
        return sections

    # -- CLUSTER command facade (cluster/; CLUSTER INFO / SLOTS / KEYSLOT) ---

    def _require_cluster(self, command: str):
        if self.cluster is None:
            raise RuntimeError(f"{command} requires Config.use_cluster()")
        return self.cluster

    def cluster_keyslot(self, key: str) -> int:
        """CLUSTER KEYSLOT analogue (hashtag-aware CRC16 slot)."""
        return self._require_cluster("CLUSTER KEYSLOT").cluster_keyslot(key)

    def cluster_slots(self):
        """CLUSTER SLOTS analogue: (start, end_inclusive, shard_id,
        replica_entries) ranges; each replica entry is {id, watermark, lag}
        for the owning shard's fleet, like redis lists replicas per range."""
        return self._require_cluster("CLUSTER SLOTS").cluster_slots()

    def cluster_info(self):
        """CLUSTER INFO analogue (cluster_state, slots_assigned, ...)."""
        return self._require_cluster("CLUSTER INFO").cluster_info()

    # -- nodes and topology --------------------------------------------------

    def get_cluster_nodes_group(self):
        """Cluster-scoped health surface; on one device, the same group as
        `get_nodes_group`."""
        return self.get_nodes_group()

    def get_nodes_group(self) -> NodesGroup:
        """Nodes / health: ping the client's device (NodesGroup.pingAll)."""
        return NodesGroup(self)

    def get_topology_manager(self, scan_interval_s: float = 1.0,
                             failed_attempts: int = 3):
        """Failure-detection poller pre-registered with this client's nodes
        (sentinel / cluster monitor analogue). Caller starts / stops it."""
        from redisson_tpu_torch.parallel.topology import TopologyManager

        tm = TopologyManager(scan_interval_s, failed_attempts)
        for node in self.get_nodes_group().nodes():
            tm.add_node(node.ident, node.ping)
        return tm

    # -- services -----------------------------------------------------------

    def get_remote_service(self, name: str = "remote_service"):
        """RPC service registry/proxy factory (RRemoteService analogue).
        One cached instance per name; shut down with the client."""
        from redisson_tpu_torch.services.remote import RRemoteService

        rs = self._remote_services.get(name)
        if rs is None:
            rs = self._remote_services[name] = RRemoteService(self, name)
        return rs

    def get_cache_manager(self, configs=None):
        """Spring-cache-manager analogue over RMap/RMapCache."""
        from redisson_tpu_torch.services.cache_manager import CacheManager

        return CacheManager(self, configs)

    # -- keyspace -----------------------------------------------------------

    def get_keys(self) -> RKeys:
        return RKeys(self._dispatch, self._routing)

    def keys(self, pattern: str = "*"):
        return self._dispatch.execute_sync("", "keys", {"pattern": pattern})

    def flushall(self) -> None:
        # Through the executor, so it serializes with in-flight ops.
        self._dispatch.execute_sync("", "flushall", None)

    def delete(self, name: str) -> bool:
        return self._dispatch.execute_sync(name, "delete", None)

    # -- state carry-over ---------------------------------------------------

    def from_jax_state(self, bank_np: np.ndarray, rows: dict,
                       objects: dict = None) -> None:
        """Install the JAX backend's HLL bank and row map and, given
        `objects` (name -> what the JAX backend's `bits_export` returns for
        it), its BitSet and Bloom objects; ordered on the dispatcher after
        every op submitted before it."""
        self._executor.execute_barrier(
            lambda: self.sketch.from_jax_state(bank_np, rows, objects)).result()

    def to_numpy_state(self):
        """(bank [S, m] int32 numpy, name -> row) after all submitted ops."""
        return self._executor.execute_barrier(self.sketch.to_numpy_state).result()

    def to_numpy_objects(self) -> dict:
        """name -> (otype, cells uint8 numpy, meta) of every BitSet and
        Bloom object, after all submitted ops."""
        return self._executor.execute_barrier(self.sketch.to_numpy_objects).result()

    # -- lifecycle ----------------------------------------------------------

    def get_config(self) -> Config:
        return self.config

    def is_shutdown(self) -> bool:
        return self._is_shutdown

    def is_shutting_down(self) -> bool:
        return self._is_shutting_down

    def shutdown(self) -> None:
        """Stop in the JAX client's order: the fault manager (its watchdog
        reads executor internals; in-flight rebuilds finish while the
        executor still takes their replay), the replica fleet (its prober
        polls this executor; each replica shuts its own client down, the
        promoted one with the persistence a failover attached), the
        snapshotter, the remote services' workers, the redis durability
        tier (its final flush, then its pool), the eviction sweeps and the
        lock watchdog (both submit ops), then the executor
        (drains queued and in-flight runs, which still journal), the
        journal (final fsync), the device completer, the parked blocking
        pops (their waiters get an error), and last the pub/sub delivery
        thread."""
        if self._is_shutdown:
            return
        self._is_shutting_down = True
        try:
            self._shutdown_inner()
        finally:
            # Flips back even when a teardown step raises: a client that
            # reports "shutting down" for ever would wedge its callers.
            self._is_shutting_down = False

    def _shutdown_inner(self) -> None:
        if self.wire is not None:
            # Wire first, in every mode: stop accepting sockets and drain
            # the event loop before the stack underneath starts refusing
            # its submissions.
            try:
                self.wire.stop()
            finally:
                self.wire = None
        if self.cluster is not None:
            # Cluster facade: the shard clients own every background
            # resource; the manager closes the router (its redirect worker)
            # then shuts each shard down through this same path.
            self._eviction.shutdown()
            self.cluster.shutdown()
            self.cluster = None
            self._is_shutdown = True
            return
        if self._passthrough:
            self._shutdown_passthrough()
            return
        if self._fault is not None:
            self._fault.stop()
            self._fault = None
        if self._geo is not None:
            # Before the replicas and persist: link threads read this
            # journal and peer appliers dispatch into this executor; both
            # quiesce (and the LWW sidecar flushes) while the stack under
            # them still takes work.
            self._geo.close()
            self._geo = None
        if self._replicas is not None:
            self._replicas.close()
            self._replicas = None
        if self._persist is not None:
            self._persist.stop_background()
        for rs in self._remote_services.values():
            rs.shutdown(wait=False)
        self._remote_services.clear()
        self._close_durability()
        self._eviction.shutdown()
        self._watchdog.shutdown()
        if self.serve is not None:
            # The retry timer first (pending retries resolve their outer
            # futures with CancelledError), then the executor.
            self.serve.shutdown()
        else:
            self._executor.shutdown()
        if self._persist is not None:
            self._persist.close()
            self._persist = None
        self.sketch.completer.shutdown()
        self._routing.structures.fail_waiters()
        self._pubsub.shutdown()
        self._is_shutdown = True

    def _shutdown_passthrough(self) -> None:
        """The passthrough mode's teardown (JAX's order): the remote
        services, the pool's watchers, the lease renewals and the subscribe
        connection, the pool, the eviction sweeps, then the executor."""
        for rs in self._remote_services.values():
            rs.shutdown(wait=False)
        self._remote_services.clear()
        self._close_durability()
        if self._redis_watchdog is not None:
            self._redis_watchdog.shutdown()
            self._redis_watchdog = None
        if self._redis_pubsub is not None:
            try:
                self._redis_pubsub.close()
            except Exception:
                pass
            self._redis_pubsub = None
        self._eviction.shutdown()
        if self.serve is not None:
            self.serve.shutdown()
        else:
            self._executor.shutdown()
        self._is_shutdown = True

    def _close_durability(self) -> None:
        """Stop the periodic flusher, make the final flush of a clean
        shutdown (a dead server must not abort the rest of shutdown), then
        close the role monitor, the cluster topology manager and the pool."""
        if self._durability is not None:
            self._durability.stop_periodic()
            try:
                self._durability.flush()
            except Exception:
                pass
            self._durability = None
        if self._role_monitor is not None:
            self._role_monitor.close()
            self._role_monitor = None
        if self._cluster_manager is not None:
            self._cluster_manager.close()
            self._cluster_manager = None
        if self._resp is not None:
            try:
                self._resp.close()
            except Exception:
                # A wedged IO loop must not abort the rest of shutdown.
                pass
            self._resp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
