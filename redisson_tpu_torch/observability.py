"""Observability: metrics registry, executor instrumentation, profiler
hooks, and the nodes/health API (counterpart of
`redisson_tpu.observability`).

  * MetricsRegistry — thread-safe counters / gauges / histograms with a
    prometheus-text renderer and a dict snapshot;
  * executor instrumentation — per-kind op counts, coalesced batch-size and
    dispatch-latency histograms, live queue depth (wired by the executor
    when a registry is attached);
  * profile() — context manager around `torch.profiler` for capturing a
    Chrome trace (CPU ops and, on a card, CUDA kernels) of a workload
    section;
  * NodesGroup — ping of the client's device (a small tensor op and a
    synchronize), plus connect/disconnect listener fan-out (the
    ConnectionEventsHub role).

`register_follower` and `register_replica` expose the journal follower's
lag and the read-replica fleet (the client registers the fleet's gauges
when `Config.replicas` is set); `register_wire` the RESP front-end's
wire.* gauges (the client registers them when `Config.wire` is set);
`register_geo` a geo site's geo.* gauges (link lag, LWW arbitration
counters, link against raw bytes; registered when `Config.geo` is set).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

_DEFAULT_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, float("inf"))


class Histogram:
    __slots__ = ("buckets", "counts", "total", "sum", "min", "max", "_lock")

    def __init__(self, buckets=_DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.total = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        self.observe_many([value])

    def observe_many(self, values: list) -> None:
        """`observe` of each value in order, under one lock acquisition."""
        if not values:
            return
        buckets, counts = self.buckets, self.counts
        last = len(counts) - 1
        if len(values) >= 32:  # a folded buffer: bucket in one numpy call
            idx = np.searchsorted(np.asarray(buckets), np.asarray(values, dtype=float))
            binned = np.bincount(np.minimum(idx, last), minlength=len(counts)).tolist()
        else:
            find = bisect.bisect_left
            binned = None
        with self._lock:
            total = self.sum
            if binned is None:
                for value in values:
                    i = find(buckets, value)
                    counts[i if i < last else last] += 1
                    total += value
            else:
                for i, n in enumerate(binned):
                    counts[i] += n
                for value in values:  # in order: the sum of one add per value
                    total += value
            self.sum = total
            self.total += len(values)
            self.min = min(self.min, min(values))
            self.max = max(self.max, max(values))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self.total,
                "sum": self.sum,
                "min": self.min if self.total else None,
                "max": self.max if self.total else None,
                "mean": (self.sum / self.total) if self.total else None,
                "buckets": dict(zip(map(str, self.buckets), self.counts)),
            }


class MetricsRegistry:
    """Names are dotted strings; labels are a frozen kwargs suffix."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._histograms: Dict[str, Histogram] = {}
        # Called before every read (counter / snapshot): writers that
        # buffer their records (ExecutorMetrics) fold them in here.
        self._read_hooks: List[Callable[[], None]] = []

    def add_read_hook(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._read_hooks.append(fn)

    def _before_read(self) -> None:
        for fn in self._read_hooks:
            fn()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def inc_many(self, pairs) -> None:
        """`inc` of each (name, value) pair under one lock acquisition."""
        with self._lock:
            c = self._counters
            for name, value in pairs:
                c[name] = c.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        self._before_read()
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def snapshot(self) -> Dict[str, Any]:
        self._before_read()
        with self._lock:
            gauges = {k: fn for k, fn in self._gauges.items()}
            hists = dict(self._histograms)
        out: Dict[str, Any] = {"gauges": {}, "histograms": {}}
        for k, fn in gauges.items():
            # A raising gauge callback is dropped from this snapshot and
            # counted, never poisons the rest (one broken subsystem must
            # not take down the whole observability surface).
            try:
                out["gauges"][k] = fn()
            except Exception:
                self.inc("metrics.callback_errors")
        for k, h in hists.items():
            out["histograms"][k] = h.snapshot()
        # Counters copied after gauge evaluation so callback_errors bumps
        # from THIS snapshot are already visible in it.
        with self._lock:
            out["counters"] = dict(self._counters)
        return out

    def render_prometheus(self) -> str:
        """Text exposition format: counters, gauges, and *scrapeable*
        histogram families — cumulative `_bucket{le=...}` series in
        ascending bound order ending with the mandatory `le="+Inf"`
        (Prometheus spells infinity that way, not `inf`), plus `_sum`
        and `_count`. `_count` always equals the `+Inf` bucket."""
        snap = self.snapshot()
        lines: List[str] = []

        def sanitize(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        def fmt_bound(v: float) -> str:
            if v == float("inf"):
                return "+Inf"
            s = repr(float(v))
            return s[:-2] if s.endswith(".0") else s

        for k, v in sorted(snap["counters"].items()):
            lines.append(f"# TYPE {sanitize(k)} counter")
            lines.append(f"{sanitize(k)} {v}")
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {sanitize(k)} gauge")
            lines.append(f"{sanitize(k)} {v if v is not None else 'NaN'}")
        for k, h in sorted(snap["histograms"].items()):
            base = sanitize(k)
            lines.append(f"# TYPE {base} histogram")
            cumulative = 0
            saw_inf = False
            for le, c in h["buckets"].items():
                bound = float(le)
                cumulative += c
                saw_inf = saw_inf or bound == float("inf")
                lines.append(
                    f'{base}_bucket{{le="{fmt_bound(bound)}"}} {cumulative}')
            if not saw_inf:
                # Custom bucket ladders without an explicit inf bound still
                # need the +Inf series (scrapers reject histograms without
                # it); overflow observations were clamped into the last
                # bucket, so the running cumulative == count here.
                lines.append(f'{base}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{base}_sum {h['sum']}")
            lines.append(f"{base}_count {h['count']}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Profiler hook
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed block into
    `logdir` as a Chrome trace JSON (`trace.json`; CUDA activity too when a
    card is present). Like the JAX version, a profiler that cannot start or
    stop is swallowed and the block still runs; callers that need the trace
    check that the file exists."""
    import os

    import torch

    prof = None
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Nodes / health (NodesGroup + ConnectionEventsHub analogue)
# ---------------------------------------------------------------------------


@dataclass
class Node:
    """One compute or durability node."""

    kind: str  # "device"
    ident: str
    _pinger: Callable[[], bool] = field(repr=False, default=None)

    def ping(self) -> bool:
        try:
            return bool(self._pinger())
        except Exception:
            return False

    def get_type(self) -> str:
        """Reference Node.getType() (NodeType analogue: the tier kind)."""
        return self.kind

    def get_addr(self) -> str:
        """Reference Node.getAddr()."""
        return self.ident

    def info(self) -> dict:
        """Reference ClusterNode.info(): the node's descriptive fields."""
        return {"type": self.kind, "addr": self.ident,
                "alive": self.ping()}


class NodesGroup:
    """client.get_nodes_group(): enumerate + ping nodes (the client's
    device, and the redis durability tier's server when one is
    configured), listen to connect/disconnect events."""

    def __init__(self, client):
        self._client = client
        self._listeners: List[Callable[[str, str], None]] = []

    def nodes(self) -> List[Node]:
        device = self._client.device
        # The passthrough mode holds no device state: its only node is the
        # server.
        out = ([] if device is None
               else [Node("device", str(device), _device_pinger(device))])
        resp = getattr(self._client, "_resp", None)
        if resp is not None:

            def ping_redis() -> bool:
                return resp.execute("PING") in (b"PONG", b"pong")

            # A topology router names its current master (JAX reads
            # host/port, which only a single pool has).
            ident = (getattr(resp, "master_address", None)
                     or f"{resp.host}:{resp.port}")
            out.append(Node("redis", ident, ping_redis))
        return out

    def ping_all(self) -> bool:
        return all(n.ping() for n in self.nodes())

    def add_connection_listener(self, fn: Callable[[str, str], None]) -> None:
        """fn(event, ident) with event in {'connect', 'disconnect'}."""
        self._listeners.append(fn)

    def remove_connection_listener(self, fn: Callable[[str, str], None]) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def fire(self, event: str, ident: str) -> None:
        for fn in list(self._listeners):
            try:
                fn(event, ident)
            except Exception:
                pass


def _device_pinger(device) -> Callable[[], bool]:
    def ping() -> bool:
        import torch

        y = torch.zeros((8,), dtype=torch.int32, device=device) + 1
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        return int(y.sum()) == 8

    return ping


# ---------------------------------------------------------------------------
# Executor instrumentation helper
# ---------------------------------------------------------------------------


class ExecutorMetrics:
    """Attached to a CommandExecutor: the dispatcher reports op/batch/latency
    stats here. A run costs its recording thread one tuple appended to a
    buffer; the buffer is folded into the registry's counters and
    histograms, in recording order, when the registry is read and every
    FOLD_EVERY records, so the values read are those of recording each
    run directly."""

    FOLD_EVERY = 256

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self._pending: deque = deque()  # append / popleft: thread-safe
        self._fold_lock = threading.Lock()
        self._kinds: Dict[str, tuple] = {}
        self.registry.add_read_hook(self.fold)

    def record_batch(self, kind: str, nops: int, nkeys: int,
                     latency_s: float, queue_delay_s: Optional[float] = None,
                     cap: int = 0, stage_s: Optional[float] = None) -> None:
        # latency_s: with pipelined dispatch the completion latency (stage +
        # device compute + D2H), observed when the run's last future
        # resolves. stage_s: the host-side staging alone (the dispatcher
        # thread's share of it). queue_delay_s: the oldest op's wait from
        # enqueue to dispatch, THE serving-latency number admission control
        # exists to bound.
        p = self._pending
        p.append((kind, nops, nkeys, latency_s, queue_delay_s, cap, stage_s))
        if len(p) >= self.FOLD_EVERY:
            self.fold()

    def record_run(self, inflight_depth: int, overlapped: bool) -> None:
        """One pipelined run retired: depth seen at its dispatch, and
        whether another run was already in flight then (overlap)."""
        p = self._pending
        p.append((None, inflight_depth, overlapped))
        if len(p) >= self.FOLD_EVERY:
            self.fold()

    def fold(self) -> None:
        """Move the buffered records into the registry."""
        pending = self._pending
        if not pending:
            return
        with self._fold_lock:
            batches, runs = [], []
            while True:
                try:
                    rec = pending.popleft()
                except IndexError:
                    break
                (runs if rec[0] is None else batches).append(rec)
            registry = self.registry
            counters = []
            hists = []
            if runs:
                counters.append(("executor.runs_total", float(len(runs))))
                overlapped = sum(1 for r in runs if r[2])
                if overlapped:
                    counters.append(("executor.runs_overlapped_total",
                                     float(overlapped)))
                hists.append(("executor.inflight_depth", [r[1] for r in runs]))
            if batches:
                by_kind: Dict[str, list] = {}
                for r in batches:
                    by_kind.setdefault(r[0], []).append(r)
                for kind, recs in by_kind.items():
                    names = self._kinds.get(kind)
                    if names is None:
                        names = self._kinds[kind] = (f"executor.ops.{kind}",
                                                     f"executor.latency_s.{kind}",
                                                     f"executor.stage_s.{kind}")
                    counters.append((names[0], sum(r[1] for r in recs)))
                    hists += [(names[1], [r[3] for r in recs]),
                              (names[2], [r[6] for r in recs if r[6] is not None])]
                counters += [("executor.ops_total", sum(r[1] for r in batches)),
                             ("executor.keys_total", sum(r[2] for r in batches)),
                             ("executor.batches_total", float(len(batches)))]
                hists += [
                    ("executor.batch_ops", [r[1] for r in batches]),
                    ("executor.batch_keys", [r[2] for r in batches]),
                    ("executor.queue_delay_s",
                     [max(0.0, r[4]) for r in batches if r[4] is not None]),
                    ("executor.batch_occupancy",
                     [r[2] / r[5] for r in batches if r[5] > 0])]
            registry.inc_many(counters)
            for name, vals in hists:
                if vals:
                    registry.histogram(name).observe_many(vals)

    def record_error(self, kind: str) -> None:
        self.registry.inc(f"executor.errors.{kind}")
        self.registry.inc("executor.errors_total")

    def record_expired(self, kind: str, nops: int) -> None:
        """Ops whose deadline passed before device dispatch."""
        self.registry.inc(f"executor.expired.{kind}", nops)
        self.registry.inc("executor.expired_total", nops)

    def record_cancelled(self, nops: int) -> None:
        """Ops still queued when the dispatcher exited (shutdown sweep)."""
        self.registry.inc("executor.cancelled_total", nops)


def register_read_cache(registry: MetricsRegistry, cache) -> None:
    """Expose a backend's epoch-stamped read cache (hits / misses / hit
    ratio / live entries) as gauges — the client wires this when the sketch
    backend carries one (client-side-caching observability analogue)."""
    registry.gauge("backend.read_cache_hits", lambda: cache.hits)
    registry.gauge("backend.read_cache_misses", lambda: cache.misses)
    registry.gauge("backend.read_cache_entries", lambda: len(cache))

    def _ratio() -> float:
        total = cache.hits + cache.misses
        return (cache.hits / total) if total else 0.0

    registry.gauge("backend.read_cache_hit_ratio", _ratio)


def register_delta_ingest(registry: MetricsRegistry, backend) -> None:
    """Expose a backend's delta-ingest counters (see TpuBackend.counters /
    ingest_stats) as backend.* gauges: link bytes actually shipped vs what
    the raw-key path would have cost, host fold time, and fused merge
    launches — the observable core of the delta tentpole (link compression
    and one-launch-per-window retirement)."""
    def _stat(key, default=0):
        return lambda: backend.ingest_stats().get(key, default)

    registry.gauge("backend.link_bytes", _stat("link_bytes"))
    registry.gauge("backend.raw_bytes", _stat("raw_bytes"))
    registry.gauge("backend.delta_fold_s", _stat("delta_fold_s", 0.0))
    registry.gauge("backend.merge_launches", _stat("merge_launches"))
    registry.gauge("backend.delta_runs", _stat("delta_runs"))
    registry.gauge("backend.delta_keys", _stat("delta_keys"))
    registry.gauge("backend.delta_bytes_per_key",
                   _stat("delta_bytes_per_key", 0.0))


def register_persist(registry: MetricsRegistry, manager) -> None:
    """Expose the durability subsystem (persist/) as persist.* gauges:
    journal throughput and group-commit behavior, snapshot cadence, and —
    when the manager recovered at startup — the replay rate. Follower lag
    lives on the follower's own client registry (register_follower)."""
    def _journal(key, default=0):
        def read():
            j = manager.journal
            return j.stats().get(key, default) if j is not None else default
        return read

    registry.gauge("persist.appended", _journal("records_appended"))
    registry.gauge("persist.runs_appended", _journal("runs_appended"))
    registry.gauge("persist.bytes_appended", _journal("bytes_appended"))
    registry.gauge("persist.fsyncs", _journal("fsyncs"))
    registry.gauge("persist.group_mean", _journal("group_mean", 0.0))
    registry.gauge("persist.last_seq", _journal("last_seq"))
    registry.gauge("persist.durable_seq", _journal("durable_seq"))
    registry.gauge("persist.unsynced_runs", _journal("unsynced_runs"))
    registry.gauge("persist.segments", _journal("segments"))
    registry.gauge(
        "persist.snapshots_taken",
        lambda: manager.snapshotter.snapshots_taken if manager.snapshotter else 0)
    registry.gauge(
        "persist.snapshot_seq",
        lambda: manager.snapshotter.last_seq if manager.snapshotter else 0)
    registry.gauge(
        "persist.replay_ops_s",
        lambda: (manager.last_recovery or {}).get("ops_per_s", 0.0))
    registry.gauge(
        "persist.replayed",
        lambda: (manager.last_recovery or {}).get("replayed", 0))


def register_fault(registry: MetricsRegistry, manager) -> None:
    """Expose the fault subsystem (fault/) as fault.* gauges: injection
    volume, classification outcomes, retry pressure attributable to
    device faults, and the rebuild loop's progress. `manager` is a
    fault.manager.FaultManager; its injector/watchdog/rebuild members may
    each be None (gauges then read 0)."""
    from redisson_tpu_torch.fault import taxonomy

    registry.gauge(
        "fault.injected",
        lambda: manager.injector.injected if manager.injector else 0)
    registry.gauge(
        "fault.classified", lambda: taxonomy.stats()["classified"])
    # Serve-layer retries fire on RetryableError, whose device-fault
    # subclass is RetryableFault — the retry counter is the observable
    # "faults the retry machinery absorbed" signal.
    registry.gauge(
        "fault.retried", lambda: registry.counter("serve.retries_total"))
    registry.gauge(
        "fault.rebuilt",
        lambda: manager.rebuild.rebuilt_total if manager.rebuild else 0)
    registry.gauge(
        "fault.quarantined",
        lambda: (manager.rebuild.quarantined_total
                 if manager.rebuild else 0))
    registry.gauge(
        "fault.degraded",
        lambda: (len(manager.rebuild.snapshot()["degraded"])
                 if manager.rebuild else 0))
    registry.gauge(
        "fault.rebuild_s",
        lambda: manager.rebuild.last_rebuild_s if manager.rebuild else 0.0)
    registry.gauge(
        "fault.watchdog_trips",
        lambda: manager.watchdog.trips if manager.watchdog else 0)


def register_trace(registry: MetricsRegistry, manager) -> None:
    """Expose the trace subsystem (trace/) as trace.* gauges: sampling
    volume, span throughput, slowlog pressure and monitor fan-out health.
    `manager` is a trace.manager.TraceManager."""
    tracer = manager.tracer
    registry.gauge("trace.sampled", lambda: tracer.sampled)
    registry.gauge("trace.skipped", lambda: tracer.skipped)
    registry.gauge("trace.spans_finished", lambda: tracer.finished)
    registry.gauge("trace.slowlog_len", lambda: len(manager.slowlog))
    registry.gauge("trace.slowlog_total",
                   lambda: manager.slowlog.total_logged)
    registry.gauge("trace.monitor_subscribers",
                   lambda: manager.monitor.active())
    registry.gauge("trace.monitor_dropped", lambda: manager.monitor.dropped())
    registry.gauge("trace.retries", lambda: manager.retries)


def register_geo(registry: MetricsRegistry, manager) -> None:
    """Geo-replication site gauges (geo/manager.py), JAX's names: link
    health (worst lag in records and seconds), the LWW arbitration counters
    (applies, suppressions, DEL-race resurrections), and the bytes shipped
    against what the raw key batches would have cost."""
    registry.gauge("geo.peers", lambda: len(manager.links))
    registry.gauge("geo.applied", lambda: manager.applier.applied)
    registry.gauge("geo.suppressed", lambda: manager.applier.suppressed)
    registry.gauge("geo.resurrections",
                   lambda: manager.applier.resurrections)

    def _worst(field):
        def read():
            lags = [link.lag()[field] for link in list(manager.links.values())]
            return max(lags) if lags else 0
        return read

    def _total(stat):
        def read():
            return sum(link.stats[stat]
                       for link in list(manager.links.values()))
        return read

    registry.gauge("geo.max_lag_records", _worst("records"))
    registry.gauge("geo.max_lag_seconds", _worst("seconds"))
    registry.gauge("geo.link_bytes", _total("link_bytes"))
    registry.gauge("geo.raw_bytes", _total("raw_bytes"))
    registry.gauge("geo.partitions", _total("partitions"))
    registry.gauge("geo.repairs", _total("repairs"))


def register_wire(registry: MetricsRegistry, wire) -> None:
    """Expose the RESP wire front-end (wire/) as wire.* gauges: connection
    population, in-flight pipeline pressure, byte throughput, shed volume
    and the connection-scheduler's window coalescing depth. `wire` is a
    wire.server.WireServer or (cluster facade) ClusterWireFrontend — both
    expose the same counters; the frontend sums across shard servers."""
    def _snap(key, default=0):
        return lambda: wire.snapshot().get(key, default)

    registry.gauge("wire.connections", wire.connections)
    registry.gauge("wire.connections_total", _snap("total_connections"))
    registry.gauge("wire.inflight", wire.inflight)
    registry.gauge("wire.bytes_in", _snap("bytes_in"))
    registry.gauge("wire.bytes_out", _snap("bytes_out"))
    registry.gauge("wire.commands", _snap("commands_total"))
    registry.gauge("wire.engine_commands", _snap("engine_commands"))
    registry.gauge("wire.sheds", _snap("sheds_total"))
    registry.gauge("wire.redirects", _snap("redirects_rendered"))
    registry.gauge("wire.windows", _snap("windows_flushed"))
    registry.gauge("wire.pipeline_depth", _snap("last_window_depth"))
    registry.gauge("wire.pipeline_depth_avg", _snap("avg_window_depth", 0.0))
    registry.gauge("wire.dropped_conns", _snap("dropped_conns"))
    # loop-stall witness feed: zeros unless REDISSON_TPU_LOOP_WITNESS=1
    # armed the witness for this server's loop
    registry.gauge("wire.loop_lag_p99_us", _snap("loop_lag_p99_us"))
    registry.gauge("wire.loop_stalls", _snap("loop_stalls"))


def register_memstat(registry: MetricsRegistry, ledger,
                     pressure=None) -> None:
    """Expose the memstat ledger as memstat.* gauges: exact live/peak
    device bytes, per-kind totals, sampled meter categories, and (when a
    watermark is configured) the pressure gate's shed count. `ledger` is
    a memstat.MemLedger; scrapes ride render_prometheus like every other
    subsystem."""
    registry.gauge("memstat.live_bytes", ledger.live_bytes)
    registry.gauge("memstat.peak_bytes", ledger.peak_bytes)
    registry.gauge("memstat.keys", ledger.keys_count)
    registry.gauge("memstat.bank_bytes", ledger.bank_bytes)
    registry.gauge("memstat.meter_errors", lambda: ledger.meter_errors)
    for kind in ("hll", "bitset", "bloom"):
        registry.gauge(f"memstat.{kind}_bytes",
                       lambda k=kind: ledger.kind_bytes().get(k, 0))
    for cat in ("cache", "scratch", "staging", "disk"):
        registry.gauge(f"memstat.{cat}_bytes",
                       lambda c=cat: ledger.meter_totals()[c])
    if pressure is not None:
        registry.gauge("memstat.shed_total", lambda: pressure.shed_total)
        registry.gauge("memstat.high_watermark_bytes",
                       lambda: pressure.config.high_watermark_bytes)


def register_follower(registry: MetricsRegistry, follower) -> None:
    """Bounded-lag gauge for a warm standby (persist/follower.py)."""
    registry.gauge("persist.follower_lag", follower.lag)
    registry.gauge("persist.follower_applied_seq", lambda: follower.applied_seq)


def register_replica(registry: MetricsRegistry, manager) -> None:
    """Read-replica fleet gauges (replica/manager.py): worst-case lag and
    lowest watermark across the fleet, PSYNC-parity resync counters
    (sync_full / sync_partial_ok), promotions, and the router's read
    routing split."""
    registry.gauge("replica.count", lambda: len(manager.replicas))
    registry.gauge("replica.max_lag", manager.max_lag)
    registry.gauge("replica.min_watermark", manager.min_watermark)
    registry.gauge("replica.full_resyncs", manager.full_resyncs)
    registry.gauge("replica.partial_resyncs", manager.partial_resyncs)
    registry.gauge("replica.promotions", lambda: manager.promotions)
    # Failover generation: which journal stream is live (0 = the original
    # primary's, N = the Nth promotee's epoch journal) and how many
    # demoted primaries the fleet still tracks for teardown.
    registry.gauge("replica.epoch", lambda: manager._epoch)
    registry.gauge("replica.retired_primaries",
                   lambda: len(manager._retired))
    registry.gauge("replica.reads",
                   lambda: manager.router.replica_reads if manager.router else 0)
    registry.gauge("replica.primary_fallbacks",
                   lambda: manager.router.primary_fallbacks if manager.router else 0)
    registry.gauge("replica.moved_retries",
                   lambda: (manager.router.replica_moved_retries
                            if manager.router else 0))
