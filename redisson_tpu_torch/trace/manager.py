"""TraceManager: owns the tracer + parity surfaces, fans out finished spans
(counterpart of `redisson_tpu.trace.manager`).

One manager per client.  The executor/serve/journal/backend layers talk
to it through three tiny hooks (``begin_op``, ``begin_run``,
``record_fsync``); everything else — histogram folding, slowlog
threshold checks, monitor fan-out, LATENCY spike rings — happens inside
the span-finish sink, which only runs for sampled spans.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.trace.export import (DEFAULT_BOUNDS_S, chrome_trace,
                                       memstat_counters,
                                       prometheus_exposition)
from redisson_tpu_torch.trace.hist import HistogramSet
from redisson_tpu_torch.trace.monitor import Monitor
from redisson_tpu_torch.trace.slowlog import SlowLog
from redisson_tpu_torch.trace.spans import Span, Tracer
from redisson_tpu_torch.executor import make_lock


class LatencyEvents:
    """LATENCY HISTORY/RESET/DOCTOR parity: per-event spike rings.

    An "event" is a pipeline stage ("queue", "journal", "device", ...)
    or a named internal operation ("journal_fsync").  Spikes above
    ``threshold_s`` are kept in bounded per-event rings of
    ``(timestamp, duration_s)`` — the shape of redis ``LATENCY HISTORY``
    — and ``doctor()`` renders a small human report over them.
    """

    def __init__(self, threshold_s: float = 0.100, history_len: int = 160,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold_s = float(threshold_s)
        self.history_len = max(1, int(history_len))
        self._clock = clock
        self._rings: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = make_lock("manager.TraceManager._lock")

    def observe(self, event: str, duration_s: float) -> bool:
        if duration_s < self.threshold_s:
            return False
        with self._lock:
            ring = self._rings.setdefault(event, [])
            ring.append((self._clock(), duration_s))
            if len(ring) > self.history_len:
                del ring[: len(ring) - self.history_len]
        return True

    def history(self, event: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._rings.get(event, ()))

    def latest(self) -> Dict[str, Tuple[float, float, float]]:
        """event -> (last_ts, last_duration_s, max_duration_s)."""
        out = {}
        with self._lock:
            for event, ring in self._rings.items():
                if ring:
                    out[event] = (ring[-1][0], ring[-1][1],
                                  max(d for _, d in ring))
        return out

    def reset(self, event: Optional[str] = None) -> int:
        with self._lock:
            if event is not None:
                return 1 if self._rings.pop(event, None) is not None else 0
            n = len(self._rings)
            self._rings.clear()
            return n

    def doctor(self) -> str:
        latest = self.latest()
        if not latest:
            return ("Dave, I have observed no latency spikes above %.0f ms. "
                    "The pipeline is healthy." % (self.threshold_s * 1e3))
        lines = ["Latency spikes above %.0f ms:" % (self.threshold_s * 1e3)]
        for event in sorted(latest):
            _ts, last_d, max_d = latest[event]
            count = len(self.history(event))
            lines.append("  %-16s %d spike(s), last %.1f ms, worst %.1f ms"
                         % (event, count, last_d * 1e3, max_d * 1e3))
        worst = max(latest, key=lambda e: latest[e][2])
        lines.append("Worst offender: %s — check the matching SLOWLOG "
                     "entries' stage breakdown." % worst)
        return "\n".join(lines)


class TraceManager:
    """Glue between the pipeline layers and the trace surfaces."""

    def __init__(self, cfg: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Any = None):
        sample_every = getattr(cfg, "sample_every", 128)
        seed = getattr(cfg, "seed", 0)
        ring = getattr(cfg, "ring", 4096)
        slow_ms = getattr(cfg, "slowlog_threshold_ms", 10.0)
        slow_len = getattr(cfg, "slowlog_max_len", 128)
        mon_q = getattr(cfg, "monitor_queue", 1024)
        lat_ms = getattr(cfg, "latency_threshold_ms", 100.0)
        lat_len = getattr(cfg, "latency_history_len", 160)

        self.config = cfg
        self.tracer = Tracer(clock=clock, sample_every=sample_every,
                             seed=seed, ring=ring)
        self.hist = HistogramSet()
        self.slowlog = SlowLog(threshold_s=slow_ms / 1e3, maxlen=slow_len)
        self.monitor = Monitor(default_maxlen=mon_q)
        self.latency = LatencyEvents(threshold_s=lat_ms / 1e3,
                                     history_len=lat_len, clock=clock)
        self.registry = registry
        self.fsync_hist = HistogramSet()
        self.retries = 0
        # memstat ledger (attach_memstat): finished spans stamp byte
        # counter samples into a bounded ring, exported as Chrome-trace
        # "C" events so device memory plots above the span tracks.
        self.memstat = None
        self._mem_samples: List[tuple] = []
        self._mem_last_sample = -1.0
        self.tracer.add_sink(self._on_finish)
        # Pre-bound hot-path callables: begin_op runs for every enqueued
        # op, so shave the attribute hops off its fast path.
        self._maybe_begin = self.tracer.maybe_begin
        self._mon_active = self.monitor.active

    # -- layer hooks (hot path) -------------------------------------------
    def begin_op(self, kind: str, target: str, tenant: str = "",
                 nkeys: int = 0) -> Optional[Span]:
        """Called by the executor for every enqueued op.

        Cost when idle: one ``active()`` check plus the tracer's counter
        stride.  MONITOR sees *every* op (redis parity); spans only the
        sampled ones.
        """
        if self._mon_active():
            self.monitor.publish({"ts": self.tracer.clock(),
                                  "event": "enqueue", "kind": kind,
                                  "target": target, "tenant": tenant,
                                  "nkeys": nkeys})
        return self._maybe_begin(kind, target, tenant, nkeys)

    def begin_run(self, kind: str, target: str, nops: int,
                  nkeys: int) -> Span:
        return self.tracer.begin_run(kind, target, nops=nops, nkeys=nkeys)

    def record_fsync(self, duration_s: float) -> None:
        """Journal hook: every fsync's duration, regardless of sampling."""
        self.fsync_hist.record("journal_fsync", "", duration_s)
        self.latency.observe("journal_fsync", duration_s)

    def retry_event(self, kind: str, target: str, tenant: str,
                    attempt: int, delay_s: float) -> None:
        """Serving-layer hook: a retryable failure was rescheduled."""
        self.retries += 1
        mon = self.monitor
        if mon.active():
            mon.publish({"ts": self.tracer.clock(), "event": "retry",
                         "kind": kind, "target": target, "tenant": tenant,
                         "attempt": attempt, "delay_s": delay_s})

    def attach_memstat(self, ledger) -> None:
        """Start sampling the byte ledger at span-finish time (throttled
        to one sample per 50 ms of tracer clock, ring bounded)."""
        self.memstat = ledger

    # -- span-finish fan-out ----------------------------------------------
    def _on_finish(self, span: Span) -> None:
        if span.span_type != "op":
            return
        ledger = self.memstat
        if ledger is not None and span.t1 is not None:
            if span.t1 - self._mem_last_sample >= 0.050:
                self._mem_last_sample = span.t1
                self._mem_samples.extend(memstat_counters(ledger, span.t1))
                if len(self._mem_samples) > 2048:
                    del self._mem_samples[:len(self._mem_samples) - 2048]
        duration = span.duration_s
        self.hist.record(span.kind, span.tenant, duration)
        self.slowlog.offer(span)
        for stage, d in span.stages().items():
            if stage != "total":
                self.latency.observe(stage, d)
        mon = self.monitor
        if mon.active():
            mon.publish({"ts": span.t1, "event": "complete",
                         "kind": span.kind, "target": span.target,
                         "tenant": span.tenant, "nkeys": span.nkeys,
                         "duration_s": duration, "stages": span.stages(),
                         "error": span.error})

    # -- parity / export surfaces -----------------------------------------
    def chrome_trace(self, t0: Optional[float] = None,
                     t1: Optional[float] = None) -> Dict[str, Any]:
        counters = list(self._mem_samples)
        if self.memstat is not None:
            # Close the counter track at "now" so the last plotted value
            # reflects the current ledger, not the last finished span.
            counters.extend(
                memstat_counters(self.memstat, self.tracer.clock()))
        return chrome_trace(self.tracer.ring(), t0=t0, t1=t1,
                            counters=counters)

    def export_chrome(self, path: str, t0: Optional[float] = None,
                      t1: Optional[float] = None) -> int:
        import json
        doc = self.chrome_trace(t0=t0, t1=t1)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def render_prometheus(self) -> str:
        out = prometheus_exposition(self.hist, bounds_s=DEFAULT_BOUNDS_S)
        if self.fsync_hist.get("journal_fsync", "") is not None:
            out += prometheus_exposition(
                self.fsync_hist, name="trace_journal_fsync_seconds")
        return out

    def commandstats(self) -> Dict[str, Dict[str, float]]:
        """INFO commandstats parity, from the (kind, tenant) histograms."""
        out: Dict[str, Dict[str, float]] = {}
        for kind in self.hist.kinds():
            h = self.hist.merged(kind)
            if not h.count:
                continue
            usec = h.sum_s * 1e6
            out["cmdstat_%s" % kind] = {
                "calls": h.count,
                "usec": usec,
                "usec_per_call": usec / h.count,
                "p50_us": h.quantile(0.50) * 1e6,
                "p99_us": h.quantile(0.99) * 1e6,
            }
        return out

    def latency_history(self, event: str) -> List[Tuple[float, float]]:
        return self.latency.history(event)

    def latency_doctor(self) -> str:
        return self.latency.doctor()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "tracer": self.tracer.snapshot(),
            "slowlog": {"len": len(self.slowlog),
                        "total_logged": self.slowlog.total_logged,
                        "threshold_s": self.slowlog.threshold_s},
            "monitor": self.monitor.snapshot(),
            "latency_events": {e: len(self.latency.history(e))
                               for e in self.latency.latest()},
            "retries": self.retries,
            "hist": self.hist.snapshot(),
        }
