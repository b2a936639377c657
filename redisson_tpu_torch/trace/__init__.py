"""Sampling trace subsystem (counterpart of `redisson_tpu.trace`): per-op spans, quantile latency, SLOWLOG /
MONITOR / LATENCY parity surfaces, Chrome-trace export.

The executor, serving layer, journal and backend stamp events onto
sampled spans; the :class:`~redisson_tpu_torch.trace.manager.TraceManager`
folds finished spans into histograms, the slowlog and live monitor taps.
Everything is bounded (rings, subscriber queues) and lock-light so the
dispatcher never blocks on introspection.
"""

from redisson_tpu_torch.trace.export import chrome_trace, prometheus_exposition
from redisson_tpu_torch.trace.hist import HistogramSet, LatencyHistogram
from redisson_tpu_torch.trace.manager import LatencyEvents, TraceManager
from redisson_tpu_torch.trace.monitor import Monitor, MonitorTap, format_event
from redisson_tpu_torch.trace.slowlog import SlowLog, SlowLogEntry
from redisson_tpu_torch.trace.spans import Span, Tracer, stage_breakdown

__all__ = [
    "HistogramSet",
    "LatencyEvents",
    "LatencyHistogram",
    "Monitor",
    "MonitorTap",
    "SlowLog",
    "SlowLogEntry",
    "Span",
    "TraceManager",
    "Tracer",
    "chrome_trace",
    "format_event",
    "prometheus_exposition",
    "stage_breakdown",
]
