"""Exports: Chrome trace-event JSON (Perfetto) and Prometheus exposition
(counterpart of `redisson_tpu.trace.export`).

``chrome_trace`` turns a window of finished spans into the Trace Event
Format chrome://tracing / ui.perfetto.dev consume: one complete ("X")
event per op span plus nested per-stage events, run spans on their own
track, and instant ("i") events for point annotations like steals and
cache hits.  ``prometheus_exposition`` renders a HistogramSet as a
proper Prometheus histogram family — cumulative ``le`` buckets ending
in ``+Inf`` plus ``_sum``/``_count`` — keyed by (kind, tenant) labels.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

from redisson_tpu_torch.trace.hist import HistogramSet
from redisson_tpu_torch.trace.spans import Span, _PIPELINE

_INSTANT_EVENTS = ("stolen", "cache_hit", "cache_miss", "expired")

# Default Prometheus bucket ladder: 10us .. ~80s, x2 per rung.
DEFAULT_BOUNDS_S = tuple(1e-5 * (2 ** i) for i in range(24))


def _us(t: float) -> float:
    return t * 1e6


def chrome_trace(spans: Iterable[Span], t0: Optional[float] = None,
                 t1: Optional[float] = None, pid: int = 1,
                 counters: Optional[Iterable[Sequence]] = None
                 ) -> Dict[str, Any]:
    """Build a Chrome trace-event dict from finished spans.

    ``t0``/``t1`` (tracer-clock seconds) clip to a time window.  Each op
    target gets its own ``tid`` row; runs go on a shared "runs" row so
    the pipeline window structure is visible above the ops it carries.
    ``counters`` is an optional iterable of ``(name, t_seconds, value)``
    samples rendered as Counter ("C") events — the memstat byte series
    (live/scratch/staging) plot as filled area tracks above the spans
    (see ``memstat_counters``).
    """
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    run_tid = 0

    def tid_for(target: str) -> int:
        tid = tids.get(target)
        if tid is None:
            tid = len(tids) + 1
            tids[target] = tid
        return tid

    for span in spans:
        if span.t1 is None:
            continue
        if t0 is not None and span.t1 < t0:
            continue
        if t1 is not None and span.t0 > t1:
            continue
        tid = run_tid if span.span_type == "run" else tid_for(span.target)
        args: Dict[str, Any] = {
            "target": span.target,
            "tenant": span.tenant,
            "nkeys": span.nkeys,
            "span_id": span.span_id,
        }
        if span.run_id is not None:
            args["run_id"] = span.run_id
        if span.error:
            args["error"] = span.error
        if span.annotations:
            args.update(span.annotations)
        events.append({
            "name": span.kind if span.span_type == "op" else "run:%s" % span.kind,
            "cat": span.span_type,
            "ph": "X",
            "ts": _us(span.t0),
            "dur": max(0.0, _us(span.t1) - _us(span.t0)),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        # Nested per-stage slices, derived from consecutive pipeline marks.
        marks: Dict[str, float] = {}
        for name, t in span.events:
            if name not in marks:
                marks[name] = t
        prev: Optional[float] = None
        for name, stage in _PIPELINE:
            t = marks.get(name)
            if t is None:
                continue
            if prev is not None and stage is not None and t > prev:
                events.append({
                    "name": "%s:%s" % (span.kind, stage),
                    "cat": "stage",
                    "ph": "X",
                    "ts": _us(prev),
                    "dur": _us(t) - _us(prev),
                    "pid": pid,
                    "tid": tid,
                    "args": {"span_id": span.span_id},
                })
            prev = t
        for name, t in span.events:
            if name in _INSTANT_EVENTS:
                events.append({
                    "name": name,
                    "cat": "mark",
                    "ph": "i",
                    "s": "t",
                    "ts": _us(t),
                    "pid": pid,
                    "tid": tid,
                    "args": {"span_id": span.span_id},
                })
    for name, t, value in (counters or ()):
        if t0 is not None and t < t0:
            continue
        if t1 is not None and t > t1:
            continue
        events.append({
            "name": name,
            "cat": "memstat",
            "ph": "C",
            "ts": _us(t),
            "pid": pid,
            "args": {"bytes": value},
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def memstat_counters(ledger, now: float) -> List[tuple]:
    """One Chrome-trace counter sample per memstat byte series at `now`
    (tracer-clock seconds): feed accumulated samples into
    ``chrome_trace(counters=...)`` to plot device memory usage over the window."""
    totals = ledger.meter_totals()
    return [
        ("memstat.live_bytes", now, ledger.live_bytes()),
        ("memstat.cache_bytes", now, totals["cache"]),
        ("memstat.scratch_bytes", now, totals["scratch"]),
        ("memstat.staging_bytes", now, totals["staging"]),
    ]


def _fmt(v: float) -> str:
    """Float formatting for exposition values: trim trailing zeros."""
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


def prometheus_exposition(hists: HistogramSet,
                          name: str = "trace_op_latency_seconds",
                          bounds_s: Sequence[float] = DEFAULT_BOUNDS_S) -> str:
    """Render per-(kind, tenant) histograms as one Prometheus family."""
    lines = [
        "# HELP %s End-to-end op latency by kind/tenant." % name,
        "# TYPE %s histogram" % name,
    ]
    for (kind, tenant), h in sorted(hists.items()):
        labels = 'kind="%s",tenant="%s"' % (kind, tenant)
        cum = 0
        for bound, count in h.cumulative(bounds_s):
            cum = count
            lines.append('%s_bucket{%s,le="%s"} %d'
                         % (name, labels, _fmt(bound), count))
        lines.append('%s_bucket{%s,le="+Inf"} %d' % (name, labels, h.count))
        assert h.count >= cum  # cumulative series must be monotone
        lines.append("%s_sum{%s} %s" % (name, labels, _fmt(h.sum_s)))
        lines.append("%s_count{%s} %d" % (name, labels, h.count))
    return "\n".join(lines) + "\n"
