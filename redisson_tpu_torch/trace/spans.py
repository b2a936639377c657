"""Per-op spans and the sampling tracer (counterpart of
`redisson_tpu.trace.spans`).

A :class:`Span` is a tiny append-only record of (event, timestamp)
pairs stamped by whichever layer currently holds the op: the serving
layer stamps ``admitted``, the executor stamps ``queued`` / ``stolen``
/ ``dispatched`` / ``journaled`` / ``staged`` / ``completed``, the
backend stamps read-cache hits.  Timestamps come from one injectable
monotonic clock so a fake clock makes the whole lifecycle
deterministic in tests.

Sampling is a counter stride, not an RNG: with ``sample_every=N`` and
seed ``s``, ops whose admission index ``i`` satisfies
``i % N == s % N`` are sampled.  That makes the decision O(1),
lock-free and exactly reproducible under a seed, and guarantees a 1/N
rate regardless of traffic shape.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# Event order along the op pipeline.  ``stage_breakdown`` attributes the
# gap between consecutive *present* marks to the later mark's stage.
_PIPELINE = (
    ("admitted", None),        # serving layer let the op through admission
    ("queued", "admission"),   # executor accepted it into a target queue
    ("dispatched", "queue"),   # dispatcher pulled it into a run
    ("journaled", "journal"),  # WAL append (+ inline fsync) finished
    ("staged", "stage"),       # backend.run returned (H2D + launch enqueued)
    ("completed", "device"),   # future resolved (D2H landed / error)
)


class Span:
    """One op's (or run's) trip through the pipeline."""

    __slots__ = (
        "span_id", "span_type", "kind", "target", "tenant", "nkeys",
        "run_id", "t0", "t1", "events", "annotations", "error", "_tracer",
    )

    def __init__(self, tracer: "Tracer", span_id: int, span_type: str,
                 kind: str, target: str, tenant: str = "", nkeys: int = 0):
        self._tracer = tracer
        self.span_id = span_id
        self.span_type = span_type  # "op" | "run"
        self.kind = kind
        self.target = target
        self.tenant = tenant
        self.nkeys = nkeys
        self.run_id: Optional[int] = None
        self.t0 = tracer.clock()
        self.t1: Optional[float] = None
        self.events: List[Tuple[str, float]] = []
        self.annotations: Dict[str, Any] = {}
        self.error: Optional[str] = None

    # -- stamping (hot path: one clock read + one list append) -----------
    def event(self, name: str, t: Optional[float] = None) -> None:
        self.events.append((name, self._tracer.clock() if t is None else t))

    def annotate(self, **kw: Any) -> None:
        self.annotations.update(kw)

    def finish(self, error: Optional[str] = None) -> None:
        self._tracer.finish(self, error=error)

    # -- derived ----------------------------------------------------------
    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else self._tracer.clock()
        return max(0.0, end - self.t0)

    def first(self, name: str) -> Optional[float]:
        for n, t in self.events:
            if n == name:
                return t
        return None

    def stages(self) -> Dict[str, float]:
        return stage_breakdown(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "span_type": self.span_type,
            "kind": self.kind,
            "target": self.target,
            "tenant": self.tenant,
            "nkeys": self.nkeys,
            "run_id": self.run_id,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": self.duration_s,
            "events": list(self.events),
            "stages": self.stages(),
            "annotations": dict(self.annotations),
            "error": self.error,
        }


def stage_breakdown(span: Span) -> Dict[str, float]:
    """Attribute a span's latency to pipeline stages.

    Returns ``{stage: seconds}`` for every stage whose bounding marks are
    both present, plus ``total``.  Missing intermediate marks (e.g. no
    journal configured) collapse into the next present stage.
    """
    marks: Dict[str, float] = {}
    for name, t in span.events:
        if name not in marks:
            marks[name] = t
    out: Dict[str, float] = {}
    prev: Optional[float] = None
    for name, stage in _PIPELINE:
        t = marks.get(name)
        if t is None:
            continue
        if prev is not None and stage is not None:
            out[stage] = max(0.0, t - prev)
        prev = t
    start = marks.get("admitted", marks.get("queued", span.t0))
    end = span.t1 if span.t1 is not None else prev
    if end is not None:
        out["total"] = max(0.0, end - start)
    return out


class Tracer:
    """Creates, samples and retires spans.

    ``maybe_begin`` is the only per-op cost when tracing is enabled: a
    counter increment, a modulo, and (1/N of the time) a Span
    allocation.  Finished spans land in a bounded ring and are offered
    to registered sinks (the TraceManager's histogram/slowlog/monitor
    fan-out).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 sample_every: int = 128, seed: int = 0, ring: int = 4096):
        self.clock = clock
        self.sample_every = max(1, int(sample_every))
        self._phase = int(seed) % self.sample_every
        self._counter = itertools.count()
        self._run_ids = itertools.count(1)
        self._ring: List[Span] = []
        self._ring_cap = max(1, int(ring))
        self._ring_lock = threading.Lock()
        self._tls = threading.local()
        # Flipped (sticky) by the first annotate_next.  Until then the
        # per-op fast path skips the thread-local read entirely — plain
        # executor clients (no serving layer) never pay for it.
        self._tls_inuse = False
        self._sinks: List[Callable[[Span], None]] = []
        self.sampled = 0
        self.skipped = 0
        self.finished = 0

    # -- sinks ------------------------------------------------------------
    def add_sink(self, fn: Callable[[Span], None]) -> None:
        self._sinks.append(fn)

    # -- cross-layer annotations (same-thread handoff) --------------------
    def annotate_next(self, **kw: Any) -> None:
        """Stash annotations for the next op this thread enqueues.

        The serving layer calls this just before ``execute_async`` so the
        executor-created span inherits the admission timestamp and retry
        attempt without widening the executor API.  Consumed (and always
        cleared) by the next ``maybe_begin`` on the same thread.
        """
        self._tls_inuse = True
        self._tls.pending = kw

    def _take_pending(self) -> Optional[Dict[str, Any]]:
        pending = getattr(self._tls, "pending", None)
        if pending is not None:
            self._tls.pending = None
        return pending

    # -- span lifecycle ---------------------------------------------------
    def maybe_begin(self, kind: str, target: str, tenant: str = "",
                    nkeys: int = 0) -> Optional[Span]:
        i = next(self._counter)
        # Pending annotations must be popped for EVERY op once the serve
        # layer uses the handoff — a stale dict would otherwise leak into
        # the next sampled op on this thread.
        pending = self._take_pending() if self._tls_inuse else None
        if i % self.sample_every != self._phase:
            self.skipped += 1
            return None
        self.sampled += 1
        span = Span(self, i, "op", kind, target, tenant, nkeys)
        if pending:
            admitted_at = pending.pop("admitted_at", None)
            if admitted_at is not None:
                span.events.append(("admitted", admitted_at))
                span.t0 = min(span.t0, admitted_at)
            if pending:
                span.annotations.update(pending)
        span.event("queued")
        return span

    def begin_run(self, kind: str, target: str, nops: int = 0,
                  nkeys: int = 0) -> Span:
        span = Span(self, next(self._run_ids), "run", kind, target, "", nkeys)
        span.annotations["nops"] = nops
        return span

    def finish(self, span: Span, error: Optional[str] = None) -> None:
        if span.t1 is not None:  # already finished (double-finish guard)
            return
        span.t1 = self.clock()
        if error is not None:
            span.error = error
        self.finished += 1
        with self._ring_lock:
            self._ring.append(span)
            if len(self._ring) > self._ring_cap:
                del self._ring[: len(self._ring) - self._ring_cap]
        for sink in self._sinks:
            try:
                sink(span)
            except Exception:
                pass  # introspection must never take down the data path

    # -- inspection -------------------------------------------------------
    def ring(self) -> List[Span]:
        with self._ring_lock:
            return list(self._ring)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "sample_every": self.sample_every,
            "phase": self._phase,
            "sampled": self.sampled,
            "skipped": self.skipped,
            "finished": self.finished,
            "ring_len": len(self._ring),
        }
