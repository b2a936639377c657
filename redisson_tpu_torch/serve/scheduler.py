"""ServingLayer — the QoS front door in front of CommandExecutor
(counterpart of `redisson_tpu.serve.scheduler`).

Drop-in executor facade (same `execute_async` / `execute_sync` /
`execute_many` / `batch()` / `backend` surface the models and watchdogs
use), adding the L2 service semantics the reference implements in
`CommandAsyncService.async()` retry/timeout handling — plus the admission
tier the reference lacks:

  submission:  deadline stamp -> circuit breaker (fail fast) ->
               admission (tenant bucket + bounded queue, shed with
               retry-after) -> executor enqueue
  completion:  admission release -> breaker success/failure accounting ->
               bounded retry with exponential backoff + jitter for
               `RetryableError` faults (deadline-slack bounded) ->
               resolve the caller's future

The caller's future is an OUTER future owned by this layer: retries swap
inner attempts underneath it, so callers never observe a transient fault
that a retry absorbed. Gate failures (RejectedError / CircuitOpenError /
DeadlineExceeded) come back as *failed futures*, not raises — submission
stays non-blocking and uniform for async callers.

The replica tier's read-your-writes pins come from here: with an ack sink
installed (`enable_ack_tracking`, the ReplicaRouter) every acknowledged
write reports the journal's last seq; unset, the ack path pays one `None`
check. Module-level imports avoid
`redisson_tpu_torch.executor` (it imports serve.errors; the lock factory
and BatchCollector are pulled lazily).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import random
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch.commands import OP_TABLE
from redisson_tpu_torch.serve.admission import AdmissionController
from redisson_tpu_torch.serve.breaker import BreakerBoard
from redisson_tpu_torch.serve.errors import (CircuitOpenError, DeadlineExceeded,
                                       RejectedError, RetryableError)
from redisson_tpu_torch.serve.policy import CostModel


class _Timer:
    """Minimal timer wheel for retry backoff: one daemon thread, a heap of
    (when, seq, fn, cancel). `close()` runs each pending entry's `cancel`
    callback — a dropped retry would strand its caller's outer future
    forever, and *firing* fn at shutdown would resubmit into an executor
    that is already rejecting, turning a clean cancel into a raced error."""

    def __init__(self):
        from redisson_tpu_torch.executor import make_condition

        self._cv = make_condition("scheduler._Timer._cv")
        self._heap: List[Tuple[float, int, Callable[[], None],
                               Optional[Callable[[], None]]]] = []
        self._seq = itertools.count()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="redisson-torch-serve-timer", daemon=True)
        self._thread.start()

    def call_later(self, delay_s: float, fn: Callable[[], None],
                   cancel: Optional[Callable[[], None]] = None) -> bool:
        when = time.monotonic() + max(0.0, delay_s)
        with self._cv:
            if self._closed:
                return False
            heapq.heappush(self._heap, (when, next(self._seq), fn, cancel))
            self._cv.notify()
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._closed:
                    if not self._heap:
                        self._cv.wait()
                        continue
                    wait = self._heap[0][0] - time.monotonic()
                    if wait <= 0.0:
                        break
                    self._cv.wait(wait)
                if self._closed:
                    return
                _, _, fn, _ = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:
                pass  # a retry callback must never kill the wheel

    def close(self) -> None:
        with self._cv:
            self._closed = True
            pending = [(fn, cancel) for _, _, fn, cancel in self._heap]
            self._heap.clear()
            self._cv.notify_all()
        for fn, cancel in pending:
            # Cancel resolves the outer with CancelledError right here;
            # entries without a cancel hook fall back to firing fn so no
            # caller is ever stranded.
            try:
                (cancel or fn)()
            except Exception:
                pass


class ServingLayer:
    """Wraps a CommandExecutor with admission / deadlines / retry / breakers.

    `config` is a `config.ServeConfig`; `registry` a MetricsRegistry (falls
    back to the executor's, then a private one). The clock MUST be the
    executor's clock — deadlines are absolute times the executor's
    pre-dispatch filter compares against.
    """

    def __init__(self, executor, config=None, registry=None,
                 clock: Callable[[], float] = None):
        from redisson_tpu_torch.config import ServeConfig  # config-only, no cycle
        self._executor = executor
        self._cfg = config or ServeConfig()
        self._clock = (clock or getattr(executor, "_clock", None)
                       or time.monotonic)
        if registry is None:
            em = getattr(executor, "_metrics", None)
            registry = getattr(em, "registry", None)
        if registry is None:
            from redisson_tpu_torch.observability import MetricsRegistry
            registry = MetricsRegistry()
        self._registry = registry
        # Share the adaptive policy's cost model when one is installed, so
        # admission's delay estimates learn from real dispatches.
        self.cost_model = getattr(executor.policy, "cost_model", None) \
            if hasattr(executor, "policy") else None
        if self.cost_model is None:
            self.cost_model = CostModel()
        self._admission = AdmissionController(
            cost_model=self.cost_model,
            default_tenant_rate=self._cfg.default_tenant_rate,
            default_tenant_burst=self._cfg.default_tenant_burst,
            tenant_rates=self._cfg.tenant_rates,
            tenant_bursts=self._cfg.tenant_bursts,
            max_queue_ops=self._cfg.max_queue_ops,
            max_queue_delay_s=self._cfg.max_queue_delay_s)
        self._breakers = BreakerBoard(
            failure_threshold=self._cfg.breaker_failure_threshold,
            reset_timeout_s=self._cfg.breaker_reset_timeout_ms / 1000.0,
            half_open_probes=self._cfg.breaker_half_open_probes,
            clock=self._clock)
        self._timer = _Timer()
        # Trace manager, when the executor carries one: admission stamps
        # and retry-attempt annotations ride the sampled spans.
        self._trace = getattr(executor, "trace", None)
        # Deterministic jitter source (seeded: replayable backoff in tests).
        self._rand = random.Random(0x5EED)
        self._tls = threading.local()
        registry.gauge("serve.queued_ops",
                       lambda: self._admission.queue_stats()["queued_ops"])
        registry.gauge("serve.queued_keys",
                       lambda: self._admission.queue_stats()["queued_keys"])
        # Memory-pressure gate (memstat/pressure.py) + ledger, installed
        # by the client via attach_memstat. None = no watermark shedding.
        self._pressure = None
        self._memstat = None
        # Read-your-writes ack sink (replica/router.py), installed by
        # enable_ack_tracking. None = one check on the ack path.
        self._ack_sink = None

    def enable_ack_tracking(self, sink) -> None:
        """Replica read-your-writes: `sink.record_ack(tenant, seq)` fires
        on every successfully acked write with the journal's last committed
        seq — >= the op's own seq, since the write-ahead append preceded
        the ack, so the pin is conservative (never low)."""
        self._ack_sink = sink

    def _record_ack(self, kind: str, tenant: str) -> None:
        sink = self._ack_sink
        if sink is None:
            return
        desc = OP_TABLE.get(kind)
        if desc is None or not desc.write:
            return
        journal = getattr(self._executor, "journal", None)
        if journal is None:
            return
        try:
            sink.record_ack(tenant, journal.last_seq)
        except Exception:
            # Ack bookkeeping must never fail a completed write back to
            # its caller.
            pass

    def attach_memstat(self, ledger, pressure=None) -> None:
        """Wire the byte ledger (snapshot 'memory' block) and, when a
        high-watermark is configured, the pressure gate that sheds
        memory-growing writes with RejectedError(reason='memory') while
        reads keep flowing."""
        self._memstat = ledger
        self._pressure = pressure

    # -- tenant context -----------------------------------------------------

    @contextlib.contextmanager
    def tenant(self, name: str):
        """Ops submitted in this context (thread) default to tenant `name`."""
        prev = getattr(self._tls, "tenant", "")
        self._tls.tenant = name
        try:
            yield self
        finally:
            self._tls.tenant = prev

    def _resolve_tenant(self, tenant: Optional[str]) -> str:
        if tenant is not None:
            return tenant
        return getattr(self._tls, "tenant", "")

    def _resolve_deadline(self, now: float, deadline: Optional[float],
                          timeout_s: Optional[float]) -> Optional[float]:
        if deadline is not None:
            return deadline
        if timeout_s is not None:
            return now + timeout_s if timeout_s > 0 else None
        if self._cfg.default_timeout_ms > 0:
            return now + self._cfg.default_timeout_ms / 1000.0
        return None

    # -- executor facade ----------------------------------------------------

    @property
    def backend(self):
        return self._executor.backend

    @property
    def executor(self):
        return self._executor

    def execute_async(self, target: str, kind: str, payload: Any,
                      nkeys: int = 0, tenant: Optional[str] = None,
                      deadline: Optional[float] = None,
                      timeout_s: Optional[float] = None) -> Future:
        now = self._clock()
        tenant = self._resolve_tenant(tenant)
        deadline = self._resolve_deadline(now, deadline, timeout_s)
        outer: Future = Future()
        self._submit(outer, target, kind, payload, nkeys, tenant, deadline,
                     attempt=0, charge_tokens=True)
        return outer

    def execute_sync(self, target: str, kind: str, payload: Any,
                     nkeys: int = 0, **kw):
              return self.execute_async(target, kind, payload, nkeys, **kw).result()

    def execute_many(self, staged: Sequence[Tuple[str, str, Any, int]],
                     tenant: Optional[str] = None,
                     deadline: Optional[float] = None,
                     timeout_s: Optional[float] = None,
                     admitted_ats: Optional[Sequence[float]] = None
                     ) -> List[Future]:
        """RBatch path: ONE admission decision + one deadline for the whole
        pipeline (the batch is the unit the caller budgets for). Breakers
        fast-fail the batch on any open kind but batches are not retried
        (the reference re-sends whole pipelines; out of scope here).

        `admitted_ats` forwards the wire tier's per-command socket-read
        stamps to the executor's tracer handoff (SLOWLOG then attributes
        network + wire-window queueing to the admission stage)."""
        now = self._clock()
        tenant = self._resolve_tenant(tenant)
        deadline = self._resolve_deadline(now, deadline, timeout_s)
        if not staged:
            return []

        def _fail_all(exc: Exception) -> List[Future]:
            out = []
            for _ in staged:
                f = Future()
                f.set_exception(exc)
                out.append(f)
            return out

        if deadline is not None and deadline <= now:
            self._registry.inc("serve.deadline_expired_total", len(staged))
            return _fail_all(DeadlineExceeded(
                "batch deadline passed before submission"))
        if self._pressure is not None:
            # One admission decision per batch: any memory-growing write
            # kind above the watermark sheds the whole pipeline.
            try:
                for kind in {k for (_, k, _, _) in staged}:
                    self._pressure.check_write(kind, now)
            except RejectedError as exc:
                self._count_shed(exc)
                return _fail_all(exc)
        for kind in {k for (_, k, _, _) in staged}:
            wait = self._breakers.get(kind).peek(now)
            if wait > 0.0:
                self._registry.inc("serve.breaker_rejected_total", len(staged))
                return _fail_all(CircuitOpenError(
                    f"circuit open for '{kind}'", retry_after_s=wait))
        total_keys = sum(max(1, n) for (_, _, _, n) in staged)
        try:
            # One op's worth of queue depth, the batch's full key weight.
            self._admission.admit(tenant, None, total_keys, now)
        except RejectedError as exc:
            self._count_shed(exc)
            return _fail_all(exc)
        self._registry.inc("serve.admitted_total")
        inner = self._executor.execute_many(staged, tenant=tenant,
                                            deadline=deadline,
                                            admitted_ats=admitted_ats)
        remaining = [len(inner)]
        rlock = threading.Lock()

        def _one_done(f: Future, kind: str) -> None:
            self._account_completion(f, kind)
            if (self._ack_sink is not None and not f.cancelled()
                    and f.exception() is None):
                self._record_ack(kind, tenant)
            with rlock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                self._admission.release(total_keys)

        for (t, k, p, n), f in zip(staged, inner):
            f.add_done_callback(lambda fut, kind=k: _one_done(fut, kind))
        return inner

    def batch(self, **submit_kwargs):
        from redisson_tpu_torch.executor import BatchCollector  # lazy: cycle-safe
        return BatchCollector(self, **submit_kwargs)

    def queue_depth(self) -> int:
        return self._executor.queue_depth()

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        # Timer first: pending retries resolve their outer futures with
        # CancelledError now instead of resubmitting into an executor
        # that is about to reject everything.
        self._timer.close()
        self._executor.shutdown(wait=wait, timeout=timeout)

    # -- submission pipeline ------------------------------------------------

    def _submit(self, outer: Future, target: str, kind: str, payload: Any,
                nkeys: int, tenant: str, deadline: Optional[float],
                attempt: int, charge_tokens: bool) -> None:
        now = self._clock()
        if deadline is not None and deadline <= now:
            self._registry.inc("serve.deadline_expired_total")
            self._finish(outer, DeadlineExceeded(
                f"op {kind}@{target}: deadline passed before submission"))
            return
        if self._pressure is not None:
            # Above the high-watermark, memory-growing writes shed with a
            # retry-after; reads and reclaiming writes (DEL/FLUSHALL/
            # RENAME) always pass. Checked before the breaker so no probe
            # slot is consumed by a shed op.
            try:
                self._pressure.check_write(kind, now)
            except RejectedError as exc:
                self._count_shed(exc)
                self._finish(outer, exc)
                return
        breaker = self._breakers.get(kind)
        try:
            breaker.allow(now)
        except CircuitOpenError as exc:
            self._registry.inc("serve.breaker_rejected_total")
            self._finish(outer, exc)
            return
        try:
            self._admission.admit(tenant, kind, nkeys, now,
                                  charge_tokens=charge_tokens)
        except RejectedError as exc:
            breaker.release_probe()  # the gated probe never dispatched
            self._count_shed(exc)
            self._finish(outer, exc)
            return
        self._registry.inc("serve.admitted_total")
        trace = self._trace
        if trace is not None:
            # Same-thread handoff: execute_async enqueues synchronously, so
            # the executor-created span (if this op is sampled) inherits the
            # admission timestamp and, on retries, the attempt number.
            if attempt:
                trace.tracer.annotate_next(admitted_at=now, attempt=attempt)
            else:
                trace.tracer.annotate_next(admitted_at=now)
        inner = self._executor.execute_async(target, kind, payload, nkeys,
                                             tenant=tenant, deadline=deadline)
        inner.add_done_callback(
            lambda f: self._attempt_done(f, outer, target, kind, payload,
                                         nkeys, tenant, deadline, attempt,
                                         breaker))

    def _attempt_done(self, inner: Future, outer: Future, target: str,
                      kind: str, payload: Any, nkeys: int, tenant: str,
                      deadline: Optional[float], attempt: int,
                      breaker) -> None:
        self._admission.release(nkeys)
        now = self._clock()
        if inner.cancelled():
            breaker.release_probe()  # shutdown sweep, not a backend verdict
            if not outer.done() and outer.cancel():
                outer.set_running_or_notify_cancel()
            return
        exc = inner.exception()
        if exc is None:
            breaker.on_success(now)
            self._record_ack(kind, tenant)
            # done-callback context: inner is already resolved
            self._finish_ok(outer, inner.result())
            return
        if isinstance(exc, DeadlineExceeded):
            # Expired in queue: the backend never saw it — no breaker fault.
            breaker.release_probe()
            self._registry.inc("serve.deadline_expired_total")
            self._finish(outer, exc)
            return
        breaker.on_failure(now)
        self._registry.inc("serve.backend_faults_total")
        if isinstance(exc, RetryableError) and attempt < self._cfg.retry_attempts:
            base = self._cfg.retry_interval_ms / 1000.0
            delay = base * (2 ** attempt)
            delay *= 0.5 + self._rand.random() * 0.5  # jitter in [0.5x, 1x)
            if deadline is None or now + delay < deadline:
                self._registry.inc("serve.retries_total")
                if self._trace is not None:
                    self._trace.retry_event(kind, target, tenant,
                                            attempt + 1, delay)

                def _resubmit() -> None:
                    # Retries never re-charge tenant tokens: the op was
                    # paid for at first admission; the fault is ours.
                    self._submit(outer, target, kind, payload, nkeys,
                                 tenant, deadline, attempt + 1,
                                 charge_tokens=False)

                def _cancel_outer() -> None:
                    # Shutdown reached the wheel before this retry fired:
                    # the op is abandoned, same contract as the executor's
                    # cancellation sweep for queued ops.
                    if not outer.done() and outer.cancel():
                        outer.set_running_or_notify_cancel()

                if self._timer.call_later(delay, _resubmit,
                                          cancel=_cancel_outer):
                    return
                _cancel_outer()  # timer already closed (shutdown)
                return
        if isinstance(exc, RetryableError):
            self._registry.inc("serve.retry_exhausted_total")
        self._finish(outer, exc)

    def _account_completion(self, f: Future, kind: str) -> None:
        """Breaker bookkeeping for the no-retry (batch) path."""
        now = self._clock()
        breaker = self._breakers.get(kind)
        if f.cancelled():
            return
        exc = f.exception()
        if exc is None:
            breaker.on_success(now)
        elif isinstance(exc, DeadlineExceeded):
            self._registry.inc("serve.deadline_expired_total")
        else:
            breaker.on_failure(now)
            self._registry.inc("serve.backend_faults_total")

    def _count_shed(self, exc: RejectedError) -> None:
        self._registry.inc("serve.shed_total")
        self._registry.inc(f"serve.shed.{exc.reason}")

    @staticmethod
    def _finish(outer: Future, exc: Exception) -> None:
        if not outer.done():
            outer.set_exception(exc)

    @staticmethod
    def _finish_ok(outer: Future, value: Any) -> None:
        if not outer.done():
            outer.set_result(value)

    # -- debug endpoint -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One-stop QoS debug view: admission, breakers, policy, queues.

        `journal` surfaces the durability subsystem when the executor is
        journaled: an fsync stall on the write-ahead hook runs ON the
        dispatcher, so it shows up here as rising executor.queue_delay_s /
        queue depth — the journal stats (unsynced_runs, group_mean) say
        whether durability is the cause."""
        now = self._clock()
        pol = getattr(self._executor, "policy", None)
        journal = getattr(self._executor, "journal", None)
        backend = getattr(self._executor, "backend", None)
        sketch = getattr(backend, "sketch", backend)  # router -> device tier
        ingest_stats = getattr(sketch, "ingest_stats", None)
        return {
            "now": now,
            "admission": self._admission.snapshot(now),
            "breakers": self._breakers.snapshot(),
            "policy": pol.snapshot() if pol is not None else None,
            "executor_queue_depth": self._executor.queue_depth(),
            "pipeline": (self._executor.pipeline_stats()
                         if hasattr(self._executor, "pipeline_stats")
                         else None),
            "journal": journal.stats() if journal is not None else None,
            # Delta-ingest link/fold/merge gauges (backend.link_bytes et
            # al.): is the write path actually shipping planes, and how
            # many fused launches is each window costing?
            "ingest": ingest_stats() if callable(ingest_stats) else None,
            # Trace block: sampling counters, slowlog/monitor state, and
            # per-(kind, tenant) latency quantiles — the "where did the
            # 40 ms go" view next to the queue/journal gauges above.
            "trace": (self._trace.snapshot()
                      if self._trace is not None else None),
            # Memory block: exact live/peak device bytes plus the pressure
            # gate's watermark/forecast state (None until attach_memstat).
            "memory": (dict(
                live_bytes=self._memstat.live_bytes(),
                peak_bytes=self._memstat.peak_bytes(),
                kind_bytes=self._memstat.kind_bytes(),
                meters=self._memstat.meter_totals(),
                pressure=(self._pressure.snapshot()
                          if self._pressure is not None else None),
            ) if self._memstat is not None else None),
            "counters": {
                k: v for k, v in
                self._registry.snapshot()["counters"].items()
                if k.startswith("serve.")
            },
        }
