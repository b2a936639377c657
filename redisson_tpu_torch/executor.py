"""The command executor: the single narrow waist between the object facade
and the backend (a copy of `redisson_tpu.executor.CommandExecutor`).

Dispatch model:
  * every op is enqueued to its target object's FIFO queue (per-object
    order);
  * one dispatcher thread drains the queues, coalescing consecutive
    same-kind key-batch ops on one object into one run, and stealing the
    queue heads of other targets for GLOBAL_COALESCE kinds (one device call
    then carries keys for many sketches); kinds the backend aliases in
    COALESCE_GROUPS steal one another (one delta window mixes hll_add,
    bloom_add and bitset_set);
  * dispatch is pipelined: the dispatcher only stages a run (`backend.run`
    returns without waiting on device results), a bounded in-flight window
    (`inflight_runs`) keeps the device busy, and the backend's completer
    thread resolves the futures. A target is never admitted while its
    predecessor run holds its gate; backends that commit all observable
    state inside `run()` (`DISPATCH_TIME_STATE`) release the gate when
    `run()` returns, so only the window bounds their depth;
  * batching decisions are delegated to a policy object: the default
    `GreedyBatchPolicy` drains up to the key cap and never waits; the
    serving layer installs `serve.policy.AdaptiveBatchPolicy`, which sizes
    batches from an online cost model and holds a batch open up to
    min(deadline slack, max_linger). The cost model is fed when a run's
    results have landed (`_run_completed`, on the backend's completer after
    its event wait), never from the dispatcher's return, which on a card
    is only the staging time;
  * ops may carry an absolute `deadline` and a `tenant`; expired ops fail
    with `DeadlineExceeded` before dispatch;
  * with a trace manager attached (`set_trace`), sampled ops carry a span
    stamped along admitted -> queued -> dispatched -> journaled -> staged
    -> completed, and each run that carries one gets a run span;
  * with `ExecutorMetrics` attached, per-kind op counts, batch sizes,
    completion latency, staging time and queue delay are recorded, and
    the in-flight payload bytes feed the memstat staging meter;
  * with a write-ahead journal attached (`set_journal`), each run's
    mutating ops are appended on the dispatcher before `backend.run`, so an
    acknowledged op is always journaled and journal order is apply order;
    a journal that cannot take the record fails the run unapplied;
  * errors are classified (`fault.taxonomy.classify`) at the seam where
    they surface before a future sees them; a run that retires with a
    StateUncertainFault goes to `fault_listener` (the rebuild path), and
    `fault_guard` may reject writes at enqueue (quarantined or degraded
    targets).

Batch visibility: the per-key "changed" result of a coalesced run is taken
against the object's state at run start.

Blocking pops (`PARKED_KINDS`) park their future in the structure engine:
their run releases its gate and window slot at run() return, so the push or
`bpop_cancel` that completes them dispatches normally.

RBatch: `execute_many` enqueues a staged pipeline under one lock
acquisition; `BatchCollector` / `StagedFuture` collect, dispatch and return
results in staging order.

Locks come from `concurrency` (`make_lock` / `make_rlock` /
`make_condition`, re-exported here for the modules that import them from
this waist): plain `threading` primitives unless the lock-order witness is
armed. The op-contract witness (`contractwitness`) taps both enqueue
entry points. `Op.shard` tags an op with the logical cluster shard it was
dispatched for (mesh data plane: N logical shards share one executor, and
the ownership guard compares the tag with the slot's owner).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch import contractwitness as _cw
from redisson_tpu_torch.concurrency import (make_condition, make_lock,  # noqa: F401
                                            make_rlock)
from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.fault.taxonomy import StateUncertainFault, classify
from redisson_tpu_torch.serve.errors import DeadlineExceeded

# Op kinds that may coalesce with the previous op of the same kind+target.
COALESCABLE = {"hll_add", "bloom_add", "bitset_set", "bitset_clear",
               "bitset_get", "bloom_contains"}

# Kinds whose futures stay pending until a later op (a push serving the
# parked waiter, or bpop_cancel) or a client-side timeout fulfils them. Such
# a run releases its target gate when run() returns and never holds an
# in-flight window slot: holding either would gate the very op that fulfils
# it, and two parked pops would wedge the whole window.
PARKED_KINDS = frozenset({"bpop"})

# Pseudo-kind run inline on the dispatcher thread: the op's payload is a
# zero-arg callable, executed with no run staging concurrently. The
# dispatcher is the only thread that stages runs and appends journal
# records, so a barrier is an exact consistency cut for dispatch-time-state
# backends: the persist snapshotter cuts its snapshots through it.
BARRIER_KIND = "__barrier__"

_op_counter = itertools.count()


@dataclass
class Op:
    """One queued operation."""

    target: str  # object name ("" for global ops)
    kind: str
    payload: Any
    future: Future = field(default_factory=Future)
    index: int = field(default_factory=lambda: next(_op_counter))
    nkeys: int = 0  # key lanes this op contributes
    tenant: str = ""  # admission identity ("" = the default tenant)
    deadline: Optional[float] = None  # absolute executor-clock time
    enqueued_at: float = 0.0  # executor-clock enqueue time (queue delay)
    # Sampled trace span (trace/spans.py) or None (the unsampled majority:
    # every stamp guards on it, so disabled tracing costs one read).
    span: Any = None
    # Logical cluster shard this op was dispatched FOR (mesh data plane:
    # the guard at the backend waist compares it with the slot's owner to
    # answer MOVED as the per-stack guards do); -1 = untagged.
    shard: int = -1


_UNMETERED = frozenset({type(None), bool, int, float, str, bytes, tuple, list})


def _op_payload_nbytes(op: Op) -> int:
    """Payload byte size for the staging meter: arrays and tensors report
    nbytes (metadata, no sync); dict payloads sum their array members;
    anything else (scalars, callables) is uncounted."""
    p = op.payload
    if type(p) in _UNMETERED:  # the structure tier's scalar payloads
        return 0
    nb = getattr(p, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            return 0
    if isinstance(p, dict):
        total = 0
        for v in p.values():
            if type(v) in _UNMETERED:
                continue
            vnb = getattr(v, "nbytes", None)
            if vnb is not None:
                try:
                    total += int(vnb)
                except (TypeError, ValueError):
                    pass
        return total
    return 0


class GreedyBatchPolicy:
    """The default dispatch behaviour as a policy object: drain whatever is
    queued up to the key cap, never hold a batch open. The serving layer
    swaps in `serve.policy.AdaptiveBatchPolicy`."""

    def batch_key_limit(self, kind: str, default_cap: int) -> int:
        return default_cap

    def linger_s(self, kind: str, keys: int, cap: int,
                 run: Sequence[Op], now: float) -> float:
        return 0.0

    def observe(self, kind: str, nkeys: int, seconds: float) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"policy": "greedy"}


class _InflightRun:
    """One dispatched run, alive until its last op future resolves."""

    __slots__ = ("kind", "target", "targets", "is_global", "nops", "nkeys",
                 "t0", "queue_delay_s", "stage_s", "pending", "failed",
                 "op_failed", "overlapped", "depth", "gates_held", "lock",
                 "ops", "fault_exc", "run_span", "staged_bytes")

    def __init__(self, kind: str, target: str, targets: frozenset,
                 is_global: bool):
        self.kind = kind
        self.target = target
        self.targets = targets
        self.is_global = is_global
        self.nops = 0
        self.nkeys = 0
        self.t0 = 0.0  # executor-clock dispatch time (the watchdog's age)
        self.queue_delay_s = 0.0
        self.stage_s = None
        self.pending = 0
        self.failed = False  # staging (journal / backend.run) raised
        self.op_failed = False  # some op future resolved with an error
        self.overlapped = False
        self.depth = 1
        self.gates_held = True
        self.lock = make_lock("executor._InflightRun.lock")
        self.ops: Sequence[Op] = ()  # live ops (watchdog trip)
        self.fault_exc = None  # first StateUncertainFault among the ops
        self.run_span = None  # parent trace span of this run
        self.staged_bytes = 0  # payload bytes charged to the staging meter


class CommandExecutor:
    """The async executor around a backend's op handlers.

    backend must expose `run(kind, target, ops: List[Op]) -> None`,
    completing each op's future (inline or later, from another thread).
    """

    def __init__(self, backend, max_batch_keys: int = 1 << 21, metrics=None,
                 policy=None, clock: Callable[[], float] = None,
                 inflight_runs: int = 2, trace=None):
        self._backend = backend
        # TraceManager or None; it must share this executor's clock, so
        # span stamps and deadlines live on one timeline.
        self._trace = trace
        self._max_batch_keys = max_batch_keys
        self._metrics = metrics  # ExecutorMetrics or None
        self._policy = policy or GreedyBatchPolicy()
        self._observe_dispatch = getattr(self._policy, "observe_dispatch", None)
        self._clock = clock or time.monotonic
        self._global_kinds = frozenset(getattr(backend, "GLOBAL_COALESCE", ()))
        # Kinds that share one gate and steal group (the delta window mixes
        # hll_add, bloom_add and bitset_set runs of many targets).
        self._coalesce_groups = dict(getattr(backend, "COALESCE_GROUPS", {}))
        self._window = max(1, int(inflight_runs))
        self._eager_release = bool(getattr(backend, "DISPATCH_TIME_STATE", False))
        self._inflight: set = set()  # _InflightRun tokens
        self._inflight_targets: set = set()  # gated object names
        self._inflight_kinds: set = set()  # gated GLOBAL_COALESCE kinds
        self._staging_bytes = 0  # in-flight payload bytes (memstat meter)
        self._runs_completed = 0
        self._runs_overlapped = 0
        self._lock = make_lock("executor.CommandExecutor._lock")
        self._cv = make_condition("executor.CommandExecutor._lock", self._lock)
        self._queues: Dict[str, deque] = {}
        self._ready: deque = deque()  # round-robin of names with work
        self._runs_dispatched = 0
        self._shutdown = False
        # Write-ahead op journal (persist/journal.py) or None; installed by
        # the persistence manager after recovery replay (set_journal).
        self._journal = None
        # Fault subsystem hooks (fault/manager.py installs; None = off):
        # fault_guard(kind, target) -> Optional[Exception] runs at enqueue
        # (quarantined/degraded write rejection); fault_listener(kind,
        # targets, fault) fires when a run retires with StateUncertainFault
        # (the rebuild coordinator's trigger).
        self.fault_guard = None
        self.fault_listener = None
        self._thread = threading.Thread(
            target=self._loop, name="redisson-torch-dispatcher", daemon=True)
        self._thread.start()

    @property
    def backend(self):
        return self._backend

    @property
    def policy(self):
        """The live batch policy (greedy unless the serving layer installed
        an adaptive one)."""
        return self._policy

    @property
    def journal(self):
        """The attached write-ahead journal, or None (journaling off)."""
        return self._journal

    @property
    def trace(self):
        """The attached TraceManager, or None (tracing off)."""
        return self._trace

    def set_trace(self, trace) -> None:
        """Attach/detach the trace manager; ordered with enqueue so no op
        is half-stamped across the switch."""
        with self._cv:
            self._trace = trace

    def set_journal(self, journal) -> None:
        """Attach/detach the write-ahead journal. The persistence manager
        installs it after recovery replay (replayed ops must not
        re-journal); lock-ordered with dispatch so no run straddles the
        transition."""
        with self._cv:
            self._journal = journal

    # -- submission ---------------------------------------------------------

    def execute_async(self, target: str, kind: str, payload: Any,
                      nkeys: int = 0, tenant: str = "",
                      deadline: Optional[float] = None,
                      shard: int = -1) -> Future:
        op = Op(target=target, kind=kind, payload=payload, nkeys=nkeys,
                tenant=tenant, deadline=deadline, shard=shard)
        # Contract-witness tap at the single enqueue funnel: every real op
        # kind passes here, whatever the surface (facade, wire window,
        # journal replay, replica stream, geo apply).
        if _cw.RECORD is not None and kind != BARRIER_KIND:
            _cw.RECORD(kind)
        with self._cv:
            self._enqueue_locked(op)
            self._cv.notify()
        return op.future

    def execute_many(self, staged: Sequence[Tuple[str, str, Any, int]],
                     tenant: str = "", deadline: Optional[float] = None,
                     admitted_ats: Optional[Sequence[float]] = None,
                     shard: int = -1) -> List[Future]:
        """Enqueue a pre-staged op list under one lock acquisition (the
        RBatch dispatch path): per-target FIFO order follows list order,
        and the whole batch shares one tenant and deadline. `admitted_ats`
        (parallel to `staged`) carries upstream admission stamps into the
        tracer's same-thread handoff."""
        ops = [Op(target=t, kind=k, payload=p, nkeys=n, tenant=tenant,
                  deadline=deadline, shard=shard) for (t, k, p, n) in staged]
        if _cw.RECORD is not None:
            for op in ops:
                if op.kind != BARRIER_KIND:
                    _cw.RECORD(op.kind)
        trace = self._trace
        annotate = (trace.tracer.annotate_next
                    if trace is not None and admitted_ats is not None
                    else None)
        with self._cv:
            for i, op in enumerate(ops):
                if annotate is not None and op.kind != BARRIER_KIND:
                    annotate(admitted_at=admitted_ats[i])
                self._enqueue_locked(op)
            self._cv.notify()
        return [op.future for op in ops]

    def _enqueue_locked(self, op: Op) -> None:
        if self._shutdown:
            # Drain-then-reject: a submission racing shutdown gets a failed
            # future rather than an exception in the submitting thread.
            op.future.set_exception(RuntimeError("executor is shut down"))
            return
        guard = self.fault_guard
        if guard is not None:
            # Quarantined/degraded target rejection (set lookups only: the
            # guard runs under the executor lock).
            exc = guard(op.kind, op.target)
            if exc is not None:
                op.future.set_exception(exc)
                return
        q = self._queues.get(op.target)
        if q is None:
            q = self._queues[op.target] = deque()
        if not q:
            self._ready.append(op.target)
        op.enqueued_at = self._clock()
        trace = self._trace
        if trace is not None and op.kind != BARRIER_KIND:
            # Sampling decision + the "queued" stamp; None for the
            # unsampled majority.
            op.span = trace.begin_op(op.kind, op.target, op.tenant, op.nkeys)
        q.append(op)

    def execute_sync(self, target: str, kind: str, payload: Any,
                     nkeys: int = 0, shard: int = -1):
        return self.execute_async(target, kind, payload, nkeys,
                                  shard=shard).result()

    def execute_barrier(self, fn: Callable[[], Any], target: str = "") -> Future:
        """Run `fn` inline on the dispatcher thread, ordered like an op on
        `target`; the future resolves with fn's return value."""
        return self.execute_async(target, BARRIER_KIND, fn)

    def queue_depth(self) -> int:
        """Total ops waiting across all object queues (locked snapshot)."""
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def has_ready(self) -> bool:
        """True while some target has queued work: more dispatch is
        imminent (the journal's group-commit hint). Racy by design: a stale
        read costs at most one extra fsync or one linger."""
        return bool(self._ready)

    def runs_dispatched(self) -> int:
        """Runs handed to the backend so far (barriers excluded): how many
        runs a batch took is the difference across its execute()."""
        with self._lock:
            return self._runs_dispatched

    # -- dispatcher ---------------------------------------------------------

    def _loop(self):
        try:
            while True:
                with self._cv:
                    while True:
                        if self._shutdown and not self._ready:
                            return
                        picked = None
                        if self._ready and len(self._inflight) < self._window:
                            picked = self._pick_target_locked()
                        if picked is not None:
                            break
                        # Woken by an enqueue, a run completion freeing a
                        # gate or a window slot, or shutdown().
                        self._cv.wait()
                    kind, target, run = self._collect_run_locked(picked)
                    token = self._admit_locked(kind, target, run)
                self._dispatch(token, run)
        finally:
            # The dispatcher is the only thread that resolves queued ops:
            # whatever is still queued when it exits is cancelled, so no
            # waiter blocks forever.
            self._cancel_remaining()

    def _pick_target_locked(self) -> Optional[str]:
        """First round-robin target whose queue head is admissible (no
        in-flight predecessor holds its target or kind gate)."""
        for target in self._ready:
            if target in self._inflight_targets:
                continue
            head_kind = self._queues[target][0].kind
            if (head_kind in self._global_kinds
                    and self._group_of(head_kind) in self._inflight_kinds):
                continue
            self._ready.remove(target)
            return target
        return None

    def _group_of(self, kind: str) -> str:
        """Gate and steal key of a global kind: its COALESCE_GROUPS alias,
        or the kind itself."""
        return self._coalesce_groups.get(kind, kind)

    def _admit_locked(self, kind: str, target: str,
                      run: List[Op]) -> _InflightRun:
        is_global = kind in self._global_kinds
        targets = frozenset({op.target for op in run} | {target})
        token = _InflightRun(kind, target, targets, is_global)
        token.overlapped = bool(self._inflight)
        self._inflight.add(token)
        token.depth = len(self._inflight)
        self._inflight_targets |= targets
        if is_global:
            self._inflight_kinds.add(self._group_of(kind))
        return token

    def _collect_run_locked(self, target: str) -> Tuple[str, str, List[Op]]:
        """Pop the next run: per-target coalesce up to the policy's key cap
        (with its linger), then the cross-target steal for global kinds."""
        q = self._queues[target]
        run = [q.popleft()]
        kind = run[0].kind
        cap = min(self._max_batch_keys,
                  max(run[0].nkeys, int(self._policy.batch_key_limit(
                      kind, self._max_batch_keys))))
        keys = run[0].nkeys
        if kind in COALESCABLE:
            keys = self._drain_same_kind(q, kind, run, keys, cap)
            # Adaptive linger: the policy may hold the batch open for late
            # arrivals. cv.wait releases the lock, so submitters keep
            # appending; every wake re-drains. Greedy returns 0.0.
            while not self._shutdown and keys < cap:
                wait_s = self._policy.linger_s(kind, keys, cap, run,
                                               self._clock())
                if wait_s <= 0.0:
                    break
                self._cv.wait(wait_s)
                keys = self._drain_same_kind(q, kind, run, keys, cap)
        if kind in self._global_kinds:
            keys = sum(op.nkeys for op in run)
            # Steal the heads of other targets in the same group. Mutate
            # _ready/_queues only after the scan: removing entries while
            # walking the round-robin drops targets.
            group = self._group_of(kind)
            emptied: List[str] = []
            for other in list(self._ready):
                if keys >= cap:
                    break
                if other == target or other in self._inflight_targets:
                    # A second in-flight run for a target would break its
                    # completion order.
                    continue
                oq = self._queues[other]
                while (oq and oq[0].kind in self._global_kinds
                       and self._group_of(oq[0].kind) == group
                       and keys + oq[0].nkeys <= cap):
                    op = oq.popleft()
                    keys += op.nkeys
                    if op.span is not None:
                        op.span.event("stolen")
                    run.append(op)
                if not oq:
                    emptied.append(other)
            for other in emptied:
                self._ready.remove(other)
                del self._queues[other]
        # A linger wait releases the lock, so a submitter that found the
        # drained queue empty re-added `target` to the round-robin, maybe
        # more than once: strip every copy, then re-add one iff work
        # remains.
        while target in self._ready:
            self._ready.remove(target)
        if q:
            self._ready.append(target)
        else:
            del self._queues[target]
        return kind, target, run

    @staticmethod
    def _drain_same_kind(q: deque, kind: str, run: List[Op], keys: int,
                         cap: int) -> int:
        while q and q[0].kind == kind and keys + q[0].nkeys <= cap:
            op = q.popleft()
            keys += op.nkeys
            run.append(op)
        return keys

    def _dispatch(self, token: _InflightRun, run: List[Op]) -> None:
        """Stage one run: deadline-filter, call backend.run (non-blocking
        for device backends), and let completion callbacks retire it."""
        m = self._metrics
        kind, target = token.kind, token.target
        now = self._clock()
        live: List[Op] = []
        n_expired = 0
        for op in run:
            if op.deadline is not None and op.deadline <= now:
                n_expired += 1
                if not op.future.done():
                    op.future.set_exception(DeadlineExceeded(
                        f"op {kind}@{op.target or target}: "
                        f"deadline passed {now - op.deadline:.6f}s before "
                        "dispatch"))
                if op.span is not None:
                    # No done-callback is armed for an expired op: finish
                    # its span here.
                    op.span.event("expired", now)
                    op.span.finish(error="DeadlineExceeded")
            else:
                live.append(op)
        if n_expired and m:
            m.record_expired(kind, n_expired)
        if not live:
            self._retire(token, completed=False)
            return
        if kind == BARRIER_KIND:
            for op in live:
                try:
                    op.future.set_result(op.payload())
                except Exception as exc:  # noqa: BLE001 — resolve, never hang
                    # Barrier callables (snapshot cuts, state swaps) can
                    # fail on device/IO errors too: classify them.
                    op.future.set_exception(classify(exc, seam="snapshot_io"))
            self._retire(token, completed=False)
            return
        token.ops = live
        token.nops = len(live)
        # One pass over the ops: keys, the staging meter's bytes (memstat:
        # payload bytes held while this run is in flight, released at
        # retire; nbytes is metadata, no device sync), the oldest enqueue
        # and the sampled spans riding this run (usually none; the run span
        # links them to the run they shared).
        nkeys = staged = 0
        oldest = live[0].enqueued_at
        spans = []
        for op in live:
            nkeys += op.nkeys
            staged += _op_payload_nbytes(op)
            if op.enqueued_at < oldest:
                oldest = op.enqueued_at
            if op.span is not None:
                spans.append(op.span)
        token.nkeys = nkeys
        with self._cv:
            self._runs_dispatched += 1
            if staged:
                token.staged_bytes = staged
                self._staging_bytes += staged
        t0 = token.t0 = self._clock()
        token.queue_delay_s = t0 - oldest
        token.pending = len(live)
        if spans and self._trace is not None:
            run_span = token.run_span = self._trace.begin_run(
                kind, target, len(live), token.nkeys)
            for s in spans:
                s.run_id = run_span.span_id
                s.event("dispatched", t0)
        parked = kind in PARKED_KINDS
        if not parked:
            # Arm completion accounting before the backend sees the ops: a
            # synchronous backend resolves futures inside run(). Parked
            # kinds skip it: a later op completes them, and their wait time
            # must feed neither the window nor the cost model.
            for op in live:
                op.future.add_done_callback(
                    lambda fut, token=token, op=op: self._op_done(
                        token, fut, op))
        journal = self._journal
        if journal is not None and not parked:
            # Write-ahead: the record reaches the journal before the backend
            # commits state, so an acknowledged op is always journaled (read
            # kinds are a no-op inside append_run). `defer` tells the
            # "always" policy more dispatch is queued, so one fsync covers
            # the in-flight window.
            try:
                journal.append_run(kind, live, defer=self.has_ready())
                if spans:
                    t_j = self._clock()
                    for s in spans:
                        s.event("journaled", t_j)
                    if token.run_span is not None:
                        token.run_span.event("journaled", t_j)
            except Exception as exc:  # noqa: BLE001 — fail the run unapplied
                # Applying an unjournaled mutation would break the recovery
                # contract; nothing has committed, so the fault is retryable.
                exc = classify(exc, seam="journal_fsync")
                token.failed = True
                if m:
                    m.record_error(kind)
                for s in spans:
                    # Annotate before the futures resolve: the done-callback
                    # finishes the span and the slowlog entry must carry
                    # the seam.
                    s.annotate(fault=type(exc).__name__,
                               seam=getattr(exc, "seam", "journal_fsync"))
                for op in live:
                    if not op.future.done():
                        op.future.set_exception(exc)
                return
        try:
            fault_inject.fire("kernel_launch", kind=kind, target=target)
            self._backend.run(kind, target, live)
            t_staged = self._clock()
            token.stage_s = t_staged - t0
            if spans:
                # A synchronous backend resolves futures inside run(): such
                # spans are already finished and keep run() in their device
                # stage.
                for s in spans:
                    if s.t1 is None:
                        s.event("staged", t_staged)
                if token.run_span is not None:
                    token.run_span.event("staged", t_staged)
            od = self._observe_dispatch
            if od is not None:
                # Staging time only (host prep + launches), never service
                # time: the cost model's service EWMA feeds from completion.
                od(kind, token.nkeys, token.stage_s)
            if self._eager_release and not parked:
                self._release_gates(token)
        except Exception as exc:  # complete, never kill the loop
            # The staging boundary: H2D copies, kernel launches and the
            # injected kernel_launch seam surface here. classify() decides
            # between retryable (nothing committed) and uncertain (the
            # rebuild path re-materializes; _op_done notes it).
            exc = classify(exc, seam="kernel_launch")
            token.failed = True
            token.stage_s = self._clock() - t0
            if m:
                m.record_error(kind)
            for s in spans:
                if s.t1 is None:
                    s.annotate(fault=type(exc).__name__,
                               seam=getattr(exc, "seam", "kernel_launch"))
            for op in live:
                if not op.future.done():
                    op.future.set_exception(exc)
        if parked:
            # The waiter is parked (or was served inline): drop the gates
            # and the window slot now, so the op that fulfils it can
            # dispatch against this same target. Its span closes at park.
            for s in spans:
                if s.t1 is None:
                    s.annotate(parked=True)
                    s.finish()
            self._retire(token, completed=False)

    # -- completion path ----------------------------------------------------

    def _op_done(self, token: _InflightRun, fut: Future,
                 op: Optional[Op] = None) -> None:
        """Done-callback of each live op future; runs on the thread that
        resolves it (the backend's completer, or the dispatcher for a
        synchronous backend)."""
        exc = None if fut.cancelled() else fut.exception()
        if op is not None and op.span is not None and op.span.t1 is None:
            span = op.span
            span.event("completed")
            err = None
            if exc is not None:
                err = type(exc).__name__
                seam = getattr(exc, "seam", None)
                if seam is not None:
                    span.annotations.setdefault("seam", seam)
            span.finish(error=err)
        with token.lock:
            if exc is not None:
                token.op_failed = True
                if (token.fault_exc is None
                        and isinstance(exc, StateUncertainFault)):
                    # State-uncertain retirement (device loss, a watchdog
                    # trip, a failed readback): the run's targets go to the
                    # rebuild listener once the run retires.
                    token.fault_exc = exc
            token.pending -= 1
            if token.pending > 0:
                return
        self._run_completed(token)

    def _run_completed(self, token: _InflightRun) -> None:
        """The run's results have landed (on a card, after the completer's
        event wait): service time is observable here, so the cost model and
        the latency metrics feed from this point, never from the
        dispatcher's return."""
        dt = self._clock() - token.t0
        if token.op_failed and not token.failed and self._metrics:
            self._metrics.record_error(token.kind)
        if not token.failed:
            self._policy.observe(token.kind, token.nkeys, dt)
            if self._metrics:
                self._metrics.record_batch(
                    token.kind, token.nops, token.nkeys, dt,
                    queue_delay_s=token.queue_delay_s,
                    cap=self._max_batch_keys, stage_s=token.stage_s)
        self._retire(token, completed=True)
        listener = self.fault_listener
        if listener is not None and token.fault_exc is not None:
            try:
                listener(token.kind, token.targets, token.fault_exc)
            except Exception:  # noqa: BLE001
                # The listener is best-effort: its failure must not poison
                # the completion path that just resolved the futures.
                pass

    def _release_gates_locked(self, token: _InflightRun) -> None:
        if not token.gates_held:
            return
        token.gates_held = False
        self._inflight_targets.difference_update(token.targets)
        if token.is_global:
            self._inflight_kinds.discard(self._group_of(token.kind))

    def _release_gates(self, token: _InflightRun) -> None:
        with self._cv:
            self._release_gates_locked(token)
            self._cv.notify_all()

    def _retire(self, token: _InflightRun, completed: bool) -> None:
        run_span = token.run_span
        if run_span is not None:
            token.run_span = None
            run_span.event("completed")
            run_span.finish(error=type(token.fault_exc).__name__
                            if token.fault_exc is not None else None)
        with self._cv:
            self._release_gates_locked(token)
            self._inflight.discard(token)
            self._staging_bytes -= token.staged_bytes
            token.staged_bytes = 0
            if completed:
                self._runs_completed += 1
                if token.overlapped:
                    self._runs_overlapped += 1
            self._cv.notify_all()
        if completed and self._metrics:
            self._metrics.record_run(token.depth, token.overlapped)

    def pipeline_stats(self) -> Dict[str, Any]:
        """Live pipeline counters; overlap_ratio is the share of completed
        runs dispatched while another run was still in flight."""
        with self._lock:
            done = self._runs_completed
            return {
                "window": self._window,
                "eager_release": self._eager_release,
                "inflight": len(self._inflight),
                "runs_completed": done,
                "runs_overlapped": self._runs_overlapped,
                "overlap_ratio": (self._runs_overlapped / done) if done else 0.0,
                "staging_bytes": self._staging_bytes,
            }

    def staging_bytes(self) -> int:
        """In-flight payload bytes (the memstat 'staging' meter)."""
        with self._lock:
            return self._staging_bytes

    def is_alive(self) -> bool:
        """True while the dispatcher thread runs and shutdown has not
        begun (racy by one probe round at most)."""
        return not self._shutdown and self._thread.is_alive()

    # -- fault-subsystem surface -------------------------------------------

    def fail_inflight(self, token: _InflightRun, exc: BaseException) -> int:
        """Resolve a stuck run's still-pending futures with `exc` (the
        watchdog's trip action). Completion flows through the normal
        done-callback path, so the run retires and its gates release; a
        late device completion finds the futures done and is dropped by
        the backend's `future.done()` guards. Returns how many futures
        this call resolved."""
        failed = 0
        for op in token.ops:
            if op.future.done():
                continue
            try:
                op.future.set_exception(exc)
                failed += 1
            except Exception:  # noqa: BLE001
                # InvalidStateError: the completer resolved this future
                # between the done() check and here.
                pass
        return failed

    def sweep_queued(self, targets, exc_factory) -> int:
        """Complete every QUEUED (undispatched) op for `targets` with
        `exc_factory(op)`: the rebuild path cancels dependents of a
        quarantined target this way (never dispatched, so a retryable
        rejection is safe). Returns the number of swept ops."""
        with self._cv:
            swept: List[Op] = []
            for t in set(targets):
                q = self._queues.pop(t, None)
                if not q:
                    continue
                swept.extend(q)
                if t in self._ready:
                    self._ready.remove(t)
        for op in swept:
            if not op.future.done():
                op.future.set_exception(exc_factory(op))
            if op.span is not None and op.span.t1 is None:
                op.span.annotate(swept=True)
                op.span.finish(error="swept")
        return len(swept)

    def _cancel_remaining(self) -> None:
        with self._cv:
            pending = [op for q in self._queues.values() for op in q]
            self._queues.clear()
            self._ready.clear()
        cancelled = 0
        for op in pending:
            if op.future.cancel():
                op.future.set_running_or_notify_cancel()
                cancelled += 1
            if op.span is not None and op.span.t1 is None:
                op.span.finish(error="CancelledError")
        if cancelled and self._metrics:
            self._metrics.record_cancelled(cancelled)

    def shutdown(self, wait: bool = True, timeout: float = 30.0):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if not wait:
            return
        t_end = time.monotonic() + timeout
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # Dispatcher wedged inside backend.run: cancel what is queued
            # behind it so its waiters do not hang.
            self._cancel_remaining()
            return
        # Queues drained; drain the in-flight window too, so a clean
        # shutdown implies every dispatched run's futures resolved.
        with self._cv:
            while self._inflight:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)

    # -- batch facade -------------------------------------------------------

    def batch(self, **submit_kwargs) -> "BatchCollector":
        return BatchCollector(self, **submit_kwargs)


class BatchCollector:
    """RBatch engine: collect ops without dispatching, then execute.

    The collect phase does no I/O; execute() submits the staged ops in index
    order through `execute_many` (one lock acquisition, so the dispatcher
    sees the whole pipeline at once and coalesces it as it would any queued
    ops) and gathers results in the same order. `submit_kwargs` (a
    `deadline`) apply to the whole batch.
    """

    def __init__(self, executor, **submit_kwargs):
        self._executor = executor
        self._submit_kwargs = submit_kwargs
        self._staged: List[tuple] = []
        self._futures: List["StagedFuture"] = []
        self._executed = False

    def add(self, target: str, kind: str, payload: Any,
            nkeys: int = 0) -> "StagedFuture":
        """Stage an op; returns its placeholder future (resolved at
        execute)."""
        if self._executed:
            raise RuntimeError("batch already executed")
        self._staged.append((target, kind, payload, nkeys))
        f = StagedFuture()
        self._futures.append(f)
        return f

    def _dispatch(self) -> List[Future]:
        if self._executed:
            raise RuntimeError("batch already executed")
        self._executed = True
        for f in self._futures:
            f._dispatched = True
        inner = self._executor.execute_many(self._staged, **self._submit_kwargs)
        for staged, src in zip(self._futures, inner):
            src.add_done_callback(staged._resolve_from)
        return inner

    def execute(self) -> List[Any]:
        """Dispatch all staged ops; decoded results in staging order (the
        decode chains registered via `map_future` fire off the staged
        futures). The first failure raises."""
        inner = self._dispatch()
        for f in inner:
            f.result()
        return [f.outermost().result() for f in self._futures]

    def execute_async(self) -> List[Future]:
        """Dispatch staged ops; returns the decoded per-op futures in
        order."""
        self._dispatch()
        return [f.outermost() for f in self._futures]


class StagedFuture(Future):
    """RBatch placeholder: a real Future resolved only at execute() time.

    result() before the batch is dispatched raises instead of deadlocking;
    after dispatch it blocks normally until the dispatcher resolves it.
    Decode wrappers chained by `map_future` register themselves via
    `_note_mapped` so the batch can return decoded values.
    """

    def __init__(self):
        super().__init__()
        self._dispatched = False
        self._mapped: Future = self

    def result(self, timeout=None):
        if not self._dispatched and not self.done():
            raise RuntimeError("batch not executed yet; call RBatch.execute()")
        return super().result(timeout)

    def _resolve_from(self, src: Future) -> None:
        if src.cancelled():
            self.cancel()
            self.set_running_or_notify_cancel()
            return
        exc = src.exception()
        if exc is not None:
            self.set_exception(exc)
        else:
            self.set_result(src.result())

    def _note_mapped(self, fut: Future) -> None:
        self._mapped = fut

    def outermost(self) -> Future:
        """The outermost decode wrapper (or self if none was chained)."""
        return self._mapped
