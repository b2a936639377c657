"""The command executor: the single narrow waist between the object facade
and the backend (a copy of `redisson_tpu.executor.CommandExecutor`).

Dispatch model:
  * every op is enqueued to its target object's FIFO queue (per-object
    order);
  * one dispatcher thread drains the queues, coalescing consecutive
    same-kind key-batch ops on one object into one run, and stealing the
    queue heads of other targets for GLOBAL_COALESCE kinds (one device call
    then carries keys for many sketches);
  * dispatch is pipelined: the dispatcher only stages a run (`backend.run`
    returns without waiting on device results), a bounded in-flight window
    (`inflight_runs`) keeps the device busy, and the backend's completer
    thread resolves the futures. A target is never admitted while its
    predecessor run holds its gate; backends that commit all observable
    state inside `run()` (`DISPATCH_TIME_STATE`) release the gate when
    `run()` returns, so only the window bounds their depth;
  * ops may carry an absolute `deadline`; expired ops fail with
    `DeadlineExceeded` before dispatch.

Batch visibility: the per-key "changed" result of a coalesced run is taken
against the object's state at run start.

Journaling, tracing, metrics, the serving layer's policies, fault injection
and the contract witness arrive with their own slices.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# Op kinds that may coalesce with the previous op of the same kind+target.
COALESCABLE = {"hll_add", "bloom_add", "bitset_set", "bitset_clear",
               "bitset_get", "bloom_contains"}

# Pseudo-kind run inline on the dispatcher thread: the op's payload is a
# zero-arg callable, executed with no run staging concurrently (an exact
# consistency cut for dispatch-time-state backends).
BARRIER_KIND = "__barrier__"

_op_counter = itertools.count()


def make_lock(site: str):
    """A plain lock; `site` names it for the lock-order witness, which
    arrives with the concurrency tooling."""
    return threading.Lock()


def make_condition(site: str, lock=None):
    return threading.Condition(lock)


class DeadlineExceeded(Exception):
    """The op's deadline passed before device dispatch (it never reached
    the backend, so retrying it is always safe)."""


@dataclass
class Op:
    """One queued operation."""

    target: str  # object name ("" for global ops)
    kind: str
    payload: Any
    future: Future = field(default_factory=Future)
    index: int = field(default_factory=lambda: next(_op_counter))
    nkeys: int = 0  # key lanes this op contributes
    deadline: Optional[float] = None  # absolute executor-clock time


class _InflightRun:
    """One dispatched run, alive until its last op future resolves."""

    __slots__ = ("kind", "target", "targets", "is_global", "pending",
                 "gates_held", "lock")

    def __init__(self, kind: str, target: str, targets: frozenset,
                 is_global: bool):
        self.kind = kind
        self.target = target
        self.targets = targets
        self.is_global = is_global
        self.pending = 0
        self.gates_held = True
        self.lock = make_lock("executor._InflightRun.lock")


class CommandExecutor:
    """The async executor around a backend's op handlers.

    backend must expose `run(kind, target, ops: List[Op]) -> None`,
    completing each op's future (inline or later, from another thread).
    """

    def __init__(self, backend, max_batch_keys: int = 1 << 21,
                 clock: Callable[[], float] = None, inflight_runs: int = 2):
        self._backend = backend
        self._max_batch_keys = max_batch_keys
        self._clock = clock or time.monotonic
        self._global_kinds = frozenset(getattr(backend, "GLOBAL_COALESCE", ()))
        self._window = max(1, int(inflight_runs))
        self._eager_release = bool(getattr(backend, "DISPATCH_TIME_STATE", False))
        self._inflight: set = set()  # _InflightRun tokens
        self._inflight_targets: set = set()  # gated object names
        self._inflight_kinds: set = set()  # gated GLOBAL_COALESCE kinds
        self._lock = make_lock("executor.CommandExecutor._lock")
        self._cv = make_condition("executor.CommandExecutor._lock", self._lock)
        self._queues: Dict[str, deque] = {}
        self._ready: deque = deque()  # round-robin of names with work
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._loop, name="redisson-torch-dispatcher", daemon=True)
        self._thread.start()

    @property
    def backend(self):
        return self._backend

    # -- submission ---------------------------------------------------------

    def execute_async(self, target: str, kind: str, payload: Any,
                      nkeys: int = 0,
                      deadline: Optional[float] = None) -> Future:
        op = Op(target=target, kind=kind, payload=payload, nkeys=nkeys,
                deadline=deadline)
        with self._cv:
            self._enqueue_locked(op)
            self._cv.notify()
        return op.future

    def _enqueue_locked(self, op: Op) -> None:
        if self._shutdown:
            # Drain-then-reject: a submission racing shutdown gets a failed
            # future rather than an exception in the submitting thread.
            op.future.set_exception(RuntimeError("executor is shut down"))
            return
        q = self._queues.get(op.target)
        if q is None:
            q = self._queues[op.target] = deque()
        if not q:
            self._ready.append(op.target)
        q.append(op)

    def execute_sync(self, target: str, kind: str, payload: Any,
                     nkeys: int = 0):
        return self.execute_async(target, kind, payload, nkeys).result()

    def execute_barrier(self, fn: Callable[[], Any], target: str = "") -> Future:
        """Run `fn` inline on the dispatcher thread, ordered like an op on
        `target`; the future resolves with fn's return value."""
        return self.execute_async(target, BARRIER_KIND, fn)

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
            if head_kind in self._global_kinds and head_kind in self._inflight_kinds:
                continue
            self._ready.remove(target)
            return target
        return None

    def _admit_locked(self, kind: str, target: str,
                      run: List[Op]) -> _InflightRun:
        is_global = kind in self._global_kinds
        targets = frozenset({op.target for op in run} | {target})
        token = _InflightRun(kind, target, targets, is_global)
        self._inflight.add(token)
        self._inflight_targets |= targets
        if is_global:
            self._inflight_kinds.add(kind)
        return token

    def _collect_run_locked(self, target: str) -> Tuple[str, str, List[Op]]:
        """Pop the next run: per-target coalesce up to the key cap, then the
        cross-target steal for global kinds."""
        q = self._queues[target]
        run = [q.popleft()]
        kind = run[0].kind
        cap = max(run[0].nkeys, self._max_batch_keys)
        keys = run[0].nkeys
        if kind in COALESCABLE:
            keys = self._drain_same_kind(q, kind, run, keys, cap)
        if kind in self._global_kinds:
            # Mutate _ready/_queues only after the scan: removing entries
            # while walking the round-robin drops targets.
            emptied: List[str] = []
            for other in list(self._ready):
                if keys >= cap:
                    break
                if other == target or other in self._inflight_targets:
                    # A second in-flight run for a target would break its
                    # completion order.
                    continue
                oq = self._queues[other]
                while oq and oq[0].kind == kind and keys + oq[0].nkeys <= cap:
                    op = oq.popleft()
                    keys += op.nkeys
                    run.append(op)
                if not oq:
                    emptied.append(other)
            for other in emptied:
                self._ready.remove(other)
                del self._queues[other]
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
        now = self._clock()
        live: List[Op] = []
        for op in run:
            if op.deadline is not None and op.deadline <= now:
                if not op.future.done():
                    op.future.set_exception(DeadlineExceeded(
                        f"op {token.kind}@{op.target or token.target}: "
                        f"deadline passed {now - op.deadline:.6f}s before "
                        "dispatch"))
            else:
                live.append(op)
        if not live:
            self._retire(token)
            return
        if token.kind == BARRIER_KIND:
            for op in live:
                try:
                    op.future.set_result(op.payload())
                except Exception as exc:  # noqa: BLE001 — resolve, never hang
                    op.future.set_exception(exc)
            self._retire(token)
            return
        token.pending = len(live)
        # Arm completion accounting before the backend sees the ops: a
        # synchronous backend resolves futures inside run().
        for op in live:
            op.future.add_done_callback(
                lambda fut, token=token: self._op_done(token))
        try:
            self._backend.run(token.kind, token.target, live)
            if self._eager_release:
                self._release_gates(token)
        except Exception as exc:  # complete, never kill the loop
            for op in live:
                if not op.future.done():
                    op.future.set_exception(exc)

    # -- completion path ----------------------------------------------------

    def _op_done(self, token: _InflightRun) -> None:
        with token.lock:
            token.pending -= 1
            if token.pending > 0:
                return
        self._retire(token)

    def _release_gates_locked(self, token: _InflightRun) -> None:
        if not token.gates_held:
            return
        token.gates_held = False
        self._inflight_targets.difference_update(token.targets)
        if token.is_global:
            self._inflight_kinds.discard(token.kind)

    def _release_gates(self, token: _InflightRun) -> None:
        with self._cv:
            self._release_gates_locked(token)
            self._cv.notify_all()

    def _retire(self, token: _InflightRun) -> None:
        with self._cv:
            self._release_gates_locked(token)
            self._inflight.discard(token)
            self._cv.notify_all()

    def _cancel_remaining(self) -> None:
        with self._cv:
            pending = [op for q in self._queues.values() for op in q]
            self._queues.clear()
            self._ready.clear()
        for op in pending:
            if op.future.cancel():
                op.future.set_running_or_notify_cancel()

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
