"""Run watchdog over the executor's in-flight window (counterpart of
`redisson_tpu.fault.watchdog`).

The executor keeps N runs in flight; nothing else bounds how long one may
stay there. A wedged device run (a kernel that never finishes, a completer
stuck on an event) would hold its target gates forever and quietly stall
every op queued behind it. This watchdog closes that hole:

  * every in-flight run gets a deadline `max(floor_s, margin *
    estimate(kind, nkeys))`, the estimate from the serving layer's cost
    model (learned at completion); the margin (default 8x the
    mean-tracking EWMA) stands in for a p99 bound and the floor keeps
    cold-start estimates from tripping at once. Without a serving layer
    `estimate` is None and every deadline is the floor;
  * a run past its deadline is *tripped*: its still-pending futures
    complete with `StateUncertainFault` (the run may have committed —
    blind retry is unsafe), which retires the run through the normal
    `_op_done` path and releases its gates;
  * a per-kind circuit breaker board, when one is given, is forced open;
  * the trip is reported to `on_trip(kind, targets, fault)` — the
    rebuild coordinator's cue to quarantine and re-materialize.

The watchdog NEVER kills the dispatcher or the backend threads — it only
resolves futures; a late device completion finds them already done and
is dropped by the backend's `future.done()` guards.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from redisson_tpu_torch.fault import taxonomy
from redisson_tpu_torch.fault.taxonomy import StateUncertainFault

class RunWatchdog:
    """Polls the executor's in-flight window and trips stuck runs."""

    def __init__(self, executor, estimate: Optional[Callable] = None,
                 margin: float = 8.0, floor_s: float = 2.0,
                 poll_s: float = 0.05, breakers=None,
                 on_trip: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        self._executor = executor
        # (kind, nkeys) -> estimated seconds, or None for floor-only
        # deadlines (no serving layer -> no cost model to learn from).
        self._estimate = estimate
        self._margin = float(margin)
        self._floor_s = float(floor_s)
        self._poll_s = float(poll_s)
        self._breakers = breakers  # serve BreakerBoard or None
        self._on_trip = on_trip
        self._clock = clock or getattr(executor, "_clock", time.monotonic)
        self._stop = threading.Event()
        self._tripped_ids: set = set()  # id(token) of already-tripped runs
        self.trips = 0
        self._thread = threading.Thread(
            target=self._loop, name="redisson-torch-watchdog", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    # -- internals ----------------------------------------------------------

    def deadline_s(self, kind: str, nkeys: int) -> float:
        est = 0.0
        if self._estimate is not None:
            try:
                est = float(self._estimate(kind, nkeys) or 0.0)
            except Exception:  # estimate source mid-teardown
                # cost-model snapshot race during shutdown; the floor deadline still applies
                est = 0.0
        return max(self._floor_s, self._margin * est)

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check_once()

    def check_once(self) -> int:
        """One scan; returns how many runs were tripped (test hook)."""
        ex = self._executor
        now = self._clock()
        with ex._lock:
            tokens = list(ex._inflight)
        tripped = 0
        live_ids = set()
        for token in tokens:
            live_ids.add(id(token))
            if token.t0 <= 0.0 or id(token) in self._tripped_ids:
                continue
            age = now - token.t0
            if age <= self.deadline_s(token.kind, token.nkeys):
                continue
            self._tripped_ids.add(id(token))
            tripped += 1
            self._trip(token, age)
        # Retired tokens can be GC'd and their ids reused; prune.
        self._tripped_ids &= live_ids
        return tripped

    def _trip(self, token, age: float) -> None:
        fault = StateUncertainFault(
            f"watchdog: run {token.kind} on {sorted(token.targets)!r} stuck "
            f"{age:.3f}s past dispatch (deadline "
            f"{self.deadline_s(token.kind, token.nkeys):.3f}s); "
            f"commit state unknown", seam="watchdog")
        self.trips += 1
        taxonomy._count("watchdog_trips")
        if self._breakers is not None:
            try:
                self._breakers.get(token.kind).force_open()
            except Exception:
                # breaker board teardown race; the trip itself must still complete the futures
                pass
        # Resolving the pending futures drives the normal completion path:
        # _op_done -> _run_completed -> _retire releases the gates, and the
        # executor's fault listener (rebuild) sees the StateUncertainFault.
        self._executor.fail_inflight(token, fault)
        if self._on_trip is not None:
            try:
                self._on_trip(token.kind, token.targets, fault)
            except Exception:
                # trip listener is best-effort; a listener bug must not kill the watchdog thread
                pass

    def snapshot(self) -> dict:
        return {
            "trips": self.trips,
            "margin": self._margin,
            "floor_s": self._floor_s,
            "poll_s": self._poll_s,
        }
