"""Per-kind circuit breaker: fail fast while the backend is sick
(counterpart of `redisson_tpu.serve.breaker`).

The reference retries every command `retryAttempts` times even when the node
is hard-down, so a dead backend turns every caller into a slow failure. The
breaker converts that into a fast failure: after `failure_threshold`
consecutive faults the circuit OPENS and submissions for that kind are
rejected immediately with `CircuitOpenError` (carrying the time until the
next probe); after `reset_timeout_s` it HALF-OPENS and admits a bounded
number of probe ops — if they all succeed the circuit CLOSES, if any fails
it re-opens and the wait restarts.

Pure, lock-protected, clock-injectable state machine — no executor or torch
imports, so tests can drive it deterministically with a fake clock.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict

from redisson_tpu_torch.serve.errors import CircuitOpenError

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One breaker, typically one per op kind.

    `allow(now)` is called at submission: it raises CircuitOpenError when
    the circuit is open, and accounts a probe slot when half-open.
    `on_success` / `on_failure` are called from op completion.
    """

    def __init__(self, failure_threshold: int = 5, reset_timeout_s: float = 1.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        self._threshold = int(failure_threshold)
        self._reset_timeout_s = float(reset_timeout_s)
        self._half_open_probes = int(half_open_probes)
        self._clock = clock  # only used when allow() is called without `now`
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probes_succeeded = 0
        self._opens_total = 0

    def _now(self, now) -> float:
        if now is not None:
            return now
        if self._clock is None:
            raise ValueError("CircuitBreaker needs `now` or a clock")
        return self._clock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self, now: float = None) -> None:
        """Gate one submission. Raises CircuitOpenError to fail fast."""
        now = self._now(now)
        with self._lock:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                wait = self._opened_at + self._reset_timeout_s - now
                if wait > 0.0:
                    raise CircuitOpenError(
                        f"circuit open ({self._consecutive_failures} consecutive "
                        f"faults); next probe in {wait:.3f}s",
                        retry_after_s=wait)
                # Reset timeout elapsed: half-open and fall through to the
                # probe-slot accounting below.
                self._state = HALF_OPEN
                self._probes_in_flight = 0
                self._probes_succeeded = 0
            # HALF_OPEN: admit up to half_open_probes concurrent probes;
            # everyone else keeps failing fast until the probes decide.
            if self._probes_in_flight >= self._half_open_probes:
                raise CircuitOpenError(
                    "circuit half-open; probe quota in flight",
                    retry_after_s=self._reset_timeout_s)
            self._probes_in_flight += 1

    def peek(self, now: float = None) -> float:
        """Non-consuming open check: seconds until the next probe window
        (0.0 = submissions may proceed). Used by the batch path, which
        fast-fails on an open circuit but never occupies probe slots."""
        now = self._now(now)
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self._reset_timeout_s - now)

    def release_probe(self) -> None:
        """Return a probe slot taken by `allow()` for an op that never
        reached the backend (shed at admission, expired in queue, or
        cancelled) — its outcome says nothing about backend health."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    def force_open(self, now: float = None) -> None:
        """Open the circuit immediately, bypassing the failure counter.

        Used by the fault subsystem: a watchdog trip or a quarantined
        target means the backend is known-sick for this kind — waiting
        for `failure_threshold` more casualties would just create them.
        """
        now = self._now(now)
        with self._lock:
            if self._state != OPEN:
                self._state = OPEN
                self._opens_total += 1
            self._opened_at = now

    def force_close(self) -> None:
        """Close the circuit immediately (e.g. after a successful device
        rebuild): the backend was repaired out-of-band, so the normal
        half-open probe dance would only delay recovery."""
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            self._probes_succeeded = 0

    def on_success(self, now: float = None) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._probes_succeeded += 1
                if self._probes_succeeded >= self._half_open_probes:
                    self._state = CLOSED

    def on_failure(self, now: float = None) -> None:
        now = self._now(now)
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # A failed probe re-opens immediately; the wait restarts.
                self._state = OPEN
                self._opened_at = now
                self._opens_total += 1
                return
            if (self._state == CLOSED
                    and self._consecutive_failures >= self._threshold):
                self._state = OPEN
                self._opened_at = now
                self._opens_total += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "opens_total": self._opens_total,
                "opened_at": self._opened_at,
            }


class BreakerBoard:
    """Lazy per-kind breaker map sharing one configuration."""

    def __init__(self, failure_threshold: int = 5, reset_timeout_s: float = 1.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = None):
        self._kw = dict(failure_threshold=failure_threshold,
                        reset_timeout_s=reset_timeout_s,
                        half_open_probes=half_open_probes, clock=clock)
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, kind: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(kind)
            if b is None:
                b = self._breakers[kind] = CircuitBreaker(**self._kw)
            return b

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._breakers.items())
        return {kind: b.snapshot() for kind, b in items}
