"""Serving-layer exceptions (a copy of `redisson_tpu.serve.errors`).

These are the QoS contract's vocabulary (the analogue of the reference's
`RedisTimeoutException` / `RedisException` retry-path taxonomy in
`command/CommandAsyncService.java:378-577`): every op admitted into the
serving layer completes with a result, or with exactly one of these.

Kept dependency-free (no executor / jax imports) so both the executor's
dispatch loop and the serve subsystem can import them without cycles.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for serving-layer failures."""


class RejectedError(ServeError):
    """Load shed at admission: the op never entered the queue.

    `retry_after_s` is the server's backoff hint — the estimated time until
    the rejecting constraint (token bucket refill / queue drain) clears.
    """

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 reason: str = "overload"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


class DeadlineExceeded(ServeError):
    """The op's deadline passed before device dispatch.

    Raised pre-dispatch (at admission, or by the executor's pre-batch
    filter) — an op that carries this error never touched the backend, so
    retrying it elsewhere is always safe.
    """


class CircuitOpenError(ServeError):
    """Fail-fast: the per-kind circuit breaker is open.

    `retry_after_s` is the time until the breaker's next half-open probe.
    """

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class RetryableError(ServeError):
    """Marker for transient backend faults the serving layer may retry.

    Backends (or fault-injection tests) raise this — or subclasses — for
    faults where re-running the op is safe and likely to succeed (transient
    device resets, durability-tier reconnects). Non-retryable exceptions
    propagate to the caller on first failure.
    """
