"""Admission control: per-tenant token buckets + a bounded global queue
(counterpart of `redisson_tpu.serve.admission`).

The reference has no explicit admission tier — overload surfaces as command
timeouts deep in `CommandAsyncService`. A serving system wants the opposite:
reject at the DOOR, cheaply, with a backoff hint, before the op consumes
queue memory and dispatcher time. Two independent gates:

  * per-tenant token buckets (keys/sec with burst) — a noisy tenant runs
    out of tokens and gets shed while quiet tenants' buckets stay full,
    which is what bounds cross-tenant throughput skew;
  * a bounded global queue — depth high-watermark (`max_queue_ops`) and an
    *estimated queueing delay* watermark computed from the cost model
    (queued keys x measured ns/key), so shedding starts when latency — not
    just memory — is at risk.

Both raise `RejectedError` carrying `retry_after_s`: bucket refill time or
estimated drain time, whichever gate fired. Synchronous, lock-protected,
clock passed per call — deterministic under a fake clock.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from redisson_tpu_torch.serve.errors import RejectedError


class TokenBucket:
    """Classic token bucket over an externally supplied clock."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0.0:
            raise ValueError("rate must be > 0 (omit the bucket for unlimited)")
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._tokens = self.burst
        self._stamp: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._stamp is None:
            self._stamp = now
            return
        dt = now - self._stamp
        if dt > 0.0:
            self._tokens = min(self.burst, self._tokens + dt * self.rate)
            self._stamp = now

    def try_acquire(self, tokens: float, now: float) -> bool:
        self._refill(now)
        if self._tokens >= tokens:
            self._tokens -= tokens
            return True
        return False

    def time_to_tokens(self, tokens: float, now: float) -> float:
        """Seconds until `tokens` would be available (0 if already are)."""
        self._refill(now)
        deficit = tokens - self._tokens
        return deficit / self.rate if deficit > 0.0 else 0.0

    def level(self, now: float) -> float:
        self._refill(now)
        return self._tokens


class AdmissionController:
    """The door. `admit()` either accounts the op into the queue or raises.

    The serving layer calls `admit(...)` at submission and `release(...)`
    from the op's completion callback (success OR failure — the queue
    accounting tracks ops the dispatcher still owes work for).
    """

    def __init__(self, cost_model=None,
                 default_tenant_rate: float = 0.0,
                 default_tenant_burst: float = 0.0,
                 tenant_rates: Dict[str, float] = None,
                 tenant_bursts: Dict[str, float] = None,
                 max_queue_ops: int = 10000,
                 max_queue_delay_s: float = 0.0):
        self._cost_model = cost_model  # serve.policy.CostModel or None
        self._default_rate = float(default_tenant_rate)  # 0 = unlimited
        self._default_burst = float(default_tenant_burst)
        self._tenant_rates = dict(tenant_rates or {})
        self._tenant_bursts = dict(tenant_bursts or {})
        self._max_queue_ops = int(max_queue_ops)
        self._max_queue_delay_s = float(max_queue_delay_s)  # 0 = disabled
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._queued_ops = 0
        self._queued_keys = 0
        self._admitted_total = 0
        self._shed_total = 0
        self._shed_by_reason: Dict[str, int] = {}

    # -- per-tenant buckets -------------------------------------------------

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        b = self._buckets.get(tenant)
        if b is not None:
            return b
        rate = self._tenant_rates.get(tenant, self._default_rate)
        if rate <= 0.0:
            return None  # unlimited tenant: no bucket at all
        burst = self._tenant_bursts.get(tenant, self._default_burst)
        b = TokenBucket(rate, burst if burst > 0 else rate)
        self._buckets[tenant] = b
        return b

    # -- the gate -----------------------------------------------------------

    def admit(self, tenant: str, kind: str, nkeys: int, now: float,
              charge_tokens: bool = True) -> None:
        """Admit one op (nkeys key lanes; min-charged as 1 token).

        Raises RejectedError when a gate fires; otherwise the op is
        accounted into the queue and MUST be matched by `release()`.
        Retries pass charge_tokens=False: the tenant already paid for the
        op at first admission, re-charging would punish backend faults.
        """
        tokens = float(max(1, nkeys))
        with self._lock:
            # Queue gates first: depth watermark, then estimated delay.
            # Checked before the bucket so an overloaded queue does not
            # drain a tenant's tokens for ops it would shed anyway.
            if self._queued_ops >= self._max_queue_ops:
                self._shed_locked("queue_depth")
                raise RejectedError(
                    f"admission queue full ({self._queued_ops} ops >= "
                    f"{self._max_queue_ops})",
                    retry_after_s=self._estimated_drain_locked(),
                    reason="queue_depth")
            if self._max_queue_delay_s > 0.0:
                est = self._estimated_delay_locked(kind, nkeys)
                if est > self._max_queue_delay_s:
                    self._shed_locked("queue_delay")
                    raise RejectedError(
                        f"estimated queueing delay {est * 1e3:.2f}ms exceeds "
                        f"budget {self._max_queue_delay_s * 1e3:.2f}ms",
                        retry_after_s=est - self._max_queue_delay_s,
                        reason="queue_delay")
            if charge_tokens:
                bucket = self._bucket_for(tenant)
                if bucket is not None and not bucket.try_acquire(tokens, now):
                    self._shed_locked("tenant_rate")
                    raise RejectedError(
                        f"tenant '{tenant}' over rate limit "
                        f"({bucket.rate:g} keys/s)",
                        retry_after_s=bucket.time_to_tokens(tokens, now),
                        reason="tenant_rate")
            self._queued_ops += 1
            self._queued_keys += max(1, nkeys)
            self._admitted_total += 1

    def release(self, nkeys: int) -> None:
        """Completion callback: the dispatcher no longer owes this op."""
        with self._lock:
            self._queued_ops = max(0, self._queued_ops - 1)
            self._queued_keys = max(0, self._queued_keys - max(1, nkeys))

    # -- internals ----------------------------------------------------------

    def _shed_locked(self, reason: str) -> None:
        self._shed_total += 1
        self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + 1

    def _estimated_delay_locked(self, kind: str, nkeys: int) -> float:
        """Estimated queueing delay this op would see: service time of
        everything already queued, from the cost model's measured rates."""
        if self._cost_model is None:
            return 0.0
        return self._cost_model.estimate(kind, self._queued_keys)

    def _estimated_drain_locked(self) -> float:
        if self._cost_model is None:
            return 0.0
        # Drain estimate over the mix is approximated with the generic rate.
        return self._cost_model.estimate(None, self._queued_keys)

    # -- introspection ------------------------------------------------------

    def queue_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"queued_ops": self._queued_ops,
                    "queued_keys": self._queued_keys}

    def snapshot(self, now: float = None) -> Dict[str, Any]:
        with self._lock:
            snap = {
                "queued_ops": self._queued_ops,
                "queued_keys": self._queued_keys,
                "max_queue_ops": self._max_queue_ops,
                "max_queue_delay_s": self._max_queue_delay_s,
                "admitted_total": self._admitted_total,
                "shed_total": self._shed_total,
                "shed_by_reason": dict(self._shed_by_reason),
            }
            if now is not None:
                snap["tenant_tokens"] = {
                    t: round(b.level(now), 3) for t, b in self._buckets.items()
                }
            return snap
