"""redisson_tpu_torch.serve — the QoS serving layer in front of the executor
(counterpart of `redisson_tpu.serve`).

Per-tenant admission control with load shedding, deadline-aware adaptive
batching, bounded retry and per-kind circuit breakers; `ServingLayer` is
the entry point (built by `RedissonTorch` when `Config.serve` is set).
`windows.py` holds the wire tier's per-connection reply order and
inflight cap (pure; the wire front-end is still to be ported).

Import-order note: `redisson_tpu_torch.executor` imports `serve.errors`,
so nothing imported at THIS module's load time may import the executor
(the scheduler pulls it lazily).
"""

from redisson_tpu_torch.serve.admission import AdmissionController, TokenBucket
from redisson_tpu_torch.serve.breaker import BreakerBoard, CircuitBreaker
from redisson_tpu_torch.serve.errors import (CircuitOpenError, DeadlineExceeded,
                                             RejectedError, RetryableError,
                                             ServeError)
from redisson_tpu_torch.serve.policy import AdaptiveBatchPolicy, CostModel
from redisson_tpu_torch.serve.scheduler import ServingLayer
from redisson_tpu_torch.serve.windows import ConnectionWindow, ReplySlot

__all__ = [
    "ConnectionWindow",
    "ReplySlot",
    "AdmissionController",
    "TokenBucket",
    "BreakerBoard",
    "CircuitBreaker",
    "ServeError",
    "RejectedError",
    "DeadlineExceeded",
    "CircuitOpenError",
    "RetryableError",
    "CostModel",
    "AdaptiveBatchPolicy",
    "ServingLayer",
]
