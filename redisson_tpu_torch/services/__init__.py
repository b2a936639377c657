"""Higher services tier (the reference's L5b): RPC + cache manager
(counterpart of `redisson_tpu.services`)."""

from redisson_tpu_torch.services.cache_manager import CacheConfig, CacheManager
from redisson_tpu_torch.services.remote import (RemoteInvocationOptions,
                                                RemoteServiceAckTimeoutError,
                                                RemoteServiceError,
                                                RemoteServiceTimeoutError,
                                                RRemoteService)

__all__ = [
    "RRemoteService", "RemoteInvocationOptions", "RemoteServiceError",
    "RemoteServiceTimeoutError", "RemoteServiceAckTimeoutError",
    "CacheConfig", "CacheManager",
]
