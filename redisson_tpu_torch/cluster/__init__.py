"""Slot-sharded cluster tier (counterpart of `redisson_tpu.cluster`). So far
only its redirect errors, which the replica router already handles; the
shards, the router and slot migration come with the cluster tier."""

from redisson_tpu_torch.cluster.errors import (
    ClusterCrossSlotError,
    SlotAskError,
    SlotMovedError,
)

__all__ = ["ClusterCrossSlotError", "SlotAskError", "SlotMovedError"]
