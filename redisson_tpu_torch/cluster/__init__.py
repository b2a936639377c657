"""Slot-sharded cluster tier (counterpart of `redisson_tpu.cluster`): N full
engine stacks owning ranges of the 16384 CRC16 slots, a router that splits
batches per owner and retries MOVED/ASK redirects, and live slot migration
over the persist follower protocol. See cluster/manager.py for the wiring.
On one card every shard's engine shares `cuda:0`; the mesh data plane
(`data_plane="mesh"`) runs N logical shards over one engine whose bank is
row-sharded over a logical mesh on that card.
"""

from redisson_tpu_torch.cluster.errors import (
    ClusterCrossSlotError,
    SlotAskError,
    SlotMovedError,
    render_redirect,
)
from redisson_tpu_torch.cluster.manager import ClusterManager
from redisson_tpu_torch.cluster.migrator import MigrationError, SlotMigrator
from redisson_tpu_torch.cluster.router import ClusterRouter
from redisson_tpu_torch.cluster.shard import ClusterShard, SlotOwnershipBackend
from redisson_tpu_torch.cluster.split import (
    contiguous_assignment,
    slot_ranges,
    split_by_owner,
)

__all__ = [
    "ClusterCrossSlotError",
    "ClusterManager",
    "ClusterRouter",
    "ClusterShard",
    "MigrationError",
    "SlotAskError",
    "SlotMigrator",
    "SlotMovedError",
    "SlotOwnershipBackend",
    "contiguous_assignment",
    "render_redirect",
    "slot_ranges",
    "split_by_owner",
]
