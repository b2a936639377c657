"""Read-replica fleet: stale-bounded read scaling with automatic failover
(counterpart of `redisson_tpu.replica`).

The engine-owned analogue of Redisson's `readMode=SLAVE` topology tier
(`MasterSlaveConnectionManager.java`): N serving replicas — each a full
engine stack tailing the primary's write-ahead journal — behind a
ReplicaRouter that keeps every read inside an explicit staleness bound,
with PSYNC-style partial resync after journal gaps and automatic
promote-on-failure through the fault manager.

    cfg = Config()
    cfg.use_cuda()                    # the primary and its fleet share the card
    cfg.use_serve()
    cfg.use_persist("/data/ns1", fsync="always")
    cfg.use_replicas(2, max_lag_seqs=256)
    c = RedissonTorch.create(cfg)     # reads now fan out to the fleet
    c.wait_for_replicas(2, timeout_s=5)   # WAIT analogue
"""

from redisson_tpu_torch.replica.manager import ReplicaManager
from redisson_tpu_torch.replica.replica import ServingReplica
from redisson_tpu_torch.replica.router import READ_KINDS, ReplicaRouter

__all__ = ["READ_KINDS", "ReplicaManager", "ReplicaRouter", "ServingReplica"]
