"""ServingReplica — one member of the read fleet (counterpart of
`redisson_tpu.replica.replica`).

A `JournalFollower` (full engine stack: own executor, own backends, own
epoch-stamped read cache) that also serves read traffic through its own
dispatch waist. Reads and journal replay share that waist, so a replica
read observes exactly the per-target FIFO prefix its applied watermark
promises — the property the router's bounded-staleness contract and the
smoke suite's watermark-replay oracle both stand on.

The follower base contributes tailing, partial/full resync accounting,
the cached `lag()` watermark scanner, `promote()` (failover) and
`retarget()` (follow a promoted primary).
"""

from __future__ import annotations

from redisson_tpu_torch.persist.follower import JournalFollower


class ServingReplica(JournalFollower):
    def __init__(self, index: int, path: str, cfg, config=None):
        # `config` is the sanitized copy of the PRIMARY's engine config the
        # ReplicaManager threads through (persist/replicas/faults stripped):
        # codec, backend and structure settings must match or journal replay
        # silently diverges from primary state.
        super().__init__(path, config=config,
                         poll_interval_s=cfg.poll_interval_s,
                         apply_window=cfg.apply_window)
        self.index = index
        self.name = f"replica-{index}"
        self.reads_served = 0
        # Cluster-mode replica: a slot-ownership guard sits on its dispatch,
        # so its reads can bounce with SlotMovedError while its ownership
        # table catches up — the router's _moved_fallback handles those.
        # The port's Config has no cluster section until the cluster tier
        # lands, so no replica is guarded yet.
        cluster = getattr(config, "cluster", None)
        self.guarded = cluster is not None and cluster.shard_id >= 0

    def execute_read(self, target: str, kind: str, payload, nkeys: int = 0,
                     **kw):
        """Serve one routed read through this replica's own dispatch waist.
        `kw` (tenant=, deadline=, ...) passes through untouched so a read
        behaves the same whether a replica or the primary serves it."""
        self.reads_served += 1
        return self.client._dispatch.execute_async(target, kind, payload,
                                                   nkeys, **kw)

    def stats(self):
        out = super().stats()
        out["name"] = self.name
        out["reads_served"] = self.reads_served
        return out
