"""One cluster shard: a full engine stack plus the slot-ownership guard
(counterpart of `redisson_tpu.cluster.shard`, the stacks data plane).

The guard (`SlotOwnershipBackend`) wraps the shard client's RoutingBackend
at the narrow waist, so every dispatched op crosses exactly one ownership
check on the dispatcher thread — the analogue of redis cluster's
`getNodeBySlot` check before command execution. Ownership transitions are
themselves journaled ops (`migrate_adopt` / `migrate_begin` /
`migrate_flip` — see commands.py), which gives two properties for free:

  * the slot table is crash-recoverable: journal replay rebuilds ownership
    in exactly the order live traffic observed it, so a replayed keyed op
    meets the same accept/reject decision it met live;
  * the `migrate_flip` record IS the cutover point in the source journal —
    every record before it replays on the source, every keyed op after it
    is rejected with `SlotMovedError` and re-routed by the ClusterRouter
    (the MOVED retry path), so nothing applies twice.

`ClusterShard` is the manager's per-shard handle: the client, its guard,
and the dispatch the router submits to. The mesh data plane (`MeshShard`,
`MeshOwnershipBackend`: N logical shards over one engine whose bank is
sharded across devices) waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Set

from redisson_tpu_torch.cluster.errors import SlotMovedError
from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.ops.crc16 import MAX_SLOT, key_slot

CLUSTER_KINDS = frozenset({
    "migrate_begin", "migrate_flip", "migrate_adopt", "migrate_install",
    "migrate_abort",
})


class SlotOwnershipBackend:
    """Backend wrapper enforcing slot ownership at the dispatch commit
    point. Installed by the client between RoutingBackend and the executor
    when `Config.cluster.shard_id >= 0` (i.e. this client IS a shard)."""

    def __init__(self, inner, shard_id: int):
        self._inner = inner
        self.shard_id = int(shard_id)
        # None = open ownership (pre-adoption / recovery replay prefix):
        # accept everything until the first migrate_adopt record draws the
        # boundary. The manager journals an adopt at shard start, so the
        # open window never sees routed user traffic.
        self._owned: Optional[Set[int]] = None
        self._migrating: Set[int] = set()
        # Mutations happen only on the dispatcher thread (the single
        # backend.run caller); the lock covers cross-thread introspection.
        self._lock = make_lock("shard.SlotOwnershipBackend._lock")
        self.rejected_ops = 0

    # -- delegation ---------------------------------------------------------

    def __getattr__(self, name):
        # sketch / structures / pubsub / keys / GLOBAL_COALESCE /
        # COALESCE_GROUPS / DISPATCH_TIME_STATE / BLOOM_STRICT_MOD ... —
        # everything but run() is the inner stack's business.
        return getattr(self._inner, name)

    # -- introspection ------------------------------------------------------

    def owned_slots(self) -> Optional[Set[int]]:
        with self._lock:
            return None if self._owned is None else set(self._owned)

    def migrating_slots(self) -> Set[int]:
        with self._lock:
            return set(self._migrating)

    def owns(self, slot: int) -> bool:
        with self._lock:
            return self._owned is None or slot in self._owned

    # -- the waist ----------------------------------------------------------

    def run(self, kind: str, target: str, ops: List, window=None) -> None:
        if kind in CLUSTER_KINDS:
            self._run_cluster(kind, ops)
            return
        if target:
            owned = self._owned
            if owned is not None:
                # Migrating slots stay accepted: on the SOURCE they are
                # still owned until the flip; on the TARGET the migrator
                # journals a migrate_begin (the SETSLOT IMPORTING state) so
                # catch-up replay and early-redirected ops land before the
                # final adopt.
                migrating = self._migrating
                live = []
                for op in ops:
                    slot = key_slot(op.target) if op.target else -1
                    if slot < 0 or slot in owned or slot in migrating:
                        live.append(op)
                    else:
                        # Reject on the future, not by raising: a raise here
                        # would cross the fault-classify seam and come back
                        # wrapped; the router's retry path matches on the
                        # redirect type exactly.
                        self.rejected_ops += 1
                        op.future.set_exception(
                            SlotMovedError(slot, op.target))
                if not live:
                    return
                ops = live
        self._inner.run(kind, target, ops, window=window)

    # -- ownership transitions (journaled; dispatcher thread) ---------------

    def _run_cluster(self, kind: str, ops: List) -> None:
        for op in ops:
            try:
                if kind == "migrate_begin":
                    slots = {int(s) for s in op.payload["slots"]}
                    with self._lock:
                        self._migrating |= slots
                    op.future.set_result(True)
                elif kind == "migrate_flip":
                    slots = {int(s) for s in op.payload["slots"]}
                    with self._lock:
                        if self._owned is None:
                            self._owned = set(range(MAX_SLOT))
                        self._owned -= slots
                        self._migrating -= slots
                    op.future.set_result(True)
                elif kind == "migrate_adopt":
                    slots = {int(s) for s in op.payload["slots"]}
                    with self._lock:
                        if self._owned is None:
                            self._owned = set(slots)
                        else:
                            self._owned |= slots
                        self._migrating -= slots
                    op.future.set_result(True)
                elif kind == "migrate_abort":
                    # Migration rollback (SETSLOT STABLE): clear the
                    # migrating mark; ownership is untouched — the source
                    # re-adopts explicitly when a flip must be undone.
                    slots = {int(s) for s in op.payload["slots"]}
                    with self._lock:
                        self._migrating -= slots
                    op.future.set_result(True)
                else:  # migrate_install: structure-tier state for our slots
                    structures = getattr(self._inner, "structures", None)
                    if structures is None:
                        raise RuntimeError(
                            "migrate_install needs the structure tier")
                    count = structures.load_keys(op.payload["blob"])
                    op.future.set_result(count)
            except Exception as exc:  # pragma: no cover - defensive
                if not op.future.done():
                    op.future.set_exception(exc)


class ClusterShard:
    """The manager's handle on one shard: client + guard + dispatch.

    With `ClusterConfig.replicas_per_shard` the shard client carries its
    own replica fleet (its `_dispatch` is a ReplicaRouter), and a shard-
    level failover can swap the live engine underneath this handle — so
    `guard` / `executor` / `journal` resolve through the fleet's CURRENT
    primary on every access instead of being captured at construction."""

    def __init__(self, shard_id: int, client):
        self.shard_id = int(shard_id)
        self.client = client
        self.quarantined = False

    @property
    def _primary_client(self):
        """The shard's live engine: the latest promotee after a per-shard
        failover, the original shard client otherwise."""
        mgr = getattr(self.client, "replicas", None)
        return mgr.primary_client if mgr is not None else self.client

    @property
    def replicas(self):
        """The shard's ReplicaManager (replicas_per_shard > 0), or None."""
        return getattr(self.client, "replicas", None)

    @property
    def guard(self) -> SlotOwnershipBackend:
        return self._primary_client._routing

    @property
    def dispatch(self):
        # User traffic goes through the shard's dispatch — the per-shard
        # ReplicaRouter when a fleet is configured (it survives failover:
        # set_primary repoints it in place), else the ServingLayer /
        # executor as before. Ownership transitions and migration replay
        # are maintenance traffic on the raw executor — never shed, never
        # deadline-expired.
        return self.client._dispatch

    @property
    def executor(self):
        return self._primary_client._executor

    # -- journaled ownership transitions ------------------------------------

    def _cluster_op(self, kind: str, payload: dict,
                    timeout_s: float = 30.0) -> None:
        """Execute one journaled ownership transition on the CURRENT
        primary, riding out a failover: a fenced journal or a dead
        executor mid-promotion is transient — the dynamic `executor`
        property resolves to the promotee once `set_primary` lands, and
        the op must be re-journaled THERE (cluster kinds are idempotent
        set operations, so a retry that raced the fence is safe)."""
        deadline = time.monotonic() + timeout_s
        while True:
            ex = self.executor
            try:
                ex.execute_sync("", kind, payload)
                return
            except Exception as exc:
                fenced = "fenced" in str(exc)
                try:
                    dead = not ex.is_alive()
                except Exception:  # cannot answer: treat as dead, wait
                    dead = True
                swapped = self.executor is not ex
                if ((fenced or dead or swapped)
                        and time.monotonic() < deadline):
                    time.sleep(0.02)
                    continue
                raise

    def adopt(self, slots: Iterable[int]) -> None:
        self._cluster_op(
            "migrate_adopt", {"slots": sorted(int(s) for s in slots)})

    def begin_migrate(self, slots: Iterable[int], target_shard: int) -> None:
        self._cluster_op(
            "migrate_begin",
            {"slots": sorted(int(s) for s in slots),
             "target_shard": int(target_shard)})

    def flip(self, slots: Iterable[int]) -> None:
        self._cluster_op(
            "migrate_flip", {"slots": sorted(int(s) for s in slots)})

    def abort_migrate(self, slots: Iterable[int]) -> None:
        self._cluster_op(
            "migrate_abort", {"slots": sorted(int(s) for s in slots)})

    # -- introspection -------------------------------------------------------

    @property
    def persist(self):
        """The CURRENT primary's PersistenceManager (post-failover: the
        promotee's epoch persistence), or None."""
        return self._primary_client._persist

    @property
    def journal(self):
        persist = self.persist
        return persist.journal if persist is not None else None

    def replica_entries(self) -> List[dict]:
        """CLUSTER SLOTS replica-entry shape for this shard: one dict per
        fleet member with its id, applied watermark and current lag."""
        mgr = self.replicas
        if mgr is None:
            return []
        return [{"id": f"shard-{self.shard_id}:{r.name}",
                 "watermark": r.applied_seq, "lag": r.lag()}
                for r in mgr.replicas]

    def owned_count(self) -> int:
        owned = self.guard.owned_slots()
        return -1 if owned is None else len(owned)

    def stats(self) -> dict:
        out = {
            "shard_id": self.shard_id,
            "owned_slots": self.owned_count(),
            "migrating_slots": len(self.guard.migrating_slots()),
            "rejected_ops": self.guard.rejected_ops,
            "queue_depth": self.executor.queue_depth(),
            "quarantined": self.quarantined,
        }
        mgr = self.replicas
        if mgr is not None:
            out["replicas"] = self.replica_entries()
            out["failovers"] = mgr.promotions
        memstat = getattr(self.client, "memstat", None)
        if memstat is not None:
            # Per-shard HBM attribution: each shard owns a full ledger.
            out["live_bytes"] = memstat.live_bytes()
            out["keys"] = memstat.keys_count()
        return out

    def shutdown(self) -> None:
        self.client.shutdown()
