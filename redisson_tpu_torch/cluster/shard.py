"""One cluster shard: a full engine stack plus the slot-ownership guard
(counterpart of `redisson_tpu.cluster.shard`, both data planes).

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
and the dispatch the router submits to.

The mesh data plane (`MeshOwnershipBackend`, `_GuardView`,
`_ShardDispatch`, `MeshShard`): N logical shards over ONE engine whose HLL
bank is row-sharded over a logical mesh (`parallel/mesh.ShardedBank`).
"""

from __future__ import annotations

import inspect
import time
from typing import Dict, Iterable, List, Optional, Set

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


# ---------------------------------------------------------------------------
# Mesh data plane (ClusterConfig.data_plane == "mesh")
#
# N logical shards share ONE engine stack: one executor, one store, one
# journal, one HLL bank row-sharded across a device mesh
# (parallel/mesh.ShardedBank). Slot ownership still exists — it is what
# makes MOVED/ASK, live migration, and the journaled flip fence
# bit-identical to the stacks plane — but it is enforced by a single
# guard holding the WHOLE slot->shard table instead of N per-shard sets.
# Keyed ops carry their submitting shard as `Op.shard` (stamped by the
# `_ShardDispatch` facade); the guard compares that tag against the
# authoritative owner and rejects stale submissions with SlotMovedError
# exactly like SlotOwnershipBackend does, so the router's redirect loop
# is reused unchanged.
# ---------------------------------------------------------------------------


class MeshOwnershipBackend:
    """The mesh plane's single ownership guard at the shared client's
    dispatch waist.

    Ownership transitions are the SAME journaled kinds as the stacks
    plane (CLUSTER_KINDS), but since one journal serves every logical
    shard, each record identifies its shard in the PAYLOAD
    (``payload["shard"]``) — an op tag would not survive journal replay.
    Keyed user ops are checked by their ``Op.shard`` tag; untagged ops
    (tag < 0: recovery replay, direct executor maintenance) are always
    accepted — the state is shared, so there is no wrong engine for them
    to land on."""

    def __init__(self, inner, num_shards: int):
        self._inner = inner
        self.num_shards = int(num_shards)
        # None = open table (pre-adoption). The manager journals the full
        # adopt table at startup, so routed traffic never sees it open.
        self._owner: Optional[Dict[int, int]] = None
        self._migrating: Dict[int, Set[int]] = {}
        self._lock = make_lock("shard.MeshOwnershipBackend._lock")
        self.rejected_ops = 0
        self.rejected_by: Dict[int, int] = {}

    # -- delegation ---------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- introspection ------------------------------------------------------

    def owner_table(self) -> Optional[Dict[int, int]]:
        with self._lock:
            return None if self._owner is None else dict(self._owner)

    def owned_slots(self, shard_id: int) -> Optional[Set[int]]:
        with self._lock:
            if self._owner is None:
                return None
            return {s for s, o in self._owner.items() if o == shard_id}

    def migrating_slots(self, shard_id: int) -> Set[int]:
        with self._lock:
            return {s for s, ids in self._migrating.items()
                    if shard_id in ids}

    def owns(self, shard_id: int, slot: int) -> bool:
        with self._lock:
            return self._owner is None or self._owner.get(slot) == shard_id

    def shard_of_key(self, name: str) -> int:
        """Authoritative owner of a key's slot (0 while the table is
        open) — the backend's `shard_of` hook: tape shard column,
        per-shard bank-row placement, memstat attribution."""
        slot = key_slot(name)
        with self._lock:
            if self._owner is None:
                return 0
            return self._owner.get(slot, 0)

    # -- the waist ----------------------------------------------------------

    def run(self, kind: str, target: str, ops: List, window=None) -> None:
        if kind in CLUSTER_KINDS:
            self._run_cluster(kind, ops)
            return
        if target:
            with self._lock:
                owner = self._owner
            if owner is not None:
                live = []
                for op in ops:
                    tag = getattr(op, "shard", -1)
                    slot = key_slot(op.target) if op.target else -1
                    if tag < 0 or slot < 0:
                        live.append(op)
                        continue
                    with self._lock:
                        ok = (self._owner is None
                              or self._owner.get(slot) == tag
                              or tag in self._migrating.get(slot, ()))
                    if ok:
                        live.append(op)
                    else:
                        self.rejected_ops += 1
                        self.rejected_by[tag] = (
                            self.rejected_by.get(tag, 0) + 1)
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
                if kind == "migrate_install":
                    structures = getattr(self._inner, "structures", None)
                    if structures is None:
                        raise RuntimeError(
                            "migrate_install needs the structure tier")
                    op.future.set_result(
                        structures.load_keys(op.payload["blob"]))
                    continue
                slots = {int(s) for s in op.payload["slots"]}
                shard = int(op.payload.get("shard", -1))
                with self._lock:
                    if kind == "migrate_begin":
                        for s in slots:
                            self._migrating.setdefault(s, set()).add(shard)
                    elif kind == "migrate_flip":
                        # The source relinquishes: its owned slots go
                        # unowned until the target's adopt lands (the
                        # same window the stacks plane has between a
                        # source flip and a target adopt).
                        if self._owner is not None:
                            for s in slots:
                                if self._owner.get(s) == shard:
                                    del self._owner[s]
                        self._discard(slots, shard)
                    elif kind == "migrate_adopt":
                        if self._owner is None:
                            self._owner = {}
                        for s in slots:
                            self._owner[s] = shard
                        self._discard(slots, shard)
                    else:  # migrate_abort
                        self._discard(slots, shard)
                op.future.set_result(True)
            except Exception as exc:  # pragma: no cover - defensive
                if not op.future.done():
                    op.future.set_exception(exc)

    def _discard(self, slots: Set[int], shard: int) -> None:
        # Caller holds self._lock.
        for s in slots:
            ids = self._migrating.get(s)
            if ids is not None:
                ids.discard(shard)
                if not ids:
                    del self._migrating[s]


class _GuardView:
    """Per-shard projection of the MeshOwnershipBackend — the slice of
    the shared table one MeshShard sees, shaped like the introspection
    surface of SlotOwnershipBackend so manager / stats / tests treat
    both planes uniformly."""

    def __init__(self, guard: MeshOwnershipBackend, shard_id: int):
        self._guard = guard
        self.shard_id = int(shard_id)

    def owned_slots(self) -> Optional[Set[int]]:
        return self._guard.owned_slots(self.shard_id)

    def migrating_slots(self) -> Set[int]:
        return self._guard.migrating_slots(self.shard_id)

    def owns(self, slot: int) -> bool:
        return self._guard.owns(self.shard_id, slot)

    @property
    def rejected_ops(self) -> int:
        return self._guard.rejected_by.get(self.shard_id, 0)


class _ShardDispatch:
    """Dispatch facade stamping every submission with its logical shard.

    The router submits to `shard.dispatch`; in mesh mode all shards share
    one executor, so this facade is what keeps MOVED semantics: it tags
    ops with `shard=` for the guard's ownership check. When the inner
    dispatch does not take the kwarg (a ServingLayer front), ops go
    untagged — the guard accepts them (shared state makes that safe) and
    ownership enforcement falls back to the router's table."""

    def __init__(self, inner, shard_id: int):
        self._inner = inner
        self._shard_id = int(shard_id)
        try:
            sig = inspect.signature(inner.execute_async)
            self._tagged = "shard" in sig.parameters
        except (TypeError, ValueError):  # pragma: no cover - defensive
            self._tagged = False

    def _kw(self, kw: dict) -> dict:
        if self._tagged:
            kw.setdefault("shard", self._shard_id)
        return kw

    def execute_async(self, target, kind, payload, nkeys=0, **kw):
        return self._inner.execute_async(target, kind, payload, nkeys,
                                         **self._kw(kw))

    def execute_many(self, staged, **kw):
        return self._inner.execute_many(staged, **self._kw(kw))

    def execute_sync(self, target, kind, payload, nkeys=0, **kw):
        return self._inner.execute_sync(target, kind, payload, nkeys,
                                        **self._kw(kw))

    def batch(self, **submit_kwargs):
        return self._inner.batch(**self._kw(submit_kwargs))

    def __getattr__(self, name):
        return getattr(self._inner, name)


class MeshShard:
    """The manager's handle on one LOGICAL shard of the mesh data plane.

    Protocol-compatible with ClusterShard (guard / dispatch / executor /
    adopt / flip / stats / ...) so the router, the recovered-table
    rebuild, and CLUSTER-command parity run unmodified — but `client` is
    the ONE shared engine stack, `guard` is a per-shard view of the
    shared MeshOwnershipBackend, and `shutdown` is a no-op (the manager
    owns the shared client's lifecycle)."""

    def __init__(self, shard_id: int, client):
        self.shard_id = int(shard_id)
        self.client = client
        self.quarantined = False
        self._mesh_guard: MeshOwnershipBackend = client._routing
        self._view = _GuardView(self._mesh_guard, shard_id)
        self._dispatch = _ShardDispatch(client._dispatch, shard_id)

    @property
    def replicas(self):
        return None

    @property
    def guard(self) -> _GuardView:
        return self._view

    @property
    def dispatch(self) -> _ShardDispatch:
        return self._dispatch

    @property
    def executor(self):
        return self.client._executor

    # -- journaled ownership transitions ------------------------------------

    def _cluster_op(self, kind: str, payload: dict) -> None:
        payload = dict(payload)
        payload["shard"] = self.shard_id
        self.executor.execute_sync("", kind, payload)

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
        return self.client._persist

    @property
    def journal(self):
        persist = self.persist
        return persist.journal if persist is not None else None

    def replica_entries(self) -> List[dict]:
        return []

    def owned_count(self) -> int:
        owned = self.guard.owned_slots()
        return -1 if owned is None else len(owned)

    def stats(self) -> dict:
        return {
            "shard_id": self.shard_id,
            "owned_slots": self.owned_count(),
            "migrating_slots": len(self.guard.migrating_slots()),
            "rejected_ops": self.guard.rejected_ops,
            "queue_depth": self.executor.queue_depth(),
            "quarantined": self.quarantined,
            "data_plane": "mesh",
        }

    def shutdown(self) -> None:
        # Shared client: the ClusterManager shuts it down exactly once.
        pass
