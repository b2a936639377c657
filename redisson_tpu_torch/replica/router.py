"""ReplicaRouter — bounded-staleness read routing in front of the primary
(counterpart of `redisson_tpu.replica.router`).

Drop-in dispatch facade (same `execute_async` / `execute_sync` /
`execute_many` / `batch()` surface as ServingLayer / CommandExecutor —
model getters bind to it transparently) that forwards writes to the
primary and sends read-only op kinds to a replica that can satisfy the
read's staleness bound:

    eligible(replica) :=
        primary_seq - replica.applied_seq <= max_lag            (seq axis)
        and (max_lag_s == 0 or replica.staleness_s() <= max_lag_s)
        and (not read_your_writes
             or replica.applied_seq >= acked_seq(tenant))       (RYW pin)

The read set is derived from the op registry (`OP_TABLE` entries with
write=False) — no hand-maintained list to drift — minus the parked
blocking kinds (a bpop served from a replica would wait on a frozen
snapshot forever) and their control ops. Reads with no eligible replica
fall back to the primary (`primary_fallbacks` counts them), which is also
where every batch/pipeline goes unsplit: a batch is one admission
decision with one deadline, and splitting it across engines would break
that contract.

Read-your-writes: the serve layer reports each acked write's journal
floor via `record_ack(tenant, seq)` (enable_ack_tracking); without a
serve layer the router observes write futures itself. The per-tenant pin
is the journal's last committed seq at ack time — conservative (>= the
op's own seq, because the write-ahead append precedes the ack), so a
pinned read can only be *fresher* than required, never staler.

Failover: `set_primary(dispatch, journal)` repoints writes and the
watermark source in one swap; the acked-seq map survives because the
promoted primary continues the global seq numbering.

Reference: `readMode=SLAVE` read dispatch in
`MasterSlaveConnectionManager.java` / `MasterSlaveEntry.java` — there the
slave is picked by a load balancer with no staleness bound; the bound (and
the RYW pin) is the redesign this engine's seq watermarks make possible.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch.cluster.errors import SlotMovedError
from redisson_tpu_torch.commands import OP_TABLE
from redisson_tpu_torch.executor import PARKED_KINDS, BatchCollector, make_lock

# bpop parks on the primary's structures; bpop_cancel must reach the same
# engine that parked it.
_PINNED_TO_PRIMARY = frozenset(PARKED_KINDS) | {"bpop_cancel"}

READ_KINDS = frozenset(
    k for k, d in OP_TABLE.items() if not d.write) - _PINNED_TO_PRIMARY


class ReplicaRouter:
    def __init__(self, primary_dispatch, journal, cfg):
        self._primary = primary_dispatch
        self._journal = journal
        self._cfg = cfg
        self._replicas: List = []
        self._rr = 0  # round-robin cursor over eligible replicas
        self._lock = make_lock("router.ReplicaRouter._lock")
        self._acked: Dict[str, int] = {}
        self.replica_reads = 0
        self.primary_fallbacks = 0
        self.primary_reads = 0
        # Cluster mode: replica-served reads the replica's own slot guard
        # rejected (its ownership table lags a flip/adopt by a few
        # records) and the router re-served from the primary.
        self.replica_moved_retries = 0
        # Serve-layer primaries push acks via enable_ack_tracking; a raw
        # executor primary gets per-future callbacks from the router.
        self._inline_acks = not hasattr(primary_dispatch, "enable_ack_tracking")
        # Failover fence: cleared while a failover is repointing the
        # primary — writes hold here instead of landing on a journal the
        # surviving fleet has stopped tailing.
        self._unfenced = threading.Event()
        self._unfenced.set()

    # -- fleet / primary management ------------------------------------------

    @property
    def journal(self):
        return self._journal

    @property
    def primary(self):
        return self._primary

    def set_replicas(self, replicas: List) -> None:
        with self._lock:
            self._replicas = list(replicas)

    def set_primary(self, dispatch, journal) -> None:
        """Failover repoint: writes and the watermark source swap together.
        The acked map is kept — the promoted journal continues the global
        seq numbering, so existing pins stay meaningful. Re-arms ack
        tracking on the new dispatch (a serve-layer promotee pushes acks
        itself; a raw executor gets per-future callbacks) and lifts the
        write fence."""
        with self._lock:
            self._primary = dispatch
            self._journal = journal
            self._inline_acks = not hasattr(dispatch, "enable_ack_tracking")
        if not self._inline_acks:
            dispatch.enable_ack_tracking(self)
        self._unfenced.set()

    # -- failover write fence ------------------------------------------------

    def fence_writes(self) -> None:
        """First step of failover: hold every new write until set_primary
        installs the promotee (or unfence_writes aborts). Reads keep
        flowing — replicas serve what they have, primary fallbacks hit the
        old dispatch and fail like any read against a dead engine."""
        self._unfenced.clear()

    def unfence_writes(self) -> None:
        """Abort path: release held writes without repointing (they land on
        the old primary, whose fenced journal fails them cleanly)."""
        self._unfenced.set()

    def _await_unfenced(self) -> None:
        if self._unfenced.is_set():
            return
        if not self._unfenced.wait(self._cfg.promote_timeout_s):
            raise RuntimeError(
                "primary is fenced: failover did not repoint writes within "
                f"promote_timeout_s={self._cfg.promote_timeout_s}")

    # -- read-your-writes ----------------------------------------------------

    def record_ack(self, tenant: str, seq: int) -> None:
        with self._lock:
            if seq > self._acked.get(tenant, 0):
                self._acked[tenant] = seq

    def acked_seq(self, tenant: str) -> int:
        with self._lock:
            return self._acked.get(tenant, 0)

    # -- routing -------------------------------------------------------------

    def _resolve_tenant(self, tenant: Optional[str]) -> str:
        if tenant is not None:
            return tenant
        resolve = getattr(self._primary, "_resolve_tenant", None)
        return resolve(None) if resolve is not None else ""

    def _pick(self, tenant: str, max_lag: Optional[int],
              max_lag_s: Optional[float], read_your_writes: Optional[bool]):
        with self._lock:
            replicas = self._replicas
            if not replicas:
                return None
            journal = self._journal
            rr = self._rr
            self._rr = rr + 1
            acked = self._acked.get(tenant, 0)
        if max_lag is None:
            max_lag = self._cfg.max_lag_seqs
        if max_lag_s is None:
            max_lag_s = self._cfg.max_lag_s
        if read_your_writes is None:
            read_your_writes = self._cfg.read_your_writes
        primary_seq = journal.last_seq if journal is not None else 0
        floor = max(primary_seq - max(0, int(max_lag)),
                    acked if read_your_writes else 0)
        n = len(replicas)
        for i in range(n):
            rep = replicas[(rr + i) % n]
            if rep.applied_seq < floor:
                continue
            if max_lag_s > 0 and rep.staleness_s() > max_lag_s:
                continue
            return rep
        return None

    def execute_async(self, target: str, kind: str, payload: Any,
                      nkeys: int = 0, tenant: Optional[str] = None,
                      max_lag: Optional[int] = None,
                      max_lag_s: Optional[float] = None,
                      read_your_writes: Optional[bool] = None, **kw):
        if kind in READ_KINDS:
            fut, _, _ = self.routed_read(
                target, kind, payload, nkeys, tenant=tenant, max_lag=max_lag,
                max_lag_s=max_lag_s, read_your_writes=read_your_writes, **kw)
            return fut
        self._await_unfenced()
        fut = self._primary.execute_async(
            target, kind, payload, nkeys,
            tenant=self._resolve_tenant(tenant), **kw)
        if self._inline_acks:
            fut = self._track_write_ack(fut, kind, self._resolve_tenant(tenant))
        return fut

    def routed_read(self, target: str, kind: str, payload: Any,
                    nkeys: int = 0, tenant: Optional[str] = None,
                    max_lag: Optional[int] = None,
                    max_lag_s: Optional[float] = None,
                    read_your_writes: Optional[bool] = None, **kw):
        """Read with routing introspection: returns (future, replica-or-None,
        watermark) where `watermark` is the chosen replica's applied seq at
        pick time — the smoke suite replays the primary at that watermark to
        verify every answer sits inside its staleness bound."""
        tenant = self._resolve_tenant(tenant)
        rep = self._pick(tenant, max_lag, max_lag_s, read_your_writes)
        if rep is not None:
            watermark = rep.applied_seq
            self.replica_reads += 1
            # Same kwargs either way: a deadline= honored on primary
            # fallback must be honored on the replica too.
            fut = rep.execute_read(target, kind, payload, nkeys,
                                   tenant=tenant, **kw)
            if getattr(rep, "guarded", False):
                # Cluster-mode replica: its slot-ownership guard lags the
                # primary's by the replication delay, so a read for a slot
                # adopted moments ago can bounce with MOVED even though
                # this shard owns it. The primary's guard is authoritative
                # — retry there; a genuine MOVED (slot really left the
                # shard) surfaces identically from the primary for the
                # ClusterRouter's redirect path.
                fut = self._moved_fallback(fut, target, kind, payload,
                                           nkeys, tenant, kw)
            return fut, rep, watermark
        if self._replicas:
            self.primary_fallbacks += 1
        else:
            self.primary_reads += 1
        fut = self._primary.execute_async(target, kind, payload, nkeys,
                                          tenant=tenant, **kw)
        journal = self._journal
        return fut, None, (journal.last_seq if journal is not None else 0)

    def _moved_fallback(self, fut, target: str, kind: str, payload: Any,
                        nkeys: int, tenant: str, kw: Dict[str, Any]):
        """Wrap a replica-served read so a SlotMovedError from the
        REPLICA's guard re-serves from the primary instead of failing the
        caller; every other outcome passes through untouched."""
        outer: Future = Future()

        def _chain(rf) -> None:
            if rf.cancelled():
                outer.cancel()
                return
            exc = rf.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(rf.result())

        def _done(f) -> None:
            if f.cancelled():
                outer.cancel()
                return
            exc = f.exception()
            if isinstance(exc, SlotMovedError):
                self.replica_moved_retries += 1
                try:
                    retry = self._primary.execute_async(
                        target, kind, payload, nkeys, tenant=tenant, **kw)
                except Exception as retry_exc:
                    outer.set_exception(retry_exc)
                    return
                retry.add_done_callback(_chain)
                return
            _chain(f)

        fut.add_done_callback(_done)
        return outer

    def _track_write_ack(self, fut, kind: str, tenant: str):
        """The future to hand the caller for a write on a raw-executor
        primary: it resolves only after the tenant's pin covers the write.
        (JAX adds the pin as a done-callback of the caller's own future,
        which runs after the caller's result() has returned, so a read
        issued at once could be served below its own write.)"""
        desc = OP_TABLE.get(kind)
        if desc is None or not desc.write:
            return fut
        journal = self._journal
        outer: Future = Future()

        def _ack(f) -> None:
            if f.cancelled():
                outer.cancel()
                outer.set_running_or_notify_cancel()
                return
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            if journal is not None:
                self.record_ack(tenant, journal.last_seq)
            outer.set_result(f.result())

        fut.add_done_callback(_ack)
        return outer

    # -- dispatch facade (models bind to this) -------------------------------

    def execute_sync(self, target: str, kind: str, payload: Any,
                     nkeys: int = 0, **kw):
        # Sync facade mirroring ServingLayer.execute_sync; the wait inherits
        # whatever bound the underlying dispatch enforces.
        return self.execute_async(target, kind, payload, nkeys, **kw).result()

    def execute_many(self, staged: Sequence[Tuple[str, str, Any, int]], **kw):
        """Batches stay on the primary unsplit: one admission decision, one
        deadline, journal-ordered. A serve-layer primary pushes acks itself
        through its per-future callbacks; a raw executor primary gets the
        router's inline callbacks here, so batched writes advance the
        tenant's read-your-writes pin on every primary flavor."""
        self._await_unfenced()
        futures = self._primary.execute_many(staged, **kw)
        if self._inline_acks and futures:
            tenant = self._resolve_tenant(kw.get("tenant"))
            futures = [self._track_write_ack(fut, kind, tenant)
                       for (_, kind, _, _), fut in zip(staged, futures)]
        return futures

    def batch(self, **submit_kwargs):
        # Collect against the router, not the primary: dispatch funnels
        # through execute_many above, so fencing and RYW ack tracking
        # apply to RBatch pipelines too.
        return BatchCollector(self, **submit_kwargs)

    def __getattr__(self, name: str):
        # Everything else (backend, queue_depth, tenant context, executor,
        # barrier helpers, ...) is the primary's business.
        primary = self.__dict__.get("_primary")
        if primary is None:  # early-init / copy protocols: no delegation yet
            raise AttributeError(name)
        return getattr(primary, name)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            replicas = list(self._replicas)
            tenants_pinned = len(self._acked)
        journal = self._journal
        return {
            "replicas": len(replicas),
            "primary_seq": journal.last_seq if journal is not None else 0,
            "replica_reads": self.replica_reads,
            "primary_fallbacks": self.primary_fallbacks,
            "primary_reads": self.primary_reads,
            "replica_moved_retries": self.replica_moved_retries,
            "tenants_pinned": tenants_pinned,
            "watermarks": {r.name: r.applied_seq for r in replicas},
        }
