"""ReplicaManager — fleet lifecycle, health probing, automatic failover
(counterpart of `redisson_tpu.replica.manager`).

Owns N ServingReplicas tailing the primary's journal dir, the
ReplicaRouter in front of the client's dispatch, and the failover state
machine:

  * health probe: every `health_interval_s` the primary's dispatcher is
    checked (`executor.is_alive()`); `health_failures` consecutive
    failures trip a failover (the Redisson `failedSlaveCheckInterval`
    story pointed at the master).
  * fault trigger: a retired `DeviceLostFault` observed through the
    FaultManager's listener fan-out trips the same path without waiting
    for a probe window.
  * failover(): FENCE the old primary first — its journal refuses further
    appends (in-flight writes fail before committing, so nothing is acked
    into a stream the fleet stops tailing) and the router holds new writes
    — then promote the highest-watermark replica (drain the fenced journal
    suffix) and enable journaling + persistence on the promoted client:
    its fresh journal CONTINUES the global seq numbering
    (`Journal(start_seq=watermark)`) and immediately snapshots, so
    surviving replicas `retarget()` with a PSYNC partial resync when they
    were caught up, or a clean full bootstrap from the new snapshot when
    they were behind (or somehow past the promotion watermark) — then
    repoint the router, which also releases the held writes onto the new
    primary. `rejoin()` re-bootstraps the demoted old primary's slot as a
    fresh replica.

`wait_for_replicas(n, timeout_s)` is the WAIT analogue: block until n
replicas have applied at least the primary's current committed seq.

Every replica is a full client on the primary's device (one card holds the
primary and its fleet), so replay and replica reads launch the same
kernels as the primary's own traffic, on the replicas' own tensors.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.fault.taxonomy import DeviceLostFault
from redisson_tpu_torch.replica.replica import ServingReplica
from redisson_tpu_torch.replica.router import ReplicaRouter


def replica_engine_config(primary_config):
    """Sanitized copy of the primary's engine Config for a replica's own
    client: codec, the `cuda` section (device and ingest: replay runs the
    same kernels on the same card), serve/trace/memory settings carry over
    (replay through a differently-configured engine silently diverges),
    while the subsystems a replica must not run are stripped — persist (a
    follower journaling the leader's ops would double-journal), replicas
    (no recursive fleets), faults (injection/watchdog belong to the
    primary) and a facade's cluster topology. A shard member's cluster section
    (shard_id >= 0) is KEPT: its replicas need the slot-ownership guard to
    replay the journaled migrate_* records, so the slot table survives a
    promotion. The geo section is stripped too (a replica is no site: it
    has no journal to ship); JAX's copy keeps it, so a JAX geo site with
    replicas fails to start. The redis durability tier and its
    `flush_interval_s` go, as in JAX's copy: only the primary flushes."""
    cfg = copy.deepcopy(primary_config)
    cfg.persist = None
    cfg.replicas = None
    cfg.faults = None
    cfg.geo = None
    if cfg.cluster is None or cfg.cluster.shard_id < 0:
        cfg.cluster = None
    cfg.redis = None
    cfg.flush_interval_s = 0.0
    return cfg


class ReplicaManager:
    def __init__(self, client, cfg):
        self._client = client
        self.cfg = cfg
        self.replicas: List[ServingReplica] = []
        self.router: Optional[ReplicaRouter] = None
        self.promotions = 0
        self.last_failover_reason = ""
        self.last_failover_s = 0.0
        self.last_fence_seq = 0
        self._epoch = 0
        self._next_index = 0
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._probe_failures = 0
        self._failover_lock = make_lock(
            "manager.ReplicaManager._failover_lock")
        self._failed_over = False
        self._fault_mgr = None
        self._primary_executor = None
        # The promoted follower (its client is the post-failover primary);
        # close() shuts it down, including the persistence we attached.
        self._promoted: Optional[ServingReplica] = None
        # Previous promotees demoted by cascading failovers — dead engines
        # whose teardown waits for close().
        self._retired: List[ServingReplica] = []
        self._base_dir = ""

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        client = self._client
        persist = client._persist
        if persist is None or persist.journal is None:
            raise ValueError(
                "Config.replicas requires Config.persist with a dir — "
                "replicas tail that journal as the replication stream")
        path = persist.cfg.dir
        self._base_dir = path  # epoch dirs derive from the original root
        for _ in range(max(0, self.cfg.num_replicas)):
            self._spawn_replica(path)
        self.router = ReplicaRouter(client._dispatch, persist.journal,
                                    self.cfg)
        self.router.set_replicas(self.replicas)
        serve = getattr(client, "serve", None)
        if serve is not None:
            serve.enable_ack_tracking(self.router)
        self._primary_executor = client._executor
        fault = getattr(client, "_fault", None)
        if fault is not None:
            fault.add_fault_listener(self._on_primary_fault)
            self._fault_mgr = fault
        elif client._executor.fault_listener is None:
            # No fault subsystem: observe retired device faults directly.
            client._executor.fault_listener = self._on_primary_fault
        if self.cfg.health_interval_s > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, name="redisson-torch-replica-probe",
                daemon=True)
            self._prober.start()

    def _spawn_replica(self, path: str) -> ServingReplica:
        rep = ServingReplica(self._next_index, path, self.cfg,
                             config=replica_engine_config(self._client.config))
        self._next_index += 1
        rep.start()
        self.replicas.append(rep)
        return rep

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=10.0)
            self._prober = None
        if self._fault_mgr is not None:
            self._fault_mgr.remove_fault_listener(self._on_primary_fault)
            self._fault_mgr = None
        for rep in self.replicas:
            rep.close()
        self.replicas = []
        if self._promoted is not None:
            # Shuts the promoted client down through the normal client
            # teardown, which drains + closes the persistence we attached.
            self._promoted.close(shutdown_client=True)
            self._promoted = None
        for rep in self._retired:
            rep.close(shutdown_client=True)
        self._retired = []

    # -- health probe / fault trigger ----------------------------------------

    def _probe_primary(self) -> bool:
        from redisson_tpu_torch.fault import inject

        executor = self._primary_executor
        try:
            # False-negative seam: an injected fault IS a failed probe —
            # chaos plans use it to drive a spurious failover against a
            # live primary (the fence must keep that split-brain-free).
            # Target = this fleet's base dir, so a plan can single out one
            # shard's prober in a multi-fleet (cluster) topology.
            inject.fire("health_probe", target=self._base_dir)
            return executor is not None and executor.is_alive()
        except Exception:
            # A probe that cannot even ask counts as a failed probe, not a
            # prober crash.
            return False

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.cfg.health_interval_s):
            if self._failed_over:
                # Protection is disarmed between a promotion and the
                # rejoin() that restores fleet capacity; the thread stays
                # alive so a SECOND primary loss is survivable.
                continue
            if self._probe_primary():
                self._probe_failures = 0
                continue
            self._probe_failures += 1
            if (self._probe_failures >= max(1, self.cfg.health_failures)
                    and self.cfg.auto_failover):
                try:
                    self.failover(
                        f"health probe failed {self._probe_failures}x")
                except Exception:
                    # An aborted promotion cleared the once-guard; the prober
                    # must survive to retry, not crash the protection thread.
                    pass
                self._probe_failures = 0

    def _on_primary_fault(self, kind, targets, exc) -> None:
        if not self.cfg.auto_failover or self._failed_over:
            return
        if isinstance(exc, DeviceLostFault):
            # Off the retire path: failover drains a journal suffix and
            # snapshots — never block the completer thread on that.
            threading.Thread(
                target=self.failover,
                args=(f"DeviceLostFault on {kind}",),
                name="redisson-torch-replica-failover", daemon=True).start()

    # -- failover ------------------------------------------------------------

    @property
    def primary_client(self):
        """The CURRENT primary's client: the latest promotee after a
        failover, the original client before one. Everything that must
        survive cascading failovers (the shard handle's guard/executor,
        the next failover's fence target) resolves through here."""
        return self._promoted.client if self._promoted is not None \
            else self._client

    def failover(self, reason: str = "manual"):
        """Promote the highest-watermark replica to primary. Returns the
        promoted client, or None when a failover already happened (the
        trigger paths race; first one wins) or the fleet is empty (nothing
        to promote; the flag stays clear so a later trigger can retry once
        replicas exist). An aborted promotion clears the once-guard too —
        a transient failure must not permanently disable protection."""
        with self._failover_lock:
            if self._failed_over:
                return None
            if not self.replicas:
                self.last_failover_reason = (
                    f"aborted ({reason}): no replicas to promote")
                return None
            self._failed_over = True
        t0 = time.monotonic()
        # FENCE FIRST, promote second. The old journal stops accepting
        # appends (in-flight writes fail before they commit, so nothing is
        # acked into a stream the fleet stops tailing), the router holds
        # new writes until the promotee is installed, and compaction stops
        # so the drain below can reach the fenced tip. Only after the fence
        # is any watermark read — last_seq is final from here on.
        # `primary_client` (not `self._client`): on a SECOND failover the
        # stream to fence is the previous promotee's epoch journal.
        self.router.fence_writes()
        old_primary = self.primary_client
        old_persist = old_primary._persist
        old_journal = old_persist.journal if old_persist is not None else None
        if old_journal is not None:
            old_journal.fence()
        if old_persist is not None:
            old_persist.stop_background()
        self.last_fence_seq = (old_journal.last_seq
                               if old_journal is not None else 0)
        try:
            best = max(self.replicas, key=lambda r: r.applied_seq)
            survivors = [r for r in self.replicas if r is not best]
            # Reads stop landing on the promotee while it drains.
            self.router.set_replicas(survivors)
            promoted = best.promote(catch_up=True,
                                    timeout_s=self.cfg.promote_timeout_s)
            # The promotion watermark: the promotee drained the fenced
            # journal to its tip, so this equals last_fence_seq — every
            # acked (= journaled) write is in the promoted state.
            watermark = best.applied_seq
            # Enable journaling + persistence on the new primary. The fresh
            # journal opens at seq watermark+1 (global numbering continues)
            # and the immediate snapshot is the full-resync source for any
            # replica that was behind the promotee.
            from redisson_tpu_torch.persist import PersistenceManager

            old_cfg = old_persist.cfg
            self._epoch += 1
            new_dir = f"{self._base_dir.rstrip(os.sep)}-epoch-{self._epoch}"
            pm = PersistenceManager(
                promoted,
                dataclasses.replace(old_cfg, dir=new_dir, auto_recover=False),
                start_seq=watermark)
            pm.start()
            promoted._persist = pm  # promoted client's shutdown tears it down
            pm.snapshot()
            # Installs the new write target AND lifts the write fence.
            self.router.set_primary(promoted._dispatch, pm.journal)
            self._primary_executor = promoted._executor
            for rep in survivors:
                # A survivor past the watermark applied old-journal seqs the
                # promotee never saw — retarget drops its state and
                # full-bootstraps instead of partial-resyncing over them.
                rep.retarget(new_dir, max_valid_seq=watermark)
            self.router.set_replicas(survivors)
        except BaseException:
            # Failed mid-promotion: release held writes — they land on the
            # old primary, whose fenced journal fails them cleanly rather
            # than acking into an abandoned stream. The fleet and the
            # once-guard roll back so a later trigger can retry (the
            # attempted promotee stays in the fleet; a re-promotion drains
            # from wherever its cursor stopped).
            self.router.set_replicas(self.replicas)
            self.router.unfence_writes()
            with self._failover_lock:
                self._failed_over = False
            raise
        if self._promoted is not None:
            # Cascading failover: the previous promotee's client is now the
            # demoted (dead) primary — close() tears it and its epoch
            # persistence down with the rest of the fleet.
            self._retired.append(self._promoted)
        self._promoted = best
        self.replicas = survivors
        self.promotions += 1
        self.last_failover_reason = reason
        self.last_failover_s = time.monotonic() - t0
        return promoted

    def rejoin(self) -> ServingReplica:
        """Re-bootstrap the demoted old primary's slot in the fleet: a
        fresh replica full-bootstraps from the current primary's snapshot
        and tails its journal. (In-process the old engine's state is gone
        with its executor; what 'returns' is its capacity.)"""
        if self.router is None:
            raise RuntimeError("replica manager not started")
        journal = self.router.journal
        rep = self._spawn_replica(journal.path)
        self.router.set_replicas(self.replicas)
        # Fleet capacity is restored: RE-ARM protection against the
        # promoted primary — the prober thread is still running (it idles
        # while _failed_over is set), so a second primary loss fails over
        # again instead of being ignored.
        self._probe_failures = 0
        with self._failover_lock:
            self._failed_over = False
        return rep

    # -- WAIT analogue -------------------------------------------------------

    def wait_for_replicas(self, n: int, timeout_s: float = 5.0) -> int:
        """Block until `n` replicas have applied at least the primary's
        current committed seq; returns how many have (possibly < n on
        timeout) — redis WAIT numreplicas/timeout semantics on the
        journal watermark."""
        journal = self.router.journal if self.router is not None else None
        watermark = journal.last_seq if journal is not None else 0
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            count = sum(1 for r in self.replicas
                        if r.applied_seq >= watermark)
            if count >= n or time.monotonic() >= deadline:
                return count
            time.sleep(0.002)

    # -- introspection -------------------------------------------------------

    def max_lag(self) -> int:
        return max((r.lag() for r in self.replicas), default=0)

    def min_watermark(self) -> int:
        return min((r.applied_seq for r in self.replicas), default=0)

    def full_resyncs(self) -> int:
        reps = self.replicas + ([self._promoted] if self._promoted else [])
        return sum(r._full_resyncs for r in reps)

    def partial_resyncs(self) -> int:
        reps = self.replicas + ([self._promoted] if self._promoted else [])
        return sum(r._partial_resyncs for r in reps)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "replicas": [r.stats() for r in self.replicas],
            "promotions": self.promotions,
            "failed_over": self._failed_over,
            "last_failover_reason": self.last_failover_reason,
            "last_failover_s": self.last_failover_s,
            "last_fence_seq": self.last_fence_seq,
            "epoch": self._epoch,
            "retired_primaries": len(self._retired),
            "full_resyncs": self.full_resyncs(),
            "partial_resyncs": self.partial_resyncs(),
            "router": self.router.snapshot() if self.router else {},
        }
