"""SlotMigrator — live slot migration, never blocking writes (counterpart
of `redisson_tpu.cluster.migrator`; the snapshot and journal formats are
the JAX package's).

The persist follower protocol (persist/follower.py), specialized to a slot
subset and finished with an atomic ownership flip:

  1. **subscribe** — attach a listener to the source shard's journal
     BEFORE anything else: every record committed from here on lands in
     our queue, so the snapshot watermark below can never race a write;
  2. **mark** — journal `migrate_begin` on the source (recovery of a
     crashed source replays the mark and knows a migration was in flight);
  3. **snapshot bootstrap** — cut a barrier-consistent source snapshot
     (persist.snapshot(): the dispatcher clones the state at the cut) and
     import only the migrating slots into the target THROUGH its executor
     (hll_import / bits_import / migrate_install are journaled writes, so
     a target crash after migration recovers the adopted state);
  4. **journal-suffix catch-up** — apply queued records with
     seq > watermark, filtered to the migrating slots, onto the target in
     journal order (group-boundary drains, exactly recover.py/follower.py:
     apply order == commit order);
  5. **cutover** — open the router's ASK window for the migrating slots
     (new submissions for those slots park; all other slots flow), journal
     `migrate_flip` on the source — its seq is the cutover point: every
     source record before it is caught up below, every keyed op the source
     dispatches after it fails with SlotMovedError and re-routes. Drain
     the queue up to the flip record, `migrate_adopt` on the target, flip
     the router table, release the window. Parked and rejected ops land on
     the target exactly once — zero lost acks, digest-identical to a
     no-migration run.

Reference: redis cluster resharding (MIGRATE + SETSLOT IMPORTING/NODE,
`ClusterConnectionManager.java` topology flips); the snapshot+suffix shape
is the same one `JournalFollower` uses for warm standbys.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from redisson_tpu_torch import checkpoint
from redisson_tpu_torch.cluster.shard import CLUSTER_KINDS, ClusterShard
from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.persist.follower import slots_record_filter
from redisson_tpu_torch.persist.journal import JournalRecord, iter_records
from redisson_tpu_torch.persist.snapshotter import STRUCTURES_FILE
from redisson_tpu_torch.structures.engine import filter_state_dump

# Records that are keyspace-wide or control-plane: never slot-filtered onto
# the target (the router fans flushall/script ops to every shard directly,
# and migrate_* records are the source's own ownership bookkeeping).
_SKIP_KINDS = CLUSTER_KINDS | {"flushall", "script_load", "script_flush",
                               "script_eval"}


class MigrationError(RuntimeError):
    pass


class SlotMigrator:
    """One live migration of `slots` from `source` to `target`."""

    def __init__(self, router, source: ClusterShard, target: ClusterShard,
                 slots, apply_window: int = 1024,
                 cutover_lag: int = 256, timeout_s: float = 120.0):
        self.router = router
        self.source = source
        self.target = target
        self.slots = frozenset(int(s) for s in slots)
        self._slot_filter = slots_record_filter(self.slots)
        self._apply_window = apply_window
        self._cutover_lag = cutover_lag
        self._timeout_s = timeout_s
        self._queue: List[JournalRecord] = []
        self._qlock = make_lock("migrator.SlotMigrator._qlock")
        # The source journal object we are subscribed to; a per-shard
        # failover swaps the live journal (promotee epoch dir, same global
        # seq numbering) and _sync_source_journal re-subscribes.
        self._journal = None
        self.stats: Dict[str, int] = {
            "bootstrapped_objects": 0, "bootstrapped_structures": 0,
            "caught_up_records": 0, "apply_errors": 0, "apply_retries": 0,
            "source_failovers": 0, "aborts": 0,
        }

    # -- journal listener ----------------------------------------------------

    def _on_records(self, records: List[JournalRecord]) -> None:
        with self._qlock:
            self._queue.extend(records)

    def _drain_queue(self) -> List[JournalRecord]:
        with self._qlock:
            out, self._queue = self._queue, []
        if len(out) > 1:
            # A failover backfill can interleave with live listener
            # appends: replay strictly in seq order, once per seq.
            out.sort(key=lambda r: r.seq)
            deduped, last = [], -1
            for rec in out:
                if rec.seq != last:
                    deduped.append(rec)
                    last = rec.seq
            out = deduped
        return out

    def _sync_source_journal(self, applied: int) -> None:
        """Failover-under-migration (source side): the source shard
        promoted a replica, so its live journal is a NEW object in an
        epoch dir CONTINUING the global seq numbering. Re-subscribe the
        listener and backfill what the promotee committed before the
        listener landed — `flush + read file` closes the gap, and the
        drain's seq dedup absorbs the overlap with live appends. Called
        from the single protocol thread, so no drain races the swap."""
        current = self.source.journal
        if current is None or current is self._journal:
            return
        old = self._journal
        current.add_listener(self._on_records)
        if old is not None:
            old.remove_listener(self._on_records)
        self._journal = current
        # Records appended before our listener attached are in the new
        # journal's buffer/file; sync() flushes the buffered tail so the
        # file read below sees everything pre-attach.
        current.sync()
        backfill = [r for r in iter_records(current.path, from_seq=applied)
                    if r.seq > applied]
        if backfill:
            with self._qlock:
                self._queue.extend(backfill)
        self.stats["source_failovers"] += 1

    # -- record filtering (the slot-filtered replay) -------------------------

    def _filter(self, rec: JournalRecord) -> Optional[JournalRecord]:
        if rec.kind in _SKIP_KINDS:
            return None
        return self._slot_filter(rec)

    # -- group-ordered apply (follower._apply idiom) -------------------------

    def _apply(self, records: List[JournalRecord]) -> None:
        if not records:
            return
        executor = self.target.executor
        futures: List = []

        def drain() -> None:
            for rec, fut in futures:
                try:
                    fut.result(timeout=self._timeout_s)
                except Exception:
                    # A record may fail exactly as it failed live on the
                    # source (counted), unless the TARGET failed over
                    # mid-apply: then it re-drives through the promotee.
                    if not self._retry_failover_apply(rec, executor):
                        self.stats["apply_errors"] += 1
            futures.clear()

        group = None
        for rec in records:
            key = (rec.kind, rec.target)
            if key != group:
                drain()
                group = key
            futures.append(
                (rec,
                 executor.execute_async(rec.target, rec.kind, rec.payload)))
        drain()
        self.stats["caught_up_records"] += len(records)

    def _snapshot_source(self) -> str:
        """Cut the bootstrap snapshot on the source's CURRENT primary. A
        failover racing the cut leaves the captured persist fenced (its
        snapshotter re-seeds ownership through the fenced journal and
        fails); ride it out by re-resolving `source.persist` until the
        promotee's epoch persistence is installed and cutting there —
        the promotee's snapshot is simply a later, equally consistent
        bootstrap point."""
        deadline = time.monotonic() + self._timeout_s
        while True:
            persist = self.source.persist
            try:
                return persist.snapshot()
            except Exception:
                if time.monotonic() >= deadline:
                    raise
                journal = persist.journal if persist is not None else None
                fenced = journal is not None and journal.fenced
                if self.source.persist is persist and not fenced:
                    raise  # genuine snapshot error, not a failover race
                time.sleep(0.02)

    def _retry_failover_apply(self, rec: JournalRecord,
                              failed_executor) -> bool:
        """Failover-under-migration (target side): a record that failed
        against a dead or already-replaced target executor re-applies
        through the promotee once it is installed. A record that failed
        against the LIVE current executor is a genuine replay error
        (mirrors how it failed live on the source) and is not retried.
        Re-driving is at-least-once across the fence race — the same
        semantics as a retried redis MIGRATE."""
        deadline = time.monotonic() + self._timeout_s
        while time.monotonic() < deadline:
            current = self.target.executor
            if current is failed_executor:
                try:
                    if current.is_alive():
                        return False
                except Exception:  # cannot answer: treat as dead, wait
                    pass
                time.sleep(0.02)  # failover in flight; promotee pending
                continue
            try:
                current.execute_sync(rec.target, rec.kind, rec.payload)
            except Exception:  # fails on the promotee too: a replay error
                return False
            self.stats["apply_retries"] += 1
            return True
        return False

    # -- bootstrap ------------------------------------------------------------

    def _bootstrap(self, snap_path: str) -> None:
        """Import the migrating slots' objects from the source snapshot into
        the target THROUGH its executor — journaled writes, unlike a direct
        store restore, so the target's own recovery covers them."""
        manifest = checkpoint.info(snap_path)
        names = [n for n in manifest.get("objects", {})
                 if key_slot(n) in self.slots]
        if names:
            # Honor the same .old fallback as checkpoint.load().
            path = snap_path
            if not os.path.exists(os.path.join(path, checkpoint.MANIFEST)):
                path = snap_path + ".old"
            executor = self.target.executor
            with np.load(os.path.join(path, checkpoint.STATE)) as z:
                for name in names:
                    info = manifest["objects"][name]
                    host = z[checkpoint._KEY_PREFIX + name]
                    meta = dict(info.get("meta") or {})
                    if info["otype"] == "hll":
                        executor.execute_sync(name, "hll_import",
                                              {"regs": host})
                        store = getattr(self.target.client, "_store", None)
                        obj = store.get(name) if store is not None else None
                        if obj is not None and meta:
                            obj.meta.update(meta)
                    else:  # bitset / bloom
                        executor.execute_sync(
                            name, "bits_import",
                            {"otype": info["otype"], "array": host,
                             "meta": meta})
                    self.stats["bootstrapped_objects"] += 1
        blob = checkpoint.extra_file(snap_path, STRUCTURES_FILE)
        if blob is not None:
            filtered, count = filter_state_dump(
                blob, lambda name: key_slot(name) in self.slots)
            if count:
                self.target.executor.execute_sync(
                    "", "migrate_install", {"blob": filtered})
                self.stats["bootstrapped_structures"] = count

    # -- the protocol ---------------------------------------------------------

    def run(self) -> Dict[str, int]:
        src_persist = self.source.persist
        if src_persist is None or src_persist.journal is None:
            raise MigrationError(
                "live migration needs the source shard's journal "
                "(Config.cluster persists each shard)")
        self._journal = src_persist.journal
        self._journal.add_listener(self._on_records)
        cutover_open = False
        flip_attempted = False
        try:
            self.source.begin_migrate(self.slots, self.target.shard_id)
            # The SETSLOT IMPORTING analogue: the target's guard must accept
            # keyed bootstrap/catch-up writes for slots it does not own yet.
            # Journaled, so a target crash mid-migration replays the same
            # acceptance before the replayed imports reach its guard.
            self.target.begin_migrate(self.slots, self.target.shard_id)
            snap_path = self._snapshot_source()
            watermark = int(checkpoint.info(snap_path).get("journal_seq", 0))
            self._bootstrap(snap_path)

            # Catch-up: chase the live suffix until we're close enough to
            # cut over. Writes keep flowing to the source the whole time —
            # and a source failover mid-chase swaps the journal underneath
            # us: _sync_source_journal resumes the suffix against the
            # promotee's continuing global seq.
            applied = watermark
            deadline = time.monotonic() + self._timeout_s
            while True:
                self._sync_source_journal(applied)
                pending = [r for r in self._drain_queue() if r.seq > applied]
                if pending:
                    applied = pending[-1].seq
                    self._apply([r for r in
                                 (self._filter(rec) for rec in pending)
                                 if r is not None])
                if self._journal.last_seq - applied <= self._cutover_lag \
                        and not self._journal.fenced:
                    # A fenced journal mid-failover is NOT converged: its
                    # last_seq is final but the promotee's continuation
                    # journal is about to carry the live suffix.
                    break
                if time.monotonic() > deadline:
                    raise MigrationError("catch-up never converged")

            # Cutover: park NEW submissions for the migrating slots (the
            # ASK window), then journal the flip — its seq is the fence.
            self.router.begin_cutover(self.slots)
            cutover_open = True
            flip_attempted = True
            self.source.flip(self.slots)
            flip_seq = None
            deadline = time.monotonic() + self._timeout_s
            while flip_seq is None:
                self._sync_source_journal(applied)
                for rec in self._drain_queue():
                    if rec.seq <= applied:
                        continue
                    if (rec.kind == "migrate_flip"
                            and self.slots.issubset(
                                {int(s) for s in rec.payload["slots"]})):
                        flip_seq = rec.seq
                        break
                    # Strictly pre-flip records replay; anything later for
                    # our slots was REJECTED on the source (journal append
                    # precedes the ownership check) and re-routes through
                    # the router's MOVED retry — applying it here would
                    # double-apply.
                    filtered = self._filter(rec)
                    if filtered is not None:
                        self._apply([filtered])
                    applied = rec.seq
                if flip_seq is None:
                    if time.monotonic() > deadline:
                        raise MigrationError("flip record never surfaced")
                    time.sleep(0.001)
            self.target.adopt(self.slots)
            self.router.commit_cutover(self.slots, self.target.shard_id)
            cutover_open = False
            return dict(self.stats)
        except BaseException:
            self._rollback(flip_attempted)
            raise
        finally:
            if cutover_open:
                self.router.abort_cutover()
            if self._journal is not None:
                self._journal.remove_listener(self._on_records)

    def _rollback(self, flip_attempted: bool) -> None:
        """Abort to a RETRYABLE journaled state: no slot stays stranded in
        `migrating`, and no slot goes ownerless. When the flip may have
        landed (it journals before we could observe the failure) the
        source RE-ADOPTS the slots — adopt is a journaled union, so it is
        idempotent when the flip never actually committed. Both sides are
        best-effort: an abort caused by a dead shard can only clean up
        the living one, and recovery replay heals the rest."""
        try:
            if flip_attempted:
                self.source.adopt(self.slots)
            else:
                self.source.abort_migrate(self.slots)
        except Exception:  # a dead source heals by its own recovery replay
            pass
        try:
            self.target.abort_migrate(self.slots)
        except Exception:  # a dead target heals by its own recovery replay
            pass
        self.stats["aborts"] += 1
