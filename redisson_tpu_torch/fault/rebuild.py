"""Self-healing HBM rebuild: quarantine -> re-materialize from host
truth -> resume (or degrade) (counterpart of `redisson_tpu.fault.rebuild`).

The host keeps the durable truth and the card's planes are a rebuildable
projection: barrier-consistent snapshots, a write-ahead journal whose order
IS the apply order, and per-name restore (`load_checkpoint(names=...)` +
`notify_restored`). This module closes the loop:

  1. QUARANTINE the affected targets: new writes are rejected at the
     executor's enqueue guard with `TargetQuarantinedError` (retryable),
     already-queued writes are swept the same way, and a dispatcher
     barrier settles everything staged before the fault;
  2. RE-MATERIALIZE from host truth: newest snapshot restore for the
     targets (per-name hll_import/bits_import overwrite the bank rows and
     cell tensors whole), then journal-suffix replay filtered to the
     targets using recover.py's group-ordered window (apply order ==
     journal order). Targets absent from the snapshot are deleted first so
     replay recreates them from zero instead of merging into lost rows;
  3. RESUME: read-cache epochs were bumped by the restore path
     (`notify_restored`), a breaker board (when one is given) force-closes
     the kind, and the quarantine lifts;
  4. DEGRADE on failure: targets move to the degraded set — reads keep
     serving (best-effort device state), writes fail fast with
     `TargetDegradedError` (NOT retryable) — instead of wedging the
     dispatcher.

A sticky CUDA error (DeviceLostFault from a real illegal access, a
device-side assert, ...) leaves the process's CUDA context unusable: the
re-apply in step 2 raises again, so such a rebuild fails and its targets
degrade, the same branch as any failed rebuild. Recovery from a lost
context is a restart: a new process whose client opens the same persist
directory with `PersistConfig.auto_recover` (the default) loads the newest
snapshot and replays the journal suffix on a fresh context. Injected
faults and transient errors leave the context whole and rebuild in place.

With a serving layer the client passes its breaker board (forced open at
quarantine, force-closed after a rebuild); without one, `breakers=None`.

Replayed ops DO re-journal (the journal hook stays attached for
concurrent live traffic to healthy targets); the rebuild ends with a
snapshot cut when persistence is configured, which truncates the covered
segments, so the duplicates never survive to a later recovery. The
sketch-tier kinds being replayed (hll/bloom merges, bitset set/clear,
delete) are idempotent re-applies, so even a failed post-rebuild
snapshot only costs journal bytes, not correctness.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

from redisson_tpu_torch import executor as executor_mod
from redisson_tpu_torch.fault import taxonomy
from redisson_tpu_torch.fault.taxonomy import (
    TargetDegradedError,
    TargetQuarantinedError,
)

_write_kinds_cache = None


def write_kinds() -> frozenset:
    """Kinds the command registry marks write=True — what quarantine and
    degradation reject. Lazy: the registry import is cheap but circular
    at module-import time."""
    global _write_kinds_cache
    if _write_kinds_cache is None:
        from redisson_tpu_torch.commands import OP_TABLE

        _write_kinds_cache = frozenset(
            kind for kind, d in OP_TABLE.items() if d.write)
    return _write_kinds_cache


class RebuildCoordinator:
    """Owns the quarantine/degraded sets and runs rebuilds.

    Wired by FaultManager: `guard` installs as the executor's enqueue-
    time fault guard; `on_fault` installs as the executor's fault
    listener (and the watchdog's on_trip). Rebuilds run on their own
    thread — never on the dispatcher or a completer, both of which the
    replay itself needs alive."""

    def __init__(self, client, breakers=None):
        self._client = client
        self._breakers = breakers  # serve BreakerBoard or None
        self._lock = executor_mod.make_lock("rebuild.RebuildCoordinator._lock")
        # One rebuild at a time: concurrent rebuilds (two faults landing on
        # different targets) would race each other's snapshot restore and
        # post-rebuild snapshot cut. Rebuilds are rare; serialize them.
        self._serial = executor_mod.make_lock("rebuild.RebuildCoordinator._serial")
        self._quarantined: set = set()
        self._degraded: set = set()
        self._tls = threading.local()  # .bypass on the rebuild thread
        self._threads: list = []
        self._closed = False
        # counters for the fault.* gauges
        self.quarantined_total = 0
        self.rebuilt_total = 0
        self.rebuild_failures = 0
        self.last_rebuild_s = 0.0
        self.replayed_total = 0
        self.last_error: Optional[str] = None

    # -- executor hooks -----------------------------------------------------

    def guard(self, kind: str, target: str) -> Optional[Exception]:
        """Enqueue-time write guard (runs under the executor lock: set
        lookups only). Returns the exception to fail the op with, or
        None to admit."""
        if not self._quarantined and not self._degraded:
            return None
        if getattr(self._tls, "bypass", False):
            return None
        if not target or kind not in write_kinds():
            return None
        if target in self._degraded:
            return TargetDegradedError(
                f"target {target!r} is degraded to read-only: HBM rebuild "
                f"failed; writes need operator recovery", seam="rebuild")
        if target in self._quarantined:
            return TargetQuarantinedError(
                f"target {target!r} is quarantined while its HBM planes "
                f"rebuild from snapshot+journal; retry", seam="rebuild")
        return None

    def on_fault(self, kind: str, targets: Iterable[str], exc) -> None:
        """Fault listener: a run retired with StateUncertainFault /
        DeviceLostFault. Quarantine its targets and rebuild async."""
        with self._lock:
            if self._closed:
                return
            fresh = sorted(
                t for t in targets
                if t and t not in self._quarantined and t not in self._degraded)
            if not fresh:
                return
            self._quarantined.update(fresh)
            self.quarantined_total += len(fresh)
        if self._breakers is not None and kind:
            try:
                self._breakers.get(kind).force_open()
            except Exception:
                # best-effort load shedding; the rebuild must run regardless
                pass
        t = threading.Thread(
            target=self._rebuild_and_report, args=(tuple(fresh), kind),
            name="redisson-torch-rebuild", daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    # -- rebuild ------------------------------------------------------------

    def _rebuild_and_report(self, targets: tuple, kind: str) -> None:
        t0 = time.monotonic()
        try:
            with self._serial:
                # rebuild serialization IS the point of _serial: one barrier-driven rebuild at a time; nothing else ever takes _serial, so the held blocking cannot deadlock
                self._rebuild(targets)
        except Exception as exc:
            # rebuild is the recovery path itself — on any failure the targets degrade instead of re-raising into a daemon thread
            with self._lock:
                self._quarantined.difference_update(targets)
                self._degraded.update(targets)
                self.rebuild_failures += 1
                self.last_error = f"{type(exc).__name__}: {exc}"
            return
        finally:
            self.last_rebuild_s = time.monotonic() - t0
        with self._lock:
            self._quarantined.difference_update(targets)
            self.rebuilt_total += len(targets)
        if self._breakers is not None and kind:
            try:
                self._breakers.get(kind).force_close()
            except Exception:
                # breaker close is best-effort; HALF_OPEN probing recovers it anyway
                pass

    def _rebuild(self, targets: tuple) -> None:
        client = self._client
        executor = client._executor
        persist = client.persist
        self._tls.bypass = True
        try:
            # 1. Cancel queued dependents (retryable: they re-land after
            #    the rebuild) and settle everything already staged —
            #    dispatch-time-state backends commit on the dispatcher, so
            #    the barrier is a consistency cut over the fault point.
            executor.sweep_queued(
                targets,
                lambda op: TargetQuarantinedError(
                    f"target {op.target!r} quarantined mid-queue for HBM "
                    f"rebuild; retry", seam="rebuild"))
            executor.execute_barrier(lambda: None).result(timeout=120)
            if persist is None or persist.journal is None:
                # No host truth beyond device state: nothing to rebuild
                # from. Degrade (the caller maps this to the degraded set).
                raise taxonomy.FatalFault(
                    "rebuild needs Config.persist (snapshot+journal) as "
                    "host truth; none configured", seam="rebuild")
            # 2. Durability point: make the journal suffix visible to the
            #    reader below (appends buffer in-process until sync). The
            #    end-seq captured HERE bounds the replay: everything this
            #    rebuild appends afterwards (the zeroing deletes below, the
            #    replay's own re-journaled ops) carries a higher seq and
            #    must not feed back into the same replay pass.
            persist.journal.sync()
            end_seq = persist.journal.last_seq
            from redisson_tpu_torch.persist.snapshotter import find_snapshots

            watermark = 0
            snaps = find_snapshots(persist.cfg.dir)
            restored: set = set()
            if snaps:
                watermark, snap_path = snaps[-1]
                from redisson_tpu_torch import checkpoint

                in_snap = [n for n in checkpoint.info(snap_path).get(
                    "objects", {}) if n in targets]
                if in_snap:
                    client.load_checkpoint(snap_path, names=in_snap)
                    restored.update(in_snap)
            # Targets with no snapshot entry: host truth says their state
            # is (nothing) + journal suffix — zero the lost rows so replay
            # rebuilds from scratch instead of merging into corrupt state.
            for t in targets:
                if t not in restored:
                    executor.execute_async(t, "delete", None).result(
                        timeout=120)
            # 3. Journal-suffix replay filtered to the targets, with
            #    recover.py's group-ordered window contract.
            self.replayed_total += _replay_filtered(
                executor, persist.cfg.dir, watermark, frozenset(targets),
                upto=end_seq)
            # 4. Epoch bump for anything the restore path didn't cover.
            sketch = getattr(client._routing, "sketch", None)
            if sketch is not None and hasattr(sketch, "notify_restored"):
                for t in targets:
                    sketch.notify_restored(t)
            # 5. Cut a snapshot of the healed state so the re-journaled
            #    replay records are truncated away (see module docstring).
            try:
                persist.snapshot()
            except Exception:
                # snapshot here only bounds journal growth; replayed kinds re-apply idempotently on a later recovery
                pass
        finally:
            self._tls.bypass = False

    # -- lifecycle / introspection ------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting faults and wait for in-flight rebuilds."""
        with self._lock:
            self._closed = True
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=timeout)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Test hook: block until no rebuild thread is running."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                if not self._threads and not self._quarantined:
                    return True
            time.sleep(0.005)
        return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "quarantined": sorted(self._quarantined),
                "degraded": sorted(self._degraded),
                "quarantined_total": self.quarantined_total,
                "rebuilt_total": self.rebuilt_total,
                "rebuild_failures": self.rebuild_failures,
                "replayed_total": self.replayed_total,
                "last_rebuild_s": self.last_rebuild_s,
                "last_error": self.last_error,
            }


def _replay_filtered(executor, path: str, watermark: int,
                     targets: frozenset, upto: int = 0,
                     replay_window: int = 1024) -> int:
    """recover.py's group-ordered replay, filtered to `targets` and (when
    `upto` > 0) bounded to seqs <= upto — the suffix that existed when the
    rebuild cut its durability point. The group-boundary full drain
    preserves the journal's global order among the filtered records
    (delete/rename boundaries within one target are the case that
    matters here)."""
    from redisson_tpu_torch.persist.journal import iter_records

    replayed = 0
    errors = 0
    pending: deque = deque()

    def drain(down_to: int) -> int:
        failed = 0
        while len(pending) > down_to:
            fut = pending.popleft()
            try:
                fut.result(timeout=120)
            except Exception:
                # replayed ops may fail exactly as they failed live — write-ahead ordering journals the attempt; counted, not fatal
                failed += 1
        return failed

    group = None
    for rec in iter_records(path, from_seq=watermark):
        if upto and rec.seq > upto:
            break
        if rec.target not in targets:
            continue
        key = (rec.kind, rec.target)
        if key != group:
            errors += drain(0)
            group = key
        elif len(pending) >= replay_window:
            errors += drain(replay_window // 2)
        pending.append(
            executor.execute_async(rec.target, rec.kind, rec.payload))
        replayed += 1
    errors += drain(0)
    return replayed
