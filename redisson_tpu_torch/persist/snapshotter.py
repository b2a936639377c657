"""Background snapshots + journal truncation, the BGSAVE / AOF-rewrite
analogue (counterpart of `redisson_tpu.persist.snapshotter`, same snapshot
directories).

A snapshot is cut through the executor's barrier primitive: the cut
callable runs inline on the dispatcher thread, where — because both engine
tiers commit observable state at stage time and journal records are
appended on the same thread — it sees exactly the state produced by the
journal prefix `[1..last_seq]`.

The JAX package's cut keeps array handles (immutable there, so a handle IS
a snapshot). Here the cell tensors and the HLL bank are mutated in place by
later runs: a kept handle would be written to disk after later traffic
changed it, the snapshot would hold state from past its journal watermark,
and recovery would apply that suffix twice (harmless for max/OR merges,
wrong for bitset clears and deletes). So the cut clones every object on
the compute stream (`TorchBackend.snapshot_cut`); the structure tier
pickles its keyspace. The device-to-host copies and the checkpoint.save
happen afterwards on the snapshotter's thread while traffic keeps flowing,
one object at a time, each clone freed as its host copy lands.

At the cut the journal also rotates, so the snapshot watermark falls on a
segment boundary; once the snapshot is durably on disk every wholly-covered
segment is deleted. Recovery cost is therefore bounded by one snapshot plus
one segment suffix, whatever the uptime.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch import checkpoint
from redisson_tpu_torch.executor import Op, make_lock
from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.fault.taxonomy import classify

SNAPSHOT_PREFIX = "snap-"
STRUCTURES_FILE = "structures.bin"


def find_snapshots(path: str) -> List[Tuple[int, str]]:
    """Sorted (journal_seq, snapshot_dir) for every readable snapshot under
    a persist directory. Trusts the manifest watermark, not the dirname —
    and checkpoint.info's `.old` fallback keeps a half-swapped snapshot
    usable."""
    out = []
    if not os.path.isdir(path):
        return out
    for name in os.listdir(path):
        if not name.startswith(SNAPSHOT_PREFIX) or name.endswith(".old"):
            continue
        full = os.path.join(path, name)
        try:
            manifest = checkpoint.info(full)
        except (OSError, ValueError):
            continue
        out.append((int(manifest.get("journal_seq", 0)), full))
    out.sort()
    return out


class Snapshotter:
    """Periodic (or on-demand) snapshot of one client's full state.

    Serializes with itself: overlapping snapshot_now() calls queue on an
    internal lock, so at most one snapshot is being written at a time.
    """

    def __init__(self, client, journal, path: str, interval_s: float = 0.0,
                 keep: int = 2, cut_timeout_s: float = 120.0):
        self._client = client
        self._journal = journal
        self.path = os.path.abspath(path)
        self._interval_s = float(interval_s)
        self._keep = max(1, int(keep))
        self._cut_timeout_s = cut_timeout_s
        self._lock = make_lock("snapshotter.Snapshotter._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.snapshots_taken = 0
        self.last_seq = 0
        self.last_duration_s = 0.0
        # Seconds the last cut held the dispatcher (the traffic stall).
        self.last_cut_s = 0.0
        self.last_path: Optional[str] = None
        self.last_error: Optional[str] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="redisson-torch-snapshotter",
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._cut_timeout_s)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.snapshot_now()
            except Exception as exc:  # keep the period alive; surface via stats
                exc = classify(exc, seam="snapshot_io")
                self.last_error = f"{type(exc).__name__}: {exc}"

    # -- the snapshot itself ------------------------------------------------

    def _cut(self) -> Tuple[int, Dict[str, Any], Optional[bytes]]:
        """Dispatcher-thread consistency cut: the journal watermark, a clone
        of every sketch and the structure tier's pickled keyspace, then a
        journal rotation so the watermark seals a segment."""
        t0 = time.perf_counter()
        routing = self._client._routing
        cut = routing.sketch.snapshot_cut()
        structures = getattr(routing, "structures", None)
        blob = structures.dump_state() if structures is not None else None
        seq = self._journal.last_seq
        self._journal.rotate()
        self._reseed_ownership()
        self.last_cut_s = time.perf_counter() - t0
        return seq, cut, blob

    def _reseed_ownership(self) -> None:
        """A cluster shard keeps its slot ownership ONLY in journal records
        (the guard's migrate_adopt / begin / flip stream, cluster/shard.py):
        the rotation above would orphan it from the new segment, so the
        guard's current owned and migrating sets become the segment's first
        records. Runs on the dispatcher inside the cut barrier (the only
        thread that mutates them), so the sets are exact at the watermark."""
        routing = self._client._routing
        if getattr(routing, "owner_table", None) is not None:
            self._reseed_mesh_ownership(routing)
            return
        owned_fn = getattr(routing, "owned_slots", None)
        if owned_fn is None:  # not a cluster shard
            return
        owned = owned_fn()
        if owned is None:  # open ownership: replay's default, nothing to pin
            return
        reseed = [Op(target="", kind="migrate_adopt",
                     payload={"slots": sorted(owned)})]
        migrating = self._client._routing.migrating_slots()
        if migrating:
            reseed.append(Op(target="", kind="migrate_begin",
                             payload={"slots": sorted(migrating)}))
        for op in reseed:
            self._journal.append_run(op.kind, [op])

    def _reseed_mesh_ownership(self, guard) -> None:
        """The mesh data plane's one journal carries every logical shard's
        ownership, each record naming its shard in the payload: re-seed
        the whole owner table and every shard's migrating set."""
        table = guard.owner_table()
        if table is None:  # open ownership: nothing to pin
            return
        by_shard: Dict[int, list] = {}
        for slot, shard in table.items():
            by_shard.setdefault(shard, []).append(slot)
        reseed = [Op(target="", kind="migrate_adopt",
                     payload={"slots": sorted(slots), "shard": shard})
                  for shard, slots in sorted(by_shard.items())]
        for shard in range(guard.num_shards):
            migrating = guard.migrating_slots(shard)
            if migrating:
                reseed.append(Op(target="", kind="migrate_begin",
                                 payload={"slots": sorted(migrating),
                                          "shard": shard}))
        for op in reseed:
            self._journal.append_run(op.kind, [op])

    @staticmethod
    def _host_objects(cut: Dict[str, Any]) -> Dict[str, tuple]:
        """Host copies of a cut, one object at a time: each clone is
        dropped as soon as its copy has landed, so at most one clone's
        pinned staging buffer is live at once."""
        out: Dict[str, tuple] = {}
        objects = cut["objects"]
        for name in list(objects):
            otype, state, meta, version = objects.pop(name)
            out[name] = (otype, checkpoint.host_copy(state), meta, version)
            del state
        bank = cut.pop("bank")
        if bank is not None:
            host = checkpoint.host_copy(bank)
            del bank
            for name, (row, version) in cut["rows"].items():
                out[name] = ("hll", host[row].astype("uint8"), {}, version)
        return out

    def snapshot_now(self) -> str:
        """Take one full snapshot; returns its directory. Blocks until the
        snapshot is durable and superseded journal segments are deleted."""
        with self._lock:
            t0 = time.monotonic()
            # Fault seam: snapshot I/O failures are pre-commit for callers
            # (the previous snapshot + journal remain authoritative).
            fault_inject.fire("snapshot_io")
            fut = self._client._executor.execute_barrier(self._cut)
            seq, cut, blob = fut.result(timeout=self._cut_timeout_s)
            # Off the dispatcher now: host copies and the write.
            extra_objects = self._host_objects(cut)
            snap_path = os.path.join(self.path, f"{SNAPSHOT_PREFIX}{seq:020d}")
            checkpoint.save(
                self._client._store, snap_path, names=[],
                extra_objects=extra_objects,
                manifest_extra={"journal_seq": seq},
                extra_files=({STRUCTURES_FILE: blob} if blob is not None else None),
            )
            self._journal.remove_segments_below(seq)
            self._prune()
            self.snapshots_taken += 1
            self.last_seq = seq
            self.last_duration_s = time.monotonic() - t0
            self.last_path = snap_path
            self.last_error = None
            return snap_path

    def _prune(self) -> None:
        snaps = find_snapshots(self.path)
        for _, snap_path in snaps[:-self._keep]:
            shutil.rmtree(snap_path, ignore_errors=True)
            shutil.rmtree(snap_path + ".old", ignore_errors=True)

    def disk_bytes(self) -> int:
        """On-disk bytes across kept snapshot directories; tolerant of a
        concurrent prune removing files mid-walk."""
        total = 0
        for _, snap_path in find_snapshots(self.path):
            for root, _dirs, files in os.walk(snap_path):
                for f in files:
                    try:
                        total += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass
        return total

    def disk_bytes(self) -> int:
        """On-disk bytes across kept snapshot directories (the memstat
        'disk' meter); tolerant of a concurrent prune."""
        total = 0
        for _, snap_path in find_snapshots(self.path):
            for root, _dirs, files in os.walk(snap_path):
                for f in files:
                    try:
                        total += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass
        return total

    def stats(self) -> Dict[str, Any]:
        return {
            "snapshots_taken": self.snapshots_taken,
            "last_seq": self.last_seq,
            "last_duration_s": self.last_duration_s,
            "last_cut_s": self.last_cut_s,
            "last_path": self.last_path,
            "last_error": self.last_error,
            "interval_s": self._interval_s,
            "keep": self._keep,
        }
