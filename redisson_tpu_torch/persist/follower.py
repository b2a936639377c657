"""Warm standby: a second engine instance that tails the leader's journal
(counterpart of `redisson_tpu.persist.follower`).

The follower owns a full client of its own with persistence OFF,
bootstraps from the leader's newest snapshot, then applies journal records
through its own executor — the same codepath as live traffic, so a
promoted follower is bit-identical to a recovered leader at the same
sequence number. With no config the client runs on the card (`Config()`
resolves `cuda:0`, and raises without one); a replica inherits the
primary's device through `replica/manager.replica_engine_config`. On a
card, replay launches the same kernels as the leader's live traffic.

Two tail modes:
  * file (default) — `JournalTail` polls the leader's segment files; works
    across processes. Lag is bounded by the leader's flush cadence (the
    journal syncer flushes on `fsync_interval_s` even under fsync=off) plus
    the poll interval.
  * queue — `attach(journal)` registers an in-process listener; records
    arrive on the leader's dispatcher thread and queue here, for
    same-process drills with near-zero lag. Their payloads are decoded
    from the framed bytes (`Journal.add_listener`), so a buffer the leader
    reuses after the append cannot reach the follower.

`promote()` is the failover drill: stop tailing, drain whatever the journal
still holds, and hand back the (now-leader) client. `lag()` is the gauge:
leader's last committed seq minus ours.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional
from zlib import crc32

from redisson_tpu_torch import checkpoint, contractwitness
from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.persist.journal import (
    _FRAME,
    _HEADER,
    JournalGap,
    JournalRecord,
    JournalTail,
    _body_seq,
    _list_segments,
)
from redisson_tpu_torch.persist.snapshotter import STRUCTURES_FILE, find_snapshots


def slots_record_filter(slots):
    """record_filter projecting a journal stream onto a slot subset —
    `filter(record) -> Optional[record]` for JournalFollower(record_filter=)
    and the cluster tier's SlotMigrator catch-up. Keyed records pass when
    their key's slot is in `slots`, their payload untouched whatever its
    layout (JAX's packed uint32 [n, 2] `add_ints` keys and the port's int64
    `device_packed` keys of `RHyperLogLog.add_device` alike); the unkeyed
    multi-key writes (mset / msetnx) are rewritten to the surviving pairs;
    every other unkeyed record (flushall, script cache, cluster bookkeeping)
    is dropped — keyspace-wide ops are fanned to every shard by the router
    directly, so a slot-scoped replica must not double-apply them."""
    slots = frozenset(int(s) for s in slots)

    def _filter(rec: JournalRecord) -> Optional[JournalRecord]:
        if rec.target:
            return rec if key_slot(rec.target) in slots else None
        if rec.kind in ("mset", "msetnx") and isinstance(rec.payload, dict):
            pairs = {k: v for k, v in rec.payload.get("pairs", {}).items()
                     if key_slot(k) in slots}
            if not pairs:
                return None
            payload = dict(rec.payload)
            payload["pairs"] = pairs
            return rec._replace(payload=payload)
        return None

    return _filter


class _WatermarkScanner:
    """Incremental leader-watermark reader for file-mode `lag()`.

    `last_seq_in_dir()` re-decodes the whole journal on every call —
    O(journal) per sample, too slow for the router to poll per-read. The
    scanner remembers (segment base, path, byte offset, last seq) and each
    call parses only frames appended since, re-anchoring from scratch when a
    segment event invalidates the cursor: the cached segment vanished
    (compaction / torn-segment drop) or the file shrank below the offset
    (torn-tail repair on leader restart). Frames are CRC-validated before
    the seq is trusted, exactly as `_scan_segment` does, but payloads are
    never decoded. A fresh anchor starts at the NEWEST segment with
    `last = base - 1` — exact, because `rotate()` opens every segment at
    base == last committed seq + 1."""

    def __init__(self, path: str):
        self.path = path
        self._lock = make_lock("follower._WatermarkScanner._lock")
        self._seg_base: Optional[int] = None
        self._seg_path = ""
        self._offset = 0
        self._last = 0
        self.rescans = 0  # cursor invalidations (segment events observed)

    def last_seq(self) -> int:
        with self._lock:
            try:
                return self._scan()
            except OSError:
                # segment disappeared mid-read (compaction race): drop the
                # anchor and serve the stale value; next call re-anchors.
                self._seg_base = None
                return self._last

    def _scan(self) -> int:
        segs = _list_segments(self.path)
        if not segs:
            self._seg_base = None
            self._last = 0
            return 0
        if self._seg_base is not None:
            cur = [p for b, p in segs if b == self._seg_base]
            if not cur or cur[0] != self._seg_path or \
                    os.path.getsize(self._seg_path) < self._offset:
                self._seg_base = None
        if self._seg_base is None:
            base, seg_path = segs[-1]
            self._seg_base, self._seg_path = base, seg_path
            self._offset = _HEADER.size
            self._last = base - 1
            self.rescans += 1
        while True:
            self._last = self._read_new_frames()
            # This segment exhausted; hop to its successor if one exists
            # (rotation names it base == our last + 1).
            nxt = [(b, p) for b, p in _list_segments(self.path)
                   if b == self._last + 1 and p != self._seg_path]
            if not nxt:
                return self._last
            self._seg_base, self._seg_path = nxt[0]
            self._offset = _HEADER.size

    def _read_new_frames(self) -> int:
        with open(self._seg_path, "rb") as f:
            f.seek(self._offset)
            buf = f.read()
        pos, n = 0, len(buf)
        last = self._last
        while pos + _FRAME.size <= n:
            body_len, crc = _FRAME.unpack_from(buf, pos)
            body_end = pos + _FRAME.size + body_len
            if body_end > n:
                break  # in-flight tail: length promises bytes not yet landed
            body = buf[pos + _FRAME.size:body_end]
            if body_len < 8 or crc32(body) != crc:
                break  # torn frame: retried next call, never counted
            seq = _body_seq(body)
            if seq != last + 1:
                break  # discontinuity: hold position, re-validate next call
            last = seq
            self._offset += _FRAME.size + body_len
            pos = body_end
        return last


class JournalFollower:
    def __init__(self, path: str, config=None, poll_interval_s: float = 0.05,
                 apply_window: int = 1024, record_filter=None):
        from redisson_tpu_torch.client import RedissonTorch
        from redisson_tpu_torch.config import Config

        self.path = path
        self._poll_s = poll_interval_s
        self._apply_window = apply_window
        # Optional record projection (slot-filtered replicas): applied to
        # every record AFTER the seq cursor advances, so filtered-out
        # records still count as applied — lag() measures journal position,
        # not record volume.
        self._record_filter = record_filter
        cfg = config or Config()
        if getattr(cfg, "persist", None) is not None:
            raise ValueError("follower clients must not persist — they'd "
                             "journal the leader's ops a second time")
        self.client = RedissonTorch.create(cfg)
        self._applied = 0
        self._applied_lock = make_lock(
            "follower.JournalFollower._applied_lock")
        self._records_applied = 0
        self._apply_errors = 0
        self._queue: Optional[deque] = None  # in-process mode
        self._queue_lock = make_lock("follower.JournalFollower._queue_lock")
        self._source_journal = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._bootstraps = 0
        # PSYNC parity gauges: every (re)sync is one or the other. The
        # initial snapshot bootstrap counts as full, mirroring redis
        # sync_full counting every first-time slave.
        self._full_resyncs = 0
        self._partial_resyncs = 0
        self._scanner = _WatermarkScanner(path)
        # monotonic stamp of the last moment we KNEW we were at the
        # journal's visible tip (applied records, or polled it empty).
        self._fresh_at = time.monotonic()
        try:
            self._resync()
        except BaseException:
            self.client.shutdown()
            raise

    # -- bootstrap / tail ----------------------------------------------------

    def _resync(self) -> None:
        """(Re)attach to the journal after a start, gap, or retarget.

        PSYNC split: when we already hold applied state AND the journal
        still has a segment covering our cursor (base <= applied + 1), keep
        the state and just re-open the tail at the cursor — a partial
        resync, no snapshot traffic. Only when the suffix was compacted
        away (or we have nothing yet) pay for the full snapshot bootstrap."""
        applied = self.applied_seq
        if self._bootstraps and applied and self._suffix_available(applied):
            self._tail = JournalTail(self.path, from_seq=applied)
            self._partial_resyncs += 1
            return
        self._bootstrap()

    def _suffix_available(self, applied: int) -> bool:
        try:
            segs = _list_segments(self.path)
        except OSError:
            return False
        return any(base <= applied + 1 for base, _ in segs)

    def _bootstrap(self) -> None:
        """(Re)load the newest leader snapshot; reset the apply cursor to
        its watermark. Called at start and after a JournalGap (the leader
        compacted history past our cursor)."""
        snaps = find_snapshots(self.path)
        watermark = 0
        if snaps:
            watermark, snap_path = snaps[-1]
            if self._bootstraps:
                # Re-bootstrap: drop divergent state before reloading.
                self.client._dispatch.execute_sync("", "flushall", None)
            structures = getattr(self.client._routing, "structures", None)
            blob = checkpoint.extra_file(snap_path, STRUCTURES_FILE)
            if structures is not None and blob is not None:
                self.client._executor.execute_barrier(
                    lambda: structures.load_state(blob)).result(timeout=120)
            self.client.load_checkpoint(snap_path)
        with self._applied_lock:
            self._applied = watermark
        self._tail = JournalTail(self.path, from_seq=watermark)
        self._bootstraps += 1
        self._full_resyncs += 1

    def attach(self, journal) -> None:
        """Switch to in-process queue tailing of a live Journal (leader in
        the same process). Records already applied are deduped by seq."""
        self._queue = deque()
        self._source_journal = journal
        journal.add_listener(self._on_records)

    def _on_records(self, records: List[JournalRecord]) -> None:
        with self._queue_lock:
            self._queue.extend(records)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="redisson-torch-follower", daemon=True)
            self._thread.start()

    def _next_records(self) -> List[JournalRecord]:
        if self._queue is not None:
            with self._queue_lock:
                records = list(self._queue)
                self._queue.clear()
            return [r for r in records if r.seq > self._applied]
        return self._tail.poll(max_records=self._apply_window)

    def _apply(self, records: List[JournalRecord]) -> None:
        if not records:
            return
        last_seq = records[-1].seq
        if self._record_filter is not None:
            records = [r for r in (self._record_filter(rec) for rec in records)
                       if r is not None]
        futures: List = []
        executor = self.client._executor

        def drain() -> None:
            for fut in futures:
                try:
                    fut.result(timeout=120)
                except Exception:
                    # Standby replay mirrors recover.py: a record may fail
                    # exactly as it failed live; counted in apply_errors,
                    # never kills the follower.
                    self._apply_errors += 1
            futures.clear()

        # Concurrency only WITHIN a run of consecutive same-(kind, target)
        # records — the executor's per-target queue keeps those FIFO; across
        # targets it round-robins, so a group boundary must drain or the
        # follower's apply order diverges from the journal (see recover.py).
        group = None
        for rec in records:
            key = (rec.kind, rec.target)
            if key != group:
                drain()
                group = key
            with contractwitness.surface("replica"):
                futures.append(
                    executor.execute_async(rec.target, rec.kind,
                                           rec.payload))
        drain()
        with self._applied_lock:
            self._applied = last_seq
            self._records_applied += len(records)
        self._fresh_at = time.monotonic()

    def _loop(self) -> None:
        from redisson_tpu_torch.fault import inject, taxonomy

        while not self._stop.is_set():
            try:
                # Partition seam: an injected fault here models a replica
                # that silently stops tailing — the poll is skipped and
                # `_fresh_at` does NOT advance, so the frozen watermark is
                # visible to the router's staleness bound (lag grows; the
                # replica drops out of the eligible set instead of serving
                # stale reads).
                inject.fire("replica_tail", target=getattr(self, "name", ""))
            except taxonomy.Fault:
                self._stop.wait(self._poll_s)
                continue
            try:
                records = self._next_records()
            except JournalGap:
                self._resync()
                # Pace the retry: a gap that can't heal yet (e.g. a fresh
                # post-failover journal whose first snapshot hasn't landed)
                # must not spin the loop hot.
                self._stop.wait(self._poll_s)
                continue
            if records:
                self._apply(records)
            else:
                # Empty poll == we are at the journal's visible tip.
                self._fresh_at = time.monotonic()
                self._stop.wait(self._poll_s)

    # -- introspection -------------------------------------------------------

    @property
    def applied_seq(self) -> int:
        with self._applied_lock:
            return self._applied

    def lag(self) -> int:
        """Records the leader has committed that we haven't applied (the
        bounded-lag gauge). File mode reads the incremental watermark
        scanner (O(new bytes), poll-per-read cheap); queue mode reads the
        live journal's counter."""
        if self._source_journal is not None:
            leader = self._source_journal.last_seq
        else:
            leader = self._scanner.last_seq()
        return max(0, leader - self.applied_seq)

    def staleness_s(self) -> float:
        """Seconds since this follower last touched the journal's visible
        tip (applied records or polled it empty) — the time axis of the
        bounded-staleness contract (`ReplicaConfig.max_lag_s`)."""
        return max(0.0, time.monotonic() - self._fresh_at)

    def stats(self) -> Dict[str, Any]:
        return {
            "applied_seq": self.applied_seq,
            "records_applied": self._records_applied,
            "apply_errors": self._apply_errors,
            "lag": self.lag(),
            "staleness_s": self.staleness_s(),
            "bootstraps": self._bootstraps,
            "full_resyncs": self._full_resyncs,
            "partial_resyncs": self._partial_resyncs,
            "mode": "queue" if self._queue is not None else "file",
        }

    # -- failover ------------------------------------------------------------

    def promote(self, catch_up: bool = True, timeout_s: float = 30.0):
        """Failover drill: stop tailing, optionally drain every record the
        journal still exposes, and return the caught-up client — the new
        leader. Does not itself fence the old leader's journal — the
        ReplicaManager's failover path calls `Journal.fence()` first so the
        drain target is final; a bare drill promotes over a live journal."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if self._source_journal is not None:
            self._source_journal.remove_listener(self._on_records)
        if catch_up:
            deadline = time.monotonic() + timeout_s
            idle_polls = 0
            while idle_polls < 2 and time.monotonic() < deadline:
                try:
                    records = self._next_records()
                except JournalGap:
                    self._resync()
                    continue
                if records:
                    self._apply(records)
                    idle_polls = 0
                else:
                    idle_polls += 1
        return self.client

    def retarget(self, path: str, max_valid_seq: Optional[int] = None) -> None:
        """Repoint a live follower at a new leader's journal (the surviving
        fleet after a failover): stop the tail loop, swap the source dir,
        resync, resume. Stays a PARTIAL resync when the new journal's
        numbering covers our cursor — the promoted primary opens its fresh
        journal at the old global seq precisely so this path avoids a
        snapshot; a replica that was behind the promoted watermark full-
        bootstraps from the new primary's first snapshot instead.

        `max_valid_seq` is the promotion watermark: a follower whose cursor
        sits PAST it applied old-journal records the new leader never saw,
        and the new journal will reuse those seq numbers for different
        contents — its state must be dropped and rebuilt from the new
        leader's snapshot, never partial-resynced over."""
        was_running = self._thread is not None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._source_journal is not None:
            self._source_journal.remove_listener(self._on_records)
            self._source_journal = None
            self._queue = None
        self.path = path
        self._scanner = _WatermarkScanner(path)
        self._stop = threading.Event()
        if max_valid_seq is not None and self.applied_seq > max_valid_seq:
            self._bootstrap()
        else:
            self._resync()
        if was_running:
            self.start()

    def close(self, shutdown_client: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._source_journal is not None:
            self._source_journal.remove_listener(self._on_records)
            self._source_journal = None
        if shutdown_client:
            self.client.shutdown()
