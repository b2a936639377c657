"""Segmented append-only op journal, the AOF analogue (counterpart of
`redisson_tpu.persist.journal`: same segment files, same frames, same record
bytes, so either package reads the other's journal).

One record per committed mutating op — classification comes straight from
`OP_TABLE[kind].write` (commands.py), so the journal stays in lockstep with
the command registry instead of keeping its own write list. The executor
appends on the dispatcher thread *before* staging the run (write-ahead
ordering: acknowledged implies journaled), which also makes journal order
identical to apply order — both engine tiers commit observable state at
stage time (DISPATCH_TIME_STATE), so dispatch order IS apply order. A
record's payload bytes come from persist/codec; a host-key op's bytes equal
the JAX package's for the same op (`pack_u64` has one layout in both).

On-disk layout (`<dir>/seg-<first-seq>.wal`):

    header  "RTPUWAL1" + u64 base_seq
    frame*  u32 body_len | u32 crc32(body) | body
    body    u64 seq | blob(target utf-8) | blob(kind ascii) | blob(payload)

with `blob` = u32 length + bytes and payload encoded by persist/codec.
A torn tail (power loss mid-write) fails the length or CRC check and is
truncated on open; a gap or corruption in an *earlier* segment truncates
there and discards the unreachable suffix, so the journal is always a
committed prefix of history.

Fsync policies (the redis `appendfsync` analogue):

  * "always"  — fsync before the run stages, but group-committed: while
    more dispatch work is imminent (the executor passes `defer=True` when
    its ready queue is non-empty) the fsync is delayed until the group
    reaches `group_commit_runs` (default: the pipeline's in-flight window,
    `Config.inflight_runs`) or a ~2ms linger fires. Sequential callers get
    a true fsync-per-op; pipelined bursts amortize one fsync across the
    window. Durability lag is bounded by that window.
  * "everysec" — background fsync every `fsync_interval_s`.
  * "off"      — flush to the OS on the same cadence, never fsync.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple
from zlib import crc32

from redisson_tpu_torch.commands import OP_TABLE
from redisson_tpu_torch.executor import make_rlock
from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.persist.codec import decode_payload, encode_payload

MAGIC = b"RTPUWAL1"
_HEADER = struct.Struct("<8sQ")  # magic, base_seq
_FRAME = struct.Struct("<II")  # body_len, crc32(body)
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".wal"


class JournalGap(RuntimeError):
    """A tailer's next sequence number is below every surviving segment —
    the leader truncated history past the tail position (snapshot +
    `remove_segments_below`); the follower must re-bootstrap."""


class JournalRecord(NamedTuple):
    seq: int
    target: str
    kind: str
    payload: Any


def _segment_name(base_seq: int) -> str:
    return f"{SEGMENT_PREFIX}{base_seq:020d}{SEGMENT_SUFFIX}"


def _list_segments(path: str) -> List[Tuple[int, str]]:
    """Sorted (base_seq, abspath) for every segment file in `path`."""
    out = []
    for name in os.listdir(path):
        if name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX):
            try:
                base = int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
            except ValueError:
                continue
            out.append((base, os.path.join(path, name)))
    out.sort()
    return out


def _fsync_dir(path: str) -> None:
    """Fsync a directory so entry creation/removal survives power loss
    (no-op where directories cannot be opened, e.g. some containers)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _decode_body(body: bytes) -> JournalRecord:
    (seq,) = _U64.unpack_from(body, 0)
    pos = 8
    (n,) = _U32.unpack_from(body, pos)
    pos += 4
    target = body[pos:pos + n].decode("utf-8")
    pos += n
    (n,) = _U32.unpack_from(body, pos)
    pos += 4
    kind = body[pos:pos + n].decode("ascii")
    pos += n
    (n,) = _U32.unpack_from(body, pos)
    pos += 4
    payload = decode_payload(body[pos:pos + n])
    return JournalRecord(seq, target, kind, payload)


def _body_seq(body: bytes) -> int:
    (seq,) = _U64.unpack_from(body, 0)
    return seq


def _scan_segment(path: str, decode: bool, from_seq: int = 0,
                  prev_seq: Optional[int] = None):
    """Walk one segment's frames in order, stopping at the first torn or
    out-of-sequence frame. Returns (base_seq, records, last_seq, valid_end)
    where valid_end is the byte offset just past the last good frame
    (header offset if none) and records is populated only when decode=True
    (seqs > from_seq). base_seq is None when the header itself is invalid.
    """
    records: List[JournalRecord] = []
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            return None, records, prev_seq, 0
        magic, base_seq = _HEADER.unpack(head)
        if magic != MAGIC:
            return None, records, prev_seq, 0
        last_seq = prev_seq
        valid_end = _HEADER.size
        buf = f.read()
    pos = 0
    n = len(buf)
    while pos + _FRAME.size <= n:
        body_len, crc = _FRAME.unpack_from(buf, pos)
        body_end = pos + _FRAME.size + body_len
        if body_end > n:
            break  # torn tail: length promises bytes that never landed
        body = buf[pos + _FRAME.size:body_end]
        if crc32(body) != crc or body_len < 8:
            break  # torn tail: partial body overwritten by the crash
        seq = _body_seq(body)
        if last_seq is not None and seq != last_seq + 1:
            break  # sequence discontinuity: treat like a torn tail
        if last_seq is None and seq != base_seq:
            break
        if decode and seq > from_seq:
            records.append(_decode_body(body))
        last_seq = seq
        valid_end = _HEADER.size + body_end  # body_end is buf-relative
        pos = body_end
    return base_seq, records, last_seq, valid_end


def iter_records(path: str, from_seq: int = 0) -> Iterator[JournalRecord]:
    """Yield committed records with seq > from_seq across all segments,
    stopping at the first torn/out-of-sequence frame (everything past a
    tear is unreachable history and is never yielded)."""
    prev: Optional[int] = None
    for base, seg_path in _list_segments(path):
        if prev is not None and base > prev + 1:
            return  # gap between segments: suffix is unreachable
        base_seq, records, last, _ = _scan_segment(
            seg_path, decode=True, from_seq=from_seq, prev_seq=prev)
        if base_seq is None:
            return
        for rec in records:
            yield rec
        if last is not None and (prev is None or last > prev):
            prev = last
        elif prev is None:
            prev = base_seq - 1
        if last is None or (base_seq is not None and last < base_seq):
            # empty or immediately-torn segment: nothing after it counts
            return


def last_seq_in_dir(path: str) -> int:
    """Highest committed sequence number in a journal directory (0 when
    empty) — the leader-side watermark a follower's lag gauge compares to."""
    last = 0
    for rec in iter_records(path):
        last = rec.seq
    return last


class Journal:
    """Appender side of the segmented journal. Single-writer: appends come
    from the executor's dispatcher thread; the background syncer and any
    control calls (rotate / sync / close) serialize on an internal lock."""

    GROUP_LINGER_S = 0.002  # "always" backstop: a lone deferred record
    # waits at most this long for groupmates before its fsync fires.

    def __init__(self, path: str, fsync: str = "everysec",
                 fsync_interval_s: float = 1.0, group_commit_runs: int = 2,
                 segment_max_bytes: int = 64 << 20, start_seq: int = 0):
        if fsync not in ("always", "everysec", "off"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.path = os.path.abspath(path)
        self._fsync = fsync
        self._interval_s = max(0.01, float(fsync_interval_s))
        self._group = max(1, int(group_commit_runs))
        self._segment_max = max(1 << 16, int(segment_max_bytes))
        # First seq in an EMPTY dir is start_seq + 1: a promoted replica's
        # fresh journal continues the old primary's global numbering, so
        # surviving replicas can partial-resync against it (PSYNC replid
        # continuity). Ignored when the dir already has segments.
        self._start_seq = max(0, int(start_seq))
        os.makedirs(self.path, exist_ok=True)
        self._io = make_rlock("journal.Journal._io")
        self._dirty = False
        self._unsynced_runs = 0
        self._closed = False
        self._fenced = False
        # In-process tails (persist/follower.py queue mode); see add_listener.
        self._listeners: List[Callable[[List[JournalRecord]], None]] = []
        # counters (stats() snapshots them; writes happen under _io)
        self._records_appended = 0
        self._runs_appended = 0
        self._bytes_appended = 0
        self._fsyncs = 0
        self._trace = None  # TraceManager (fsync-duration hook) or None
        self._group_sum = 0
        self._synced_seq = 0
        self._recovered_tail_bytes = 0
        self._last_seq = self._open_segments()
        self._synced_seq = self._last_seq
        self._wake = threading.Event()
        self._syncer = threading.Thread(
            target=self._sync_loop, name="redisson-torch-journal-sync", daemon=True)
        self._syncer.start()

    # -- open / torn-tail repair --------------------------------------------

    def _open_segments(self) -> int:
        self._segments = _list_segments(self.path)
        if not self._segments:
            self._create_segment(self._start_seq + 1)
            return self._start_seq
        # Validate the committed prefix; truncate at the first tear and
        # drop every segment past it (unreachable history).
        prev: Optional[int] = None
        keep = 0
        truncate_at: Optional[Tuple[str, int]] = None
        for base, seg_path in self._segments:
            if prev is not None and base > prev + 1:
                break
            base_seq, _, last, valid_end = _scan_segment(
                seg_path, decode=False, prev_seq=prev)
            if base_seq is None:
                break
            end_of_file = os.path.getsize(seg_path)
            keep += 1
            if valid_end < end_of_file:
                self._recovered_tail_bytes += end_of_file - valid_end
                truncate_at = (seg_path, valid_end)
                prev = last if last is not None else base_seq - 1
                break
            prev = last if last is not None else base_seq - 1
        dropped = self._segments[keep:]
        self._segments = self._segments[:keep]
        for _, seg_path in dropped:
            os.remove(seg_path)
        if truncate_at is not None:
            seg_path, valid_end = truncate_at
            with open(seg_path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
        if dropped or truncate_at:
            _fsync_dir(self.path)
        if not self._segments:
            # every segment was torn at the header: start over
            self._create_segment(self._start_seq + 1)
            return self._start_seq
        last_seq = prev if prev is not None else 0
        self._f = open(self._segments[-1][1], "ab")
        return last_seq

    def _create_segment(self, base_seq: int) -> None:
        seg_path = os.path.join(self.path, _segment_name(base_seq))
        f = open(seg_path, "wb")
        f.write(_HEADER.pack(MAGIC, base_seq))
        f.flush()
        os.fsync(f.fileno())
        _fsync_dir(self.path)
        self._segments = getattr(self, "_segments", []) + [(base_seq, seg_path)]
        self._f = f

    # -- append path (dispatcher thread) ------------------------------------

    @staticmethod
    def journals(kind: str) -> bool:
        """True when ops of `kind` are journaled — registry-driven: every
        OP_TABLE entry with write=True, no separate list to drift."""
        desc = OP_TABLE.get(kind)
        return desc is not None and desc.write

    def append_run(self, kind: str, ops, defer: bool = False) -> int:
        """Append one dispatched run's mutating ops; returns records
        written (0 for read kinds — the caller needn't pre-filter).

        defer=True signals more dispatch work is imminent, letting the
        "always" policy group-commit the fsync across the pipeline window
        instead of paying one fsync per run.
        """
        # Coalesced runs may mix kinds (group-coalesced delta windows stack
        # hll_add/bloom_add/bitset_set ops behind one run kind): each record
        # is stamped with ITS op's kind so replay re-dispatches the original
        # per-op stream byte-identically, and read-kind riders are skipped
        # per op, not per run.
        ops = [op for op in ops if self.journals(getattr(op, "kind", kind))]
        if not ops:
            return 0
        frames = bytearray()
        records: List[JournalRecord] = []
        # single-appender discipline: only the executor dispatcher calls append_run, so pre-encoding frames with an unlocked _last_seq read is race-free — the commit under _io below re-publishes it
        seq = self._last_seq
        for op in ops:
            op_kind = getattr(op, "kind", kind)
            seq += 1
            payload = encode_payload(op.payload)
            target = op.target.encode("utf-8")
            kb = op_kind.encode("ascii")
            body = bytearray()
            body += _U64.pack(seq)
            body += _U32.pack(len(target))
            body += target
            body += _U32.pack(len(kb))
            body += kb
            body += _U32.pack(len(payload))
            body += payload
            body = bytes(body)
            frames += _FRAME.pack(len(body), crc32(body))
            frames += body
            if self._listeners:
                # A listener gets the record as a tail of the file reads it:
                # decoded from the bytes just framed. The live payload may
                # hold a tensor or array the caller reuses or the engine
                # writes in place after this returns; the copy cannot change.
                records.append(JournalRecord(seq, op.target, op_kind,
                                             decode_payload(payload)))
        with self._io:
            if self._closed:
                raise RuntimeError("journal is closed")
            if self._fenced:
                # Failover fence: the executor fails the op (nothing has
                # committed yet), so no write is ever acked into a stream
                # the surviving fleet has stopped tailing.
                raise RuntimeError("journal is fenced (failover in progress)")
            self._f.write(frames)
            self._last_seq = seq
            self._records_appended += len(ops)
            self._runs_appended += 1
            self._bytes_appended += len(frames)
            self._unsynced_runs += 1
            self._dirty = True
            group_full = self._unsynced_runs >= self._group
            if self._f.tell() >= self._segment_max:
                # rotation must be atomic with the append that tripped the size limit — a concurrent append landing in the sealed file would be lost to tailers
                self._rotate_locked()
        if self._fsync == "always":
            if group_full or not defer:
                self.sync()
            else:
                self._wake.set()  # arm the linger backstop
        for fn in self._listeners:
            fn(records)
        return len(ops)

    def add_listener(self, fn: Callable[[List[JournalRecord]], None]) -> None:
        """In-process tail: `fn(records)` fires on the appending thread
        after the write lands in the journal buffer. Each record's payload
        is decoded from its framed bytes (what a file tail would read), so
        no later write to the caller's buffers reaches it."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def fence(self) -> None:
        """Failover fence: flush what's already appended, then refuse every
        further append_run (the executor fails those ops before they commit,
        so nothing is acked into a stream the surviving fleet has stopped
        tailing). After fence() returns, `last_seq` is final — the promotion
        watermark can be read without racing in-flight writes. Irreversible:
        a fenced journal only closes."""
        with self._io:
            self._fenced = True
            if not self._closed:
                self._f.flush()

    @property
    def fenced(self) -> bool:
        return self._fenced

    @property
    def last_seq(self) -> int:
        """Highest sequence number appended so far (0 = empty journal).
        The rebuild path snapshots this to bound its suffix replay: records
        it appends itself (zeroing deletes, re-journaled replays) get
        higher seqs and must not feed back into the same replay."""
        with self._io:
            return self._last_seq

    # -- durability ---------------------------------------------------------

    def set_trace(self, trace) -> None:
        """Attach/detach the trace manager's fsync-duration hook."""
        with self._io:
            self._trace = trace

    def sync(self) -> None:
        """Flush + fsync everything appended so far (group commit point)."""
        with self._io:
            if not self._dirty or self._closed:
                return
            trace = self._trace
            t0 = time.monotonic() if trace is not None else 0.0
            # Fault seam: a failed fsync propagates to the caller — the
            # executor's journal-append path classifies it RetryableFault
            # (write-ahead: no state committed for the unsynced records);
            # a "stall" rule sleeps here and is measured as fsync time.
            fault_inject.fire("journal_fsync")
            self._f.flush()
            # group commit IS the design: appends queue behind the fsync so one disk flush covers the whole group; releasing _io here would ack unsynced records
            os.fsync(self._f.fileno())
            if trace is not None:
                trace.record_fsync(time.monotonic() - t0)
            self._fsyncs += 1
            self._group_sum += self._unsynced_runs
            self._unsynced_runs = 0
            self._synced_seq = self._last_seq
            self._dirty = False

    def _flush_only(self) -> None:
        with self._io:
            if self._closed:
                return
            self._f.flush()

    def _sync_loop(self) -> None:
        linger = self.GROUP_LINGER_S
        while True:
            if self._fsync == "always":
                # Sleep until a deferred append arms the backstop, give
                # groupmates one linger window, then force the sync (a
                # group that fills first syncs inline on the dispatcher).
                self._wake.wait()
                self._wake.clear()
                if self._closed:
                    return
                if self._dirty:
                    time.sleep(linger)
                    try:
                        self.sync()
                    except Exception:
                        # background backstop fsync: a failure here retries next wake, and the inline group-commit path surfaces the same error through the executor's classify boundary
                        pass
                continue
            self._wake.wait(self._interval_s)
            self._wake.clear()
            if self._closed:
                return
            if self._fsync == "off":
                self._flush_only()
            elif self._dirty:
                try:
                    self.sync()
                except Exception:
                    # everysec fsync failure: durability lag grows one period and the next tick retries; killing the sync thread would silently stop fsyncs forever
                    pass

    # -- rotation / truncation (snapshotter) --------------------------------

    def rotate(self) -> int:
        """Seal the active segment (flushed + fsynced) and open a fresh one
        whose base is the next sequence number. Returns that base."""
        with self._io:
            # explicit rotation seals the segment atomically with respect to appends; the fsync inside is the seal
            return self._rotate_locked()

    def _rotate_locked(self) -> int:
        base = self._last_seq + 1
        if self._segments and self._segments[-1][0] == base \
                and self._f.tell() <= _HEADER.size:
            return base  # active segment still empty: nothing to seal
        self._f.flush()
        # the seal fsync must complete before any append can land in the next segment — that ordering is the segment-boundary durability contract
        os.fsync(self._f.fileno())
        self._synced_seq = self._last_seq
        if self._unsynced_runs:
            self._fsyncs += 1
            self._group_sum += self._unsynced_runs
            self._unsynced_runs = 0
        self._dirty = False
        self._f.close()
        base = self._last_seq + 1
        # the fresh segment's header fsync rides the same critical section as the seal — a reader must never observe the directory without exactly one active segment
        self._create_segment(base)
        return base

    def remove_segments_below(self, seq: int) -> int:
        """Delete sealed segments whose every record has seq <= `seq` (the
        snapshot watermark). The active segment is never deleted. Returns
        the number of segment files removed."""
        removed = 0
        with self._io:
            while len(self._segments) > 1:
                next_base = self._segments[1][0]
                if next_base > seq + 1:
                    break
                _, seg_path = self._segments.pop(0)
                try:
                    os.remove(seg_path)
                except OSError:
                    break
                removed += 1
            if removed:
                _fsync_dir(self.path)
        return removed

    # -- introspection -------------------------------------------------------

    @property
    def durable_seq(self) -> int:
        """Highest sequence number known fsynced to stable storage."""
        with self._io:
            return self._synced_seq

    def disk_bytes(self) -> int:
        """On-disk bytes across live segments (the memstat 'disk' meter);
        a racing rotation or prune tolerates the missing file."""
        with self._io:
            paths = [p for _, p in self._segments]
        total = 0
        for p in paths:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def stats(self) -> Dict[str, Any]:
        with self._io:
            return {
                "fsync": self._fsync,
                "last_seq": self._last_seq,
                "durable_seq": self._synced_seq,
                "records_appended": self._records_appended,
                "runs_appended": self._runs_appended,
                "bytes_appended": self._bytes_appended,
                "fsyncs": self._fsyncs,
                "group_mean": (self._group_sum / self._fsyncs) if self._fsyncs else 0.0,
                "unsynced_runs": self._unsynced_runs,
                "segments": len(self._segments),
                "recovered_tail_bytes": self._recovered_tail_bytes,
                "fenced": self._fenced,
            }

    def close(self) -> None:
        with self._io:
            if self._closed:
                return
            self._f.flush()
            # close() drains durability under _io so no append can interleave between the final fsync and the fd close
            os.fsync(self._f.fileno())
            self._synced_seq = self._last_seq
            self._dirty = False
            self._closed = True
            self._f.close()
        self._wake.set()
        self._syncer.join(timeout=5.0)


class JournalTail:
    """Incremental reader over a (possibly live) journal directory.

    Tracks a byte offset inside the current segment; `poll()` returns every
    newly committed record since the last call. A partial or CRC-bad frame
    at the tail is treated as in-flight (retried next poll); a missing
    segment below the cursor raises JournalGap (the leader compacted past
    us — re-bootstrap from a snapshot).
    """

    def __init__(self, path: str, from_seq: int = 0):
        self.path = os.path.abspath(path)
        self._next_seq = from_seq + 1
        self._seg_path: Optional[str] = None
        self._offset = 0

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def _locate(self) -> bool:
        """Point the cursor at the segment containing _next_seq."""
        segments = _list_segments(self.path)
        if not segments:
            return False
        candidate = None
        for base, seg_path in segments:
            if base <= self._next_seq:
                candidate = (base, seg_path)
        if candidate is None:
            raise JournalGap(
                f"journal truncated past seq {self._next_seq} "
                f"(oldest surviving segment starts at {segments[0][0]})")
        self._seg_path = candidate[1]
        self._offset = _HEADER.size
        return True

    def poll(self, max_records: int = 0) -> List[JournalRecord]:
        out: List[JournalRecord] = []
        while True:
            if self._seg_path is None and not self._locate():
                return out
            try:
                with open(self._seg_path, "rb") as f:
                    f.seek(self._offset)
                    buf = f.read()
            except FileNotFoundError:
                # compacted under us; re-locate (raises JournalGap if our
                # cursor's history is gone)
                self._seg_path = None
                continue
            pos = 0
            n = len(buf)
            progressed = False
            while pos + _FRAME.size <= n:
                body_len, crc = _FRAME.unpack_from(buf, pos)
                body_end = pos + _FRAME.size + body_len
                if body_end > n:
                    break  # in-flight write
                body = buf[pos + _FRAME.size:body_end]
                if crc32(body) != crc or body_len < 8:
                    break  # in-flight write (buffered flush landed mid-frame)
                seq = _body_seq(body)
                if seq >= self._next_seq:
                    out.append(_decode_body(body))
                    self._next_seq = seq + 1
                pos = body_end
                self._offset += _FRAME.size + body_len
                progressed = True
                if max_records and len(out) >= max_records:
                    return out
            if pos < n and not progressed:
                return out  # stuck on a partial frame: wait for more bytes
            # Exhausted this segment's bytes: did the writer rotate?
            segments = _list_segments(self.path)
            rotated = any(base == self._next_seq and seg_path != self._seg_path
                          for base, seg_path in segments)
            if rotated and pos >= n:
                self._seg_path = None
                continue
            return out
