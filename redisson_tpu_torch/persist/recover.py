"""Crash recovery: newest snapshot + journal-suffix replay (counterpart of
`redisson_tpu.persist.recover`; either package recovers the other's
persist directory).

Replay goes through `executor.execute_async` — the exact codepath live
traffic takes — so a recovered engine is bit-identical to one that executed
the committed prefix serially (the golden-test contract: the kill-and-
recover property tests compare full state dumps). On a card the replay runs
the card's kernels, like live traffic; a replayed `add_device` payload
comes back as a host array and the backend copies it to the device.

Runs pre-traffic, BEFORE the journal hook is installed on the executor
(PersistenceManager.start orders this), so replayed ops are not re-
journaled; journaling then resumes at the recovered sequence number.

Documented caveats (shared with the Redis AOF design):
  * `bpop` is parked, never journaled — recovered queues retain items an
    in-flight blocking pop would have consumed (at-least-once).
  * Ops whose results depend on wall-clock (relative TTLs) or randomness
    (spop) replay their *arguments*, not their outcomes; replay within one
    process lifetime is still deterministic because both engine tiers
    resolve them at apply time from the journaled arguments.
  * The SCRIPT cache is not snapshotted (callables); journaled
    script_load/script_eval records re-register what they can.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

from redisson_tpu_torch import checkpoint, contractwitness
from redisson_tpu_torch.persist.journal import iter_records
from redisson_tpu_torch.persist.snapshotter import STRUCTURES_FILE, find_snapshots

#: replay keeps this many futures in flight before draining — enough to
#: feed the pipeline window without holding every decoded payload alive.
#: Only CONSECUTIVE same-(kind, target) records share the window: the
#: executor's per-target FIFO queues keep those in order, while records for
#: different targets round-robin — concurrent submission would let replay
#: apply them in a different global order than the journal (fatal across a
#: flushall/rename boundary, and enough to break bit-identity everywhere
#: else). Group boundaries are therefore full drains: apply order == journal
#: order == the leader's original dispatch order, always.
REPLAY_WINDOW = 1024


def recover(client, path: str, replay_window: int = REPLAY_WINDOW) -> Dict[str, Any]:
    """Restore `client` from persist directory `path`. Returns stats:
    {snapshot_seq, snapshot_objects, replayed, replay_errors, seconds,
    ops_per_s, last_seq}."""
    t0 = time.monotonic()
    executor = client._executor
    if executor.journal is not None:
        raise RuntimeError("recover() must run before the journal hook is "
                           "installed — replayed ops must not re-journal")
    watermark = 0
    snapshot_objects = 0
    snaps = find_snapshots(path)
    if snaps:
        watermark, snap_path = snaps[-1]
        structures = getattr(client._routing, "structures", None)
        blob = checkpoint.extra_file(snap_path, STRUCTURES_FILE)
        if structures is not None and blob is not None:
            # Barrier: the keyspace swap happens on the dispatcher thread,
            # ordered against any (internal) traffic already queued.
            executor.execute_barrier(
                lambda: structures.load_state(blob)).result(timeout=120)
        snapshot_objects = client.load_checkpoint(snap_path)
    replayed = 0
    errors = 0
    last_seq = watermark
    pending: deque = deque()

    def drain(down_to: int) -> int:
        failed = 0
        while len(pending) > down_to:
            fut = pending.popleft()
            try:
                fut.result(timeout=120)
            except Exception:
                # A journaled op may fail on replay exactly like it failed
                # live (write-ahead ordering journals the attempt, e.g. a
                # WRONGTYPE probe): counted, kept going.
                failed += 1
        return failed

    group: Optional[tuple] = None
    for rec in iter_records(path, from_seq=watermark):
        key = (rec.kind, rec.target)
        if key != group:
            errors += drain(0)  # group boundary: hold the journal's order
            group = key
        elif len(pending) >= replay_window:
            errors += drain(replay_window // 2)
        with contractwitness.surface("replay"):
            pending.append(
                executor.execute_async(rec.target, rec.kind, rec.payload))
        replayed += 1
        last_seq = rec.seq
    errors += drain(0)
    seconds = time.monotonic() - t0
    return {
        "snapshot_seq": watermark,
        "snapshot_objects": snapshot_objects,
        "replayed": replayed,
        "replay_errors": errors,
        "seconds": seconds,
        "ops_per_s": (replayed / seconds) if seconds > 0 else 0.0,
        "last_seq": last_seq,
    }
