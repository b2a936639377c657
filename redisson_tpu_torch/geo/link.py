"""SiteLink: the per-peer shipping thread — the journal IS the transport (a
copy of `redisson_tpu.geo.link`).

One link per (local site, peer) direction. Each tick it polls a
``JournalTail`` over the local persist journal, filters to the shippable
kinds, folds runs of semilattice writes into **delta planes** (the same
host folds the delta ingest path uses — what crosses the link is a
register/bit plane, not the key batch), and delivers the batch to the
peer's applier together with a vv watermark.

Fold groups are cut at destructive-op boundaries per key, so the shipped
message order preserves the origin's per-key op order: a DEL between two
PFADD runs ships as merge / delete / merge, never merge+merge / delete.
Destructive kinds transform at ship time:

  delete        -> tombstone message (receiver LWW-arbitrates)
  rename        -> delete(src) + full-state replace(dst) read at ship
                   time (the journal has the op, not the moved bytes)
  bitset_clear  -> full-state replace (clears are not a join; the plane
                   after the clear, stamped with the clear's seq, is)
  flushall      -> flush message (receiver resolves to a concrete
                   key list against its own LWW floors)

A ``JournalGap`` (our journal compacted past the peer's cursor — site
restart, segment GC) triggers **snapshot repair**: record the journal
head first, ship every local key's full state as repair merges stamped
with its last-write stamp plus the floor map as repair tombstones, then
resume tailing from the recorded head.

Fault injection: the ``geo_link`` seam fires at the top of every tick
with ``target=<peer site id>``; an injected fault models a cross-site
partition — the tick aborts, the cursor holds, and the backlog ships
after heal (anti-entropy semantics fall out of the cursor never
advancing past unshipped records).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.fault.taxonomy import Fault
from redisson_tpu_torch.geo.applier import (
    DESTRUCTIVE_KINDS, SEMILATTICE_KINDS, SHIP_KINDS)
from redisson_tpu_torch.ingest import delta as delta_mod
from redisson_tpu_torch.persist.journal import JournalGap, JournalTail

GUARDED_BY = {
    "SiteLink.tail":
        "thread:link — only the link thread polls/rewinds the tail; "
        "close() joins before reading it",
    "SiteLink.stats":
        "thread:link writes; info()/lag() readers tolerate a one-tick-"
        "stale counter snapshot (monitoring, not control flow)",
    "SiteLink._last_progress_s":
        "thread:link writes; lag() readers see a monotonic float whose "
        "staleness only inflates the reported lag by one tick",
}


class SiteLink:
    """Ships this site's journal suffix to one peer's applier."""

    def __init__(self, manager, peer_manager):
        self._m = manager
        self.peer = peer_manager
        self._cfg = manager.cfg
        self._stop = threading.Event()
        # Start from what the peer already has from us (its vv entry for
        # this site) — a rejoining peer resumes mid-stream, a fresh peer
        # replays our whole surviving journal.
        start = peer_manager.applier.vv.get(manager.site_id, 0)
        self.tail = JournalTail(manager.journal_path, from_seq=start)
        self.stats: Dict[str, int] = {
            "shipped_msgs": 0, "shipped_records": 0, "link_bytes": 0,
            "raw_bytes": 0, "partitions": 0, "gaps": 0, "errors": 0,
            "repairs": 0,
        }
        self._last_progress_s = manager.monotonic()
        self._thread = threading.Thread(
            target=self._run,
            name=f"redisson-torch-geo-{manager.site_id}->{peer_manager.site_id}",
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- lag (INFO replication / staleness) ---------------------------------

    def lag(self) -> Dict[str, float]:
        behind = self._m.journal_last_seq() - self.peer.applier.vv.get(
            self._m.site_id, 0)
        lag_s = 0.0
        if behind > 0:
            lag_s = max(0.0, self._m.monotonic() - self._last_progress_s)
        return {
            "records": max(0, behind),
            "seconds": lag_s,
            "link_bytes": self.stats["link_bytes"],
            "raw_bytes": self.stats["raw_bytes"],
        }

    # -- shipping loop ------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._cfg.poll_interval_s):
            try:
                self._tick()
            except Fault:
                self.stats["partitions"] += 1
            except JournalGap:
                self.stats["gaps"] += 1
                try:
                    self._snapshot_repair()
                except Exception:
                    self.stats["errors"] += 1
            except Exception:
                # Peer mid-shutdown / transient executor refusal: the
                # cursor held, so the records re-ship next tick.
                self.stats["errors"] += 1

    def _tick(self) -> None:
        fault_inject.fire("geo_link", target=self.peer.site_id)
        # Anti-entropy rewind: if the peer's vv for us regressed below our
        # cursor (stale sidecar after its restart), back up and re-ship;
        # the applier dedups anything it already holds.
        want = self.peer.applier.vv.get(self._m.site_id, 0) + 1
        if want < self.tail.next_seq:
            self.tail = JournalTail(self._m.journal_path, from_seq=want - 1)
        records = self.tail.poll(max_records=self._cfg.batch_records)
        watermark = self.tail.next_seq - 1
        known = self.peer.applier.vv.get(self._m.site_id, 0)
        if not records and watermark <= known:
            return
        msgs = self._build_msgs(records)
        self.peer.deliver(msgs, self._m.site_id, watermark)
        self.stats["shipped_msgs"] += len(msgs)
        self.stats["shipped_records"] += len(records)
        self._last_progress_s = self._m.monotonic()

    # -- record batch -> message batch ---------------------------------------

    def _build_msgs(self, records) -> List[dict]:
        msgs: List[dict] = []
        # Insertion-ordered fold groups: target -> (inner_kind, payloads,
        # last_seq). Cut at destructive boundaries so per-key order holds.
        pending: Dict[str, list] = {}

        def flush(target: str) -> None:
            group = pending.pop(target, None)
            if group is None:
                return
            msg = self._fold_msg(target, group[0], group[1], group[2])
            if msg is not None:
                msgs.append(msg)

        def flush_all() -> None:
            for t in list(pending):
                flush(t)

        for r in records:
            if r.kind not in SHIP_KINDS:
                continue
            self.stats["raw_bytes"] += self._raw_bytes(r)
            stamp = (r.seq, self._m.site_id)
            if r.kind in SEMILATTICE_KINDS:
                group = pending.get(r.target)
                if group is not None and group[0] != r.kind:
                    flush(r.target)
                    group = None
                if group is None:
                    pending[r.target] = group = [r.kind, [], r.seq]
                group[1].append(r.payload)
                group[2] = r.seq
                continue
            assert r.kind in DESTRUCTIVE_KINDS
            if r.kind == "flushall":
                flush_all()
                msgs.append({"kind": "flush", "target": "", "stamp": stamp})
            elif r.kind == "delete":
                flush(r.target)
                msgs.append(
                    {"kind": "delete", "target": r.target, "stamp": stamp})
            elif r.kind == "rename":
                new = r.payload.get("newkey") if isinstance(
                    r.payload, dict) else None
                flush(r.target)
                if new:
                    flush(new)
                msgs.append(
                    {"kind": "delete", "target": r.target, "stamp": stamp})
                if new:
                    st = self._m.export_state(new)
                    if st is not None:
                        st.update({"kind": "replace", "target": new,
                                   "stamp": stamp})
                        self.stats["link_bytes"] += st.pop("_link_bytes", 0)
                        msgs.append(st)
            else:  # bitset_clear: ship the post-clear plane, LWW-stamped
                flush(r.target)
                st = self._m.export_state(r.target)
                if st is not None:
                    st.update({"kind": "replace", "target": r.target,
                               "stamp": stamp})
                    self.stats["link_bytes"] += st.pop("_link_bytes", 0)
                    msgs.append(st)
        flush_all()
        return msgs

    @staticmethod
    def _raw_bytes(record) -> int:
        if record.kind in SEMILATTICE_KINDS and isinstance(
                record.payload, dict):
            try:
                return delta_mod.payload_raw_bytes(record.kind,
                                                   record.payload)
            except Exception:
                return 0
        return 0

    def _fold_msg(self, target: str, kind: str, payloads: List[dict],
                  last_seq: int) -> Optional[dict]:
        """Fold one run of same-kind writes to a single merge message.
        Falls back to a full-state export merge when a payload form can't
        be host-folded (an `add_device` record's keys, in the port's int64
        [n] layout or JAX's uint32 [n, 2], or the host fold library absent)
        — the full plane is a coarser join of the same semilattice, always
        safe, just more bytes."""
        stamp = (last_seq, self._m.site_id)
        nkeys = 0
        for p in payloads:
            try:
                nkeys += delta_mod.payload_nkeys(kind, p)
            except Exception:
                pass
        if all(delta_mod.foldable(kind, p) for p in payloads):
            plane = meta = None
            cells = 0
            packed = True
            if kind == "hll_add":
                plane = delta_mod.fold_hll(payloads, self._m.seed)
                cells, packed, meta = delta_mod.HLL_M, False, None
            elif kind == "bloom_add":
                bm = self._m.bloom_meta(target)
                if bm is not None:
                    m, k = bm["size"], bm["hash_iterations"]
                    plane = delta_mod.fold_bloom(
                        payloads, k, m, self._m.seed)
                    cells, meta = m, bm
            else:  # bitset_set
                mx = max((int(p.get("max_idx", -1)) for p in payloads),
                         default=-1)
                if mx >= 0:
                    plane = delta_mod.fold_bitset(payloads, mx + 1)
                    cells, meta = mx + 1, {"max_idx": mx}
            if plane is not None:
                msg = self._plane_msg(kind, target, plane, cells, packed,
                                      meta, nkeys)
                msg.update({"kind": "merge", "target": target,
                            "stamp": stamp})
                return msg
        # Full-state fallback: export the key's current plane and ship it
        # as a join. A missing key means a later destructive record (also
        # in this journal) already removed it — nothing to ship.
        st = self._m.export_state(target)
        if st is None:
            return None
        st.update({"kind": "merge", "target": target, "stamp": stamp,
                   "nkeys": nkeys})
        self.stats["link_bytes"] += st.pop("_link_bytes", 0)
        return st

    def _plane_msg(self, kind: str, target: str, plane: np.ndarray,
                   cells: int, packed: bool, meta: Optional[dict],
                   nkeys: int) -> dict:
        dp = delta_mod.encode(kind, target, plane, cells=cells,
                              packed=packed, nkeys=nkeys,
                              raw_bytes=0)
        self.stats["link_bytes"] += dp.link_bytes
        msg = {"inner": kind, "cells": dp.cells,
               "plane_bytes": dp.plane_bytes, "nkeys": nkeys}
        if meta:
            msg["meta"] = dict(meta)
        if dp.sparse:
            msg["idx"] = dp.idx
            msg["val"] = dp.val
        else:
            msg["plane"] = dp.dense
        return msg

    # -- gap repair ----------------------------------------------------------

    def _snapshot_repair(self) -> None:
        """The peer's cursor fell off our journal's surviving history.
        Re-seed it from live state: record the journal head FIRST (writes
        racing the export get re-shipped by the tail later — merges are
        idempotent), ship full-state repair merges stamped with each
        key's last-write stamp, the floor map as repair tombstones, and
        the flush floor; then resume tailing from the recorded head."""
        self.stats["repairs"] += 1
        target_seq = self._m.journal_last_seq()
        applier = self._m.applier
        msgs: List[dict] = []
        for key in sorted(self._m.local_keys()):
            st = self._m.export_state(key)
            if st is None:
                continue
            stamp = applier.lw.get(key) or (target_seq, self._m.site_id)
            st.update({"kind": "merge", "target": key, "stamp": stamp,
                       "repair": True})
            self.stats["link_bytes"] += st.pop("_link_bytes", 0)
            msgs.append(st)
        for key, stamp in list(applier.floor.items()):
            msgs.append({"kind": "delete", "target": key, "stamp": stamp,
                         "repair": True})
        if applier.flush_floor[0] > 0:
            msgs.append({"kind": "flush", "target": "",
                         "stamp": applier.flush_floor, "repair": True})
        self.peer.deliver(msgs, self._m.site_id, target_seq)
        self.tail = JournalTail(self._m.journal_path, from_seq=target_seq)
        self.stats["shipped_msgs"] += len(msgs)
        self._last_progress_s = self._m.monotonic()
