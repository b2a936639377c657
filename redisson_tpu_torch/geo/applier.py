"""Remote-mutation applier: LWW arbitration in front of the delta plane (a
copy of `redisson_tpu.geo.applier`).

Every remote message carries a **stamp** ``(origin_seq, site_id)`` — the
origin's journal sequence number plus its site id. Stamps are totally
ordered (tuple comparison; seqs grow monotonically per site, site ids
break ties), and every site arbitrates with the same order, so any two
sites that have seen the same message set reach the same state — the
convergence contract (geo/__init__.py) reduces to these rules:

  merge    applies iff stamp > floor[key] and stamp > flush_floor
           (semilattice join — commutes with everything it doesn't lose
           to); advances lw[key].
  delete   applies iff stamp > lw[key] — else it LOST to a newer write
           and is *suppressed*, and this site re-ships the key's full
           state as a repair merge so the deleting site resurrects it.
           Applying advances floor[key].
  replace  (full-state LWW overwrite: bitset clears, rename
           destinations, snapshot repair) applies iff stamp > floor[key]
           and stamp >= lw[key]; sets floor = lw = stamp. A replace that
           lost to a newer merge DEGRADES to a merge — its cells still
           join in, the newer write survives.
  flush    raises flush_floor and wipes exactly the local keys whose
           lw < stamp — resolved to a concrete key list under a
           dispatcher barrier so journal replay is deterministic. Keys
           whose lw >= stamp SURVIVE, and are re-shipped to every peer
           as repair merges (the flushing site wiped them locally, so
           the same add-wins resolution as the DEL race resurrects them
           there — without it the mesh would diverge).

``lw[key]`` is the newest applied merge/replace stamp, ``floor[key]``
the newest applied destructive stamp; both are fed by remote applies
AND by the local journal listener (``note_local``), so local writes
take part in the same arbitration.

``vv[origin]`` — the version vector — is the highest origin journal seq
this site has delivered. Senders attach a *watermark* (last origin seq
scanned, shipped or filtered) to every batch so filtered-out records
don't leave vv holes; anti-entropy rewinds a link's cursor to
``peer.vv[self] + 1`` after a restart or drop.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch import contractwitness
from redisson_tpu_torch.concurrency import make_lock

Stamp = Tuple[int, str]

#: Less than every real stamp (journal seqs start at 1).
NEG_STAMP: Stamp = (0, "")

#: Origin-op kinds a SiteLink ships. Everything else — reads, structure
#: ops, geo_* records journaled by remote applies (the echo-loop cut) —
#: stays site-local.
SEMILATTICE_KINDS = frozenset({"hll_add", "bloom_add", "bitset_set"})
DESTRUCTIVE_KINDS = frozenset({"delete", "rename", "flushall", "bitset_clear"})
SHIP_KINDS = SEMILATTICE_KINDS | DESTRUCTIVE_KINDS

GUARDED_BY = {
    "GeoApplier.vv": "_lock",
    "GeoApplier.lw": "_lock",
    "GeoApplier.floor": "_lock",
    "GeoApplier.flush_floor": "_lock",
    "GeoApplier.applied": "_lock",
    "GeoApplier.suppressed": "_lock",
    "GeoApplier.resurrections": "_lock",
    "GeoApplier._pending": "_lock",
}


def stamp_of(v) -> Stamp:
    """Normalize a stamp from a message / sidecar (lists after JSON or
    codec round-trips) back to a comparable tuple."""
    return (int(v[0]), str(v[1]))


class GeoApplier:
    """One per site. ``apply()`` is called by peer link threads (one
    thread per origin, so per-origin delivery is FIFO); ``note_local``
    by the journal's append path on the dispatcher thread, with records
    decoded from their framed bytes (it keeps no payload, only names).
    Decisions are made under ``_lock``; dispatches into the engine happen
    OUTSIDE it (the dispatcher thread calls back into ``note_local`` when
    the geo record journals, and holding our lock across that re-entry
    would order ``applier -> executor -> applier``)."""

    def __init__(self, manager):
        self._m = manager
        self._lock = make_lock("geo.GeoApplier._lock")
        self.vv: Dict[str, int] = {}
        self.lw: Dict[str, Stamp] = {}
        self.floor: Dict[str, Stamp] = {}
        self.flush_floor: Stamp = NEG_STAMP
        self.applied = 0
        self.suppressed = 0
        self.resurrections = 0
        self._pending: collections.deque = collections.deque()

    # -- local bookkeeping (journal listener, dispatcher thread) ------------

    def note_local(self, records) -> None:
        """Fold freshly journaled LOCAL records into the LWW maps so local
        writes arbitrate against remote ones. geo_* records only advance
        vv[self] — their LWW effect was recorded at apply() time."""
        site = self._m.site_id
        with self._lock:
            for r in records:
                self.vv[site] = r.seq
                if r.kind.startswith("geo_"):
                    continue
                stamp = (r.seq, site)
                if r.kind == "flushall":
                    if stamp > self.flush_floor:
                        self.flush_floor = stamp
                elif r.kind == "delete":
                    if stamp > self.floor.get(r.target, NEG_STAMP):
                        self.floor[r.target] = stamp
                elif r.kind == "rename":
                    self.floor[r.target] = stamp
                    new = r.payload.get("newkey") if isinstance(
                        r.payload, dict) else None
                    if new:
                        self.floor[new] = stamp
                        self.lw[new] = stamp
                elif r.kind == "bitset_clear":
                    self.floor[r.target] = stamp
                    self.lw[r.target] = stamp
                elif r.target:
                    if stamp > self.lw.get(r.target, NEG_STAMP):
                        self.lw[r.target] = stamp

    def rebuild(self, records) -> None:
        """Restart path: re-derive LWW state from journal records newer
        than the persisted sidecar (the sidecar flushes on the AE cadence,
        so it can trail the journal by one interval). geo_* payloads carry
        their origin stamps, which also claws back vv entries."""
        for r in records:
            payload = r.payload if isinstance(r.payload, dict) else {}
            stamp = payload.get("stamp")
            if r.kind.startswith("geo_") and stamp is not None:
                stamp = stamp_of(stamp)
                with self._lock:
                    self.vv[self._m.site_id] = r.seq
                    if stamp[1]:
                        self.vv[stamp[1]] = max(
                            self.vv.get(stamp[1], 0), stamp[0])
                    if r.kind == "geo_merge":
                        if stamp > self.lw.get(r.target, NEG_STAMP):
                            self.lw[r.target] = stamp
                    elif r.kind == "geo_replace":
                        self.floor[r.target] = stamp
                        self.lw[r.target] = stamp
                    elif r.kind == "geo_delete":
                        if stamp > self.floor.get(r.target, NEG_STAMP):
                            self.floor[r.target] = stamp
                    elif r.kind == "geo_flush":
                        if stamp > self.flush_floor:
                            self.flush_floor = stamp
            else:
                self.note_local([r])

    # -- remote delivery (peer link threads) --------------------------------

    def apply(self, msgs: List[dict], origin: str, watermark: int) -> int:
        """Deliver one shipped batch from ``origin``. Returns the number
        of messages that passed arbitration and were dispatched."""
        dispatched = 0
        for msg in msgs:
            if self._apply_one(msg, origin):
                dispatched += 1
        with self._lock:
            if watermark > self.vv.get(origin, 0):
                self.vv[origin] = watermark
        return dispatched

    def _apply_one(self, msg: dict, origin: str) -> bool:
        stamp = stamp_of(msg["stamp"])
        kind = msg["kind"]
        repair = bool(msg.get("repair"))
        resurrect: Optional[str] = None
        action: Optional[str] = None
        with self._lock:
            # Dedup redelivery (anti-entropy rewinds): a non-repair stamp
            # from the origin's own journal at or below vv is already in.
            if (not repair and stamp[1] == origin
                    and stamp[0] <= self.vv.get(origin, 0)):
                return False
            if kind == "merge":
                key = msg["target"]
                if (stamp > self.floor.get(key, NEG_STAMP)
                        and stamp > self.flush_floor):
                    action = "geo_merge"
                    if stamp > self.lw.get(key, NEG_STAMP):
                        self.lw[key] = stamp
                else:
                    self.suppressed += 1
            elif kind == "delete":
                key = msg["target"]
                if stamp <= self.flush_floor:
                    self.suppressed += 1
                elif stamp > self.lw.get(key, NEG_STAMP):
                    action = "geo_delete"
                    if stamp > self.floor.get(key, NEG_STAMP):
                        self.floor[key] = stamp
                else:
                    # Lost to a newer write: suppress, then resurrect the
                    # key at the deleting site by re-shipping full state.
                    self.suppressed += 1
                    self.resurrections += 1
                    resurrect = key
            elif kind == "replace":
                key = msg["target"]
                if (stamp <= self.floor.get(key, NEG_STAMP)
                        or stamp <= self.flush_floor):
                    self.suppressed += 1
                elif stamp >= self.lw.get(key, NEG_STAMP):
                    action = "geo_replace"
                    self.floor[key] = stamp
                    self.lw[key] = stamp
                else:
                    # Lost LWW to a newer merge: degrade to a join so its
                    # cells survive alongside the newer write.
                    action = "geo_merge"
            elif kind == "flush":
                if stamp > self.flush_floor:
                    self.flush_floor = stamp
                    action = "geo_flush"
                else:
                    self.suppressed += 1
        if action == "geo_flush":
            self._dispatch_flush(stamp)
            return True
        if action is not None:
            payload = {k: v for k, v in msg.items()
                       if k not in ("kind", "target", "repair")}
            payload["stamp"] = stamp
            with contractwitness.surface("geo"):
                fut = self._m.execute_async(
                    msg["target"], action, payload,
                    nkeys=int(msg.get("nkeys", 0) or 0))
            self._track(fut)
        if resurrect is not None:
            self._m.broadcast_repair(resurrect)
        return action is not None

    def _dispatch_flush(self, stamp: Stamp) -> None:
        """Resolve the flush to a concrete key list (keys whose newest
        write predates the flush stamp) under a dispatcher barrier —
        the barrier is a consistency cut over every in-flight write, and
        journaling the explicit list keeps crash replay deterministic.
        Survivors (lw >= stamp: they beat the flush on the LWW order)
        are re-shipped as repair merges, because the flushing site wiped
        them locally — same add-wins resolution as a lost DEL."""
        keys = self._m.local_keys()
        with self._lock:
            doomed = [k for k in keys
                      if self.lw.get(k, NEG_STAMP) < stamp]
        with contractwitness.surface("geo"):
            fut = self._m.execute_async(
                "", "geo_flush", {"keys": doomed, "stamp": stamp})
        self._track(fut)
        survivors = keys.difference(doomed)
        shipped = sum(1 for k in sorted(survivors)
                      if self._m.broadcast_repair(k))
        if shipped:
            with self._lock:
                self.resurrections += shipped

    # -- settle support -----------------------------------------------------

    def _track(self, fut) -> None:
        with self._lock:
            self.applied += 1
            self._pending.append(fut)
            while (len(self._pending) > self._m.cfg.apply_window
                   and self._pending[0].done()):
                self._pending.popleft()

    def pending(self) -> int:
        """Dispatched-but-unretired remote applies (converge() polls it)."""
        with self._lock:
            while self._pending and self._pending[0].done():
                self._pending.popleft()
            return len(self._pending)

    # -- sidecar snapshot ---------------------------------------------------

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "vv": dict(self.vv),
                "lw": {k: list(v) for k, v in self.lw.items()},
                "floor": {k: list(v) for k, v in self.floor.items()},
                "flush_floor": list(self.flush_floor),
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.vv.update({k: int(v) for k, v in
                            (state.get("vv") or {}).items()})
            self.lw.update({k: stamp_of(v) for k, v in
                            (state.get("lw") or {}).items()})
            self.floor.update({k: stamp_of(v) for k, v in
                               (state.get("floor") or {}).items()})
            ff = state.get("flush_floor")
            if ff is not None:
                self.flush_floor = max(self.flush_floor, stamp_of(ff))
