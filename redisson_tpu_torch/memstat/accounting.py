"""Exact per-target byte ledger for device-resident sketch state
(counterpart of `redisson_tpu.memstat.accounting`).

The ledger mirrors the store registry byte-for-byte: every change of an
object's tensor (create, swap/grow, delete, rename, flushall, checkpoint /
rebuild restore — restores route through the same store methods) fires a
lifecycle event here *inside* the store lock, so the ledger's running
total always equals the sum of live ``tensor.nbytes``. ``nbytes`` is
tensor metadata (no device sync), which is what makes always-on
accounting affordable on the hot path. Cells and bank rows written in
place keep their size; only a growth reallocates, and every growth goes
through `store.swap` or the backend's bank hooks.

The shared HLL bank holds many logical rows (one device tensor, or the
blocks of a pod's or the mesh plane's bank, counted whole by `nbytes`);
it is tracked as one ledger entry (kind ``"hll"``) updated from the
backend's ``_ensure_bank`` / ``_grow_bank`` / flushall / state-install
hooks. Per-row attribution is derived arithmetically at report time,
never counted twice here.

Auxiliary consumers (read-cache copies, bloom mirrors, delta scratch
planes, pipeline staging buffers, journal/snapshot files) are *meters*:
lazily-evaluated callables sampled only when a report asks. They are
deliberately outside the exact invariant — ``verify()`` checks live
state only.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

# Meter categories: device-adjacent overhead vs. on-disk bytes. The
# fragmentation analogue in report.py counts cache+scratch+staging
# against live state; disk is reported but never part of that ratio.
METER_CATEGORIES = ("cache", "scratch", "staging", "disk")

# Ledger name for the shared HLL bank entry (one array, many rows).
BANK_ENTRY = "__hll_bank__"


class _Entry:
    __slots__ = ("kind", "tenant", "slot", "nbytes")

    def __init__(self, kind: str, tenant: str, slot: int, nbytes: int):
        self.kind = kind
        self.tenant = tenant
        self.slot = slot
        self.nbytes = nbytes


class MemLedger:
    """Always-on byte ledger with O(1) event updates.

    Event methods are called under the store lock and must stay cheap
    and non-raising; everything aggregate (attribution rollups, meter
    sampling, verify) is report-time only.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._live = 0          # exact device bytes (entries incl. bank)
        self._peak = 0          # monotone high-water mark of _live
        self._kind_bytes: Dict[str, int] = {}
        self._events = 0
        self._meters: Dict[str, tuple] = {}   # name -> (fn, category)
        self.meter_errors = 0

    # -- lifecycle events (store seam; called under the store lock) ------

    def on_create(self, name: str, kind: str, nbytes: int,
                  slot: int = -1, tenant: str = "") -> None:
        nbytes = int(nbytes)
        with self._lock:
            prev = self._entries.get(name)
            if prev is not None:            # idempotent re-create
                self._bump(prev.kind, -prev.nbytes)
            self._entries[name] = _Entry(kind, tenant, int(slot), nbytes)
            self._bump(kind, nbytes)
            self._events += 1

    def on_resize(self, name: str, nbytes: int) -> None:
        """Swap/grow: the object's device array was replaced."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return
            self._bump(e.kind, int(nbytes) - e.nbytes)
            e.nbytes = int(nbytes)
            self._events += 1

    def on_delete(self, name: str) -> None:
        with self._lock:
            e = self._entries.pop(name, None)
            if e is not None:
                self._bump(e.kind, -e.nbytes)
                self._events += 1

    def on_rename(self, name: str, new_name: str,
                  slot: Optional[int] = None) -> None:
        """Redis RENAME semantics: an existing destination is clobbered,
        so its bytes are debited before the source entry moves."""
        with self._lock:
            e = self._entries.pop(name, None)
            if e is None:
                return
            dest = self._entries.pop(new_name, None)
            if dest is not None:
                self._bump(dest.kind, -dest.nbytes)
            if slot is not None:
                e.slot = int(slot)
            self._entries[new_name] = e
            self._events += 1

    def on_flushall(self) -> None:
        with self._lock:
            self._entries.clear()
            self._kind_bytes.clear()
            self._live = 0
            self._events += 1

    def _clear_bank_locked(self) -> None:
        # Caller holds self._lock. Drops the plain bank entry AND any
        # per-shard bank entries (mesh data plane) in one sweep, so the two
        # accounting shapes are freely interchangeable.
        for name in [n for n in self._entries
                     if n == BANK_ENTRY or n.startswith(BANK_ENTRY + ":")]:
            e = self._entries.pop(name)
            self._bump(e.kind, -e.nbytes)

    def set_bank_bytes(self, nbytes: int) -> None:
        """Track the shared HLL bank (one entry, kind 'hll')."""
        nbytes = int(nbytes)
        with self._lock:
            self._clear_bank_locked()
            if nbytes > 0:
                self._entries[BANK_ENTRY] = _Entry("hll", "", -1, nbytes)
                self._bump("hll", nbytes)
            self._events += 1

    def set_bank_shard_bytes(self, by_shard: Dict[int, int],
                             unassigned: int = 0) -> None:
        """Mesh data plane: track the sharded bank as per-shard entries, one
        ``__hll_bank__:shard-K`` entry per logical shard (tenant
        ``shard-K``, so ``attribution()`` rollups give bank rows to the
        shards that own them) plus a plain ``__hll_bank__`` entry for the
        unassigned remainder (free rows). The entries total the bank
        tensor's nbytes, so ``verify()`` stays exact."""
        with self._lock:
            self._clear_bank_locked()
            for shard in sorted(by_shard):
                nb = int(by_shard[shard])
                if nb <= 0:
                    continue
                tenant = f"shard-{int(shard)}"
                self._entries[f"{BANK_ENTRY}:{tenant}"] = _Entry(
                    "hll", tenant, -1, nb)
                self._bump("hll", nb)
            unassigned = int(unassigned)
            if unassigned > 0:
                self._entries[BANK_ENTRY] = _Entry("hll", "", -1, unassigned)
                self._bump("hll", unassigned)
            self._events += 1

    def _bump(self, kind: str, delta: int) -> None:
        # Caller holds self._lock.
        self._live += delta
        kb = self._kind_bytes.get(kind, 0) + delta
        if kb:
            self._kind_bytes[kind] = kb
        else:
            self._kind_bytes.pop(kind, None)
        if self._live > self._peak:
            self._peak = self._live

    # -- reads -----------------------------------------------------------

    def live_bytes(self) -> int:
        with self._lock:
            return self._live

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def keys_count(self) -> int:
        """Named ledger entries (bank counts as one)."""
        with self._lock:
            return len(self._entries)

    def events(self) -> int:
        with self._lock:
            return self._events

    def kind_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._kind_bytes)

    def bank_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for n, e in self._entries.items()
                       if n == BANK_ENTRY or n.startswith(BANK_ENTRY + ":"))

    def entry(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return None
            return {"kind": e.kind, "tenant": e.tenant,
                    "slot": e.slot, "nbytes": e.nbytes}

    def attribution(self) -> Dict[str, Dict[str, int]]:
        """Report-time rollups by kind, tenant, and slot."""
        with self._lock:
            items = [(e.kind, e.tenant, e.slot, e.nbytes)
                     for e in self._entries.values()]
        by_kind: Dict[str, int] = {}
        by_tenant: Dict[str, int] = {}
        by_slot: Dict[str, int] = {}
        for kind, tenant, slot, nb in items:
            by_kind[kind] = by_kind.get(kind, 0) + nb
            tkey = tenant or "-"
            by_tenant[tkey] = by_tenant.get(tkey, 0) + nb
            skey = str(slot)
            by_slot[skey] = by_slot.get(skey, 0) + nb
        return {"by_kind": by_kind, "by_tenant": by_tenant,
                "by_slot": by_slot}

    # -- auxiliary meters ------------------------------------------------

    def register_meter(self, name: str, fn: Callable[[], int],
                       category: str) -> None:
        if category not in METER_CATEGORIES:
            raise ValueError(f"unknown meter category '{category}'")
        with self._lock:
            self._meters[name] = (fn, category)

    def unregister_meter(self, name: str) -> None:
        with self._lock:
            self._meters.pop(name, None)

    def meters(self) -> Dict[str, Dict[str, Any]]:
        """Sample every registered meter, isolating failures (a broken
        meter reads 0 and bumps ``meter_errors``, never breaks a report)."""
        with self._lock:
            meters = dict(self._meters)
        out: Dict[str, Dict[str, Any]] = {}
        for name, (fn, category) in meters.items():
            try:
                val = int(fn() or 0)
            except Exception:
                val = 0
                with self._lock:
                    self.meter_errors += 1
            out[name] = {"bytes": val, "category": category}
        return out

    def meter_totals(self) -> Dict[str, int]:
        """Per-category totals across all meters (all categories present,
        zero-filled)."""
        totals = {c: 0 for c in METER_CATEGORIES}
        for m in self.meters().values():
            totals[m["category"]] += m["bytes"]
        return totals

    def overhead_bytes(self) -> int:
        """Device-adjacent overhead: cache + scratch + staging (no disk)."""
        t = self.meter_totals()
        return t["cache"] + t["scratch"] + t["staging"]

    # -- the invariant ---------------------------------------------------

    def verify(self, store: Any, backend: Any = None) -> Dict[str, Any]:
        """Walk the live registry and compare against the ledger.

        Returns drift in both directions: ``missing`` (live objects the
        ledger never saw), ``stale`` (ledger entries with no live
        object), and per-name ``mismatched`` byte counts. ``drift_bytes``
        is actual - ledger; zero when the invariant holds.
        """
        actual = dict(store.live_nbytes())
        if backend is not None and getattr(backend, "accounting",
                                           None) is self:
            bank = getattr(backend, "bank", None)
            if bank is not None:
                actual[BANK_ENTRY] = int(bank.nbytes)
        with self._lock:
            # Per-shard bank entries (mesh data plane) add up to the bank
            # they account before the comparison.
            ledger: Dict[str, int] = {}
            bank_total = 0
            for n, e in self._entries.items():
                if n == BANK_ENTRY or n.startswith(BANK_ENTRY + ":"):
                    bank_total += e.nbytes
                else:
                    ledger[n] = e.nbytes
            if bank_total:
                ledger[BANK_ENTRY] = bank_total
            ledger_total = self._live
        actual_total = sum(actual.values())
        missing = sorted(n for n in actual if n not in ledger)
        stale = sorted(n for n in ledger if n not in actual)
        mismatched = {n: {"ledger": ledger[n], "actual": actual[n]}
                      for n in ledger
                      if n in actual and ledger[n] != actual[n]}
        drift = actual_total - ledger_total
        return {
            "ok": not missing and not stale and not mismatched
                  and drift == 0,
            "ledger_bytes": ledger_total,
            "actual_bytes": actual_total,
            "drift_bytes": drift,
            "missing": missing,
            "stale": stale,
            "mismatched": mismatched,
        }
