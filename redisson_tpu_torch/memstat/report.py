"""Redis MEMORY command-family parity over the byte ledger (counterpart of
`redisson_tpu.memstat.report`).

``memory_usage`` answers per-key bytes (exact device bytes + a
deterministic metadata-overhead estimate, like Redis counting the robj
and key string on top of the value). ``memory_stats`` mirrors the
``MEMORY STATS`` field vocabulary (``peak.allocated``,
``dataset.percentage``, per-kind totals, a fragmentation analogue —
scratch+cache+staging over live state: the ledger counts tensors, not
the caching allocator's blocks, and "bytes held beyond the dataset" is
the failure mode that matters). ``memory_doctor`` runs rule-based findings, and
``info_memory`` is the block the client folds into ``INFO``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

# Fixed per-object bookkeeping estimate: StoredObject slots, dict entry,
# version/slot ints — deterministic so memory_usage is reproducible.
_OBJ_OVERHEAD = 64


def _meta_overhead(name: str, meta: Optional[Dict[str, Any]]) -> int:
    over = _OBJ_OVERHEAD + len(name.encode())
    for k in (meta or {}):
        over += len(str(k)) + 8
    return over


class MemoryReport:
    """Report-time views over a MemLedger (never on the hot path)."""

    def __init__(self, ledger: Any, store: Any = None,
                 backend: Any = None, pressure: Any = None) -> None:
        self.ledger = ledger
        self.store = store
        self.backend = backend
        self.pressure = pressure

    # -- MEMORY USAGE ----------------------------------------------------

    def memory_usage(self, name: str) -> Optional[int]:
        """Exact device bytes plus metadata overhead for one key, or
        None when the key doesn't exist (Redis returns nil). HLL names
        live in the shared bank: their share is one bank row."""
        backend = self.backend
        if backend is not None:
            rows = getattr(backend, "_rows", None)
            bank = getattr(backend, "bank", None)
            if rows and name in rows and bank is not None:
                per_row = int(bank.nbytes) // max(1, bank.shape[0])
                return per_row + _meta_overhead(name, None)
        if self.store is not None:
            obj = self.store.get(name)
            if obj is not None:
                return (int(obj.state.nbytes)
                        + _meta_overhead(name, obj.meta))
        e = self.ledger.entry(name)
        if e is None:
            return None
        return e["nbytes"] + _meta_overhead(name, None)

    # -- MEMORY STATS ----------------------------------------------------

    def keys_count(self) -> int:
        """Addressable keys: store objects plus allocated HLL rows (the
        bank ledger entry itself is not a key)."""
        n = 0
        if self.store is not None:
            n += len(self.store.keys())
        rows = getattr(self.backend, "_rows", None)
        if rows:
            n += len(rows)
        if n:
            return n
        # No store wired (unit tests on a bare ledger): entries minus
        # the bank pseudo-entry.
        n = self.ledger.keys_count()
        return n - (1 if self.ledger.bank_bytes() > 0 else 0)

    def memory_stats(self) -> Dict[str, Any]:
        live = self.ledger.live_bytes()
        peak = self.ledger.peak_bytes()
        totals = self.ledger.meter_totals()
        overhead = (totals["cache"] + totals["scratch"]
                    + totals["staging"])
        allocated = live + overhead
        keys = self.keys_count()
        out: Dict[str, Any] = {
            "peak.allocated": peak,
            "total.allocated": allocated,
            "dataset.bytes": live,
            "dataset.percentage": round(
                100.0 * live / allocated, 2) if allocated else 100.0,
            "keys.count": keys,
            "keys.bytes-per-key": live // keys if keys else 0,
            "cache.bytes": totals["cache"],
            "scratch.bytes": totals["scratch"],
            "staging.bytes": totals["staging"],
            "disk.bytes": totals["disk"],
            "fragmentation": round(
                allocated / live, 4) if live else 1.0,
            "bank.bytes": self.ledger.bank_bytes(),
            "lifecycle.events": self.ledger.events(),
        }
        for kind, nb in sorted(self.ledger.kind_bytes().items()):
            out[f"{kind}.bytes"] = nb
        attr = self.ledger.attribution()
        out["by_tenant"] = attr["by_tenant"]
        out["by_slot"] = attr["by_slot"]
        return out

    # -- MEMORY DOCTOR ---------------------------------------------------

    def memory_doctor(self) -> Dict[str, Any]:
        """Rule-based findings, Redis-doctor style: empty-instance and
        all-clear short-circuits, otherwise a list of named findings."""
        live = self.ledger.live_bytes()
        totals = self.ledger.meter_totals()
        findings: List[Dict[str, str]] = []

        cache = totals["cache"]
        if cache > 0 and cache > live:
            findings.append({
                "rule": "cache-dominates",
                "detail": f"read-cache bytes ({cache}) exceed live "
                          f"dataset bytes ({live}); cached copies are "
                          "outgrowing the state they shadow — check "
                          "read_cache_entries sizing.",
            })
        scratch = totals["scratch"] + totals["staging"]
        if scratch > 0 and live == 0:
            findings.append({
                "rule": "orphaned-scratch",
                "detail": f"{scratch} scratch/staging bytes held with "
                          "zero live dataset bytes — a scratch plane or "
                          "staging buffer was not released (leak).",
            })
        pressure = self.pressure
        if pressure is not None:
            cfg = pressure.config
            high = cfg.high_watermark_bytes
            if high > 0:
                total = pressure.total_bytes()
                if total >= cfg.doctor_watermark_ratio * high:
                    findings.append({
                        "rule": "near-watermark",
                        "detail": f"usage {total} is within "
                                  f"{int(100 * (1 - cfg.doctor_watermark_ratio))}% "
                                  f"of the high-watermark ({high}); "
                                  "writes will shed soon.",
                    })
        kinds = self.ledger.kind_bytes()
        if live > 0 and len(kinds) >= 2:
            top_kind, top = max(kinds.items(), key=lambda kv: kv[1])
            if top > 0.9 * live:
                findings.append({
                    "rule": "kind-dominance",
                    "detail": f"kind '{top_kind}' holds {top} of {live} "
                              "live bytes (>90%); capacity planning "
                              "should treat this tier as single-kind.",
                })
        if live == 0 and not findings:
            msg = ("Hi! This instance is empty — no memory advice to "
                   "give. Come back with some data.")
        elif not findings:
            msg = ("Hi! No memory issues detected: the ledger is "
                   "balanced and overheads are proportionate. Carry on.")
        else:
            msg = (f"Hi! I detected {len(findings)} issue(s) worth a "
                   "look — details below.")
        return {"message": msg, "findings": findings}

    # -- INFO memory -----------------------------------------------------

    def info_memory(self) -> Dict[str, Any]:
        live = self.ledger.live_bytes()
        totals = self.ledger.meter_totals()
        overhead = (totals["cache"] + totals["scratch"]
                    + totals["staging"])
        used = live + overhead
        pressure = self.pressure
        high = 0
        if pressure is not None:
            high = pressure.config.high_watermark_bytes
        out = {
            "used_memory": used,
            "used_memory_human": _human(used),
            "used_memory_dataset": live,
            "used_memory_dataset_perc": (
                f"{100.0 * live / used:.2f}%" if used else "100.00%"),
            "used_memory_peak": self.ledger.peak_bytes(),
            "used_memory_peak_human": _human(self.ledger.peak_bytes()),
            "mem_fragmentation_ratio": round(
                used / live, 4) if live else 1.0,
            "maxmemory": high,
            "maxmemory_policy": (
                "shed-writes" if high > 0 else "noeviction"),
            "number_of_keys": self.keys_count(),
            "disk_bytes": totals["disk"],
        }
        if pressure is not None:
            fc = pressure.forecast()
            out["memory_growth_rate_bytes_s"] = fc["rate_bytes_s"]["total"]
            eta = fc["seconds_to_watermark"]
            if eta is not None:
                out["seconds_to_watermark"] = round(eta, 1)
        return out


def _human(n: int) -> str:
    val = float(n)
    for unit in ("B", "K", "M", "G", "T"):
        if abs(val) < 1024.0 or unit == "T":
            return (f"{val:.2f}{unit}" if unit != "B"
                    else f"{int(val)}B")
        val /= 1024.0
    return f"{val:.2f}T"
