"""Memory-pressure monitoring: growth forecasting and write shedding
(counterpart of `redisson_tpu.memstat.pressure`).

An EWMA growth-rate tracker per kind turns the ledger's byte totals into
a time-to-watermark forecast, and a gate hooked into serve admission
sheds memory-growing writes with ``RejectedError`` (retry-after) once
usage crosses the configured high-watermark — graceful degradation
instead of device OOM. Reads always flow, and so do writes that reclaim
memory (DEL/FLUSHALL/RENAME), mirroring Redis which still honours DEL at
``maxmemory``. Hysteresis: once shedding starts it only stops below the
low-watermark, so usage hovering at the line doesn't flap.

The monitor's snapshot also says how much memory the devices have
(``device_memory``): on a CUDA card as CUDA and the caching allocator
report it (``torch.cuda.mem_get_info`` / ``memory_stats``), on the CPU
the configured capacity. ``devices`` holds one section per device the
client's state lives on (every card of a pod spread over several),
``device`` the first of them (the client's own device). The gate never
reads them: it sheds by the ledger and the configured marks alone, as
JAX's does.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

from redisson_tpu_torch.serve.errors import RejectedError

# Write kinds that free or move bytes; never shed under pressure.
RECLAIM_KINDS = frozenset({"delete", "flushall", "rename", "expire",
                           "persist"})

_WRITE_KINDS: Optional[frozenset] = None


def _write_kinds() -> frozenset:
    """The write-kind set of the op table, so pressure classification stays
    in lockstep with dispatch. A table that cannot be read raises: the gate
    never falls back to admitting every write."""
    global _WRITE_KINDS
    if _WRITE_KINDS is None:
        from redisson_tpu_torch.commands import OP_TABLE
        _WRITE_KINDS = frozenset(
            k for k, spec in OP_TABLE.items() if spec.write)
    return _WRITE_KINDS


def device_memory(device, capacity: int = 0) -> Dict[str, Any]:
    """The device's memory: on a CUDA card its free and total bytes
    (``torch.cuda.mem_get_info``) and the caching allocator's allocated and
    reserved bytes (``torch.cuda.memory_stats``); on the CPU the configured
    `capacity` (0 = unknown), nothing measured."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        stats = torch.cuda.memory_stats(dev)
        return {"source": "torch.cuda", "total_bytes": int(total),
                "free_bytes": int(free),
                "allocated_bytes": int(stats.get("allocated_bytes.all.current", 0)),
                "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0))}
    return {"source": "config", "total_bytes": int(capacity), "free_bytes": None,
            "allocated_bytes": None, "reserved_bytes": None}


class _Ewma:
    """Halflife-parameterised EWMA of a rate (bytes/second)."""

    __slots__ = ("halflife_s", "value", "_t")

    def __init__(self, halflife_s: float):
        self.halflife_s = max(1e-3, float(halflife_s))
        self.value = 0.0
        self._t: Optional[float] = None

    def update(self, rate: float, now: float) -> float:
        if self._t is None:
            self.value = rate
        else:
            dt = max(0.0, now - self._t)
            alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
            self.value += alpha * (rate - self.value)
        self._t = now
        return self.value


class PressureMonitor:
    """Forecasts headroom and gates memory-growing writes.

    ``check_write`` is on the admission hot path: it reads the ledger's
    O(1) live total and a cached meter sample (refreshed at most every
    ``meter_refresh_s``), so no meter callable runs per-op.
    """

    def __init__(self, ledger: Any, config: Any,
                 clock=time.monotonic, device_fn=None) -> None:
        self.ledger = ledger
        self.config = config
        self._clock = clock
        self._rates: Dict[str, _Ewma] = {}
        self._last_kind: Dict[str, int] = {}
        self._last_sample: Optional[float] = None
        self._meter_cache = (-math.inf, 0)   # (sampled_at, bytes)
        self._shedding = False
        self.shed_total = 0
        # device_fn() -> {device name: device_memory(...)}, the client's
        # own device first, for the snapshot (None: omitted).
        self.device_fn = device_fn

    # -- sampling / forecasting -----------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """Feed current per-kind totals into the EWMA trackers."""
        now = self._clock() if now is None else now
        kinds = self.ledger.kind_bytes()
        if self._last_sample is not None:
            dt = now - self._last_sample
            if dt <= 0:
                return
            for kind in set(kinds) | set(self._last_kind):
                inst = (kinds.get(kind, 0)
                        - self._last_kind.get(kind, 0)) / dt
                ew = self._rates.get(kind)
                if ew is None:
                    ew = self._rates[kind] = _Ewma(
                        self.config.ewma_halflife_s)
                ew.update(inst, now)
        self._last_sample = now
        self._last_kind = kinds

    def _overhead(self, now: float) -> int:
        if not self.config.include_overhead:
            return 0
        at, val = self._meter_cache
        if now - at >= self.config.meter_refresh_s:
            val = self.ledger.overhead_bytes()
            self._meter_cache = (now, val)
        return val

    def total_bytes(self, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        return self.ledger.live_bytes() + self._overhead(now)

    def forecast(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-kind growth rate and seconds until the high-watermark at
        the current aggregate rate (None when shrinking/flat or no
        watermark is configured)."""
        now = self._clock() if now is None else now
        self.sample(now)
        per_kind = {k: round(ew.value, 3)
                    for k, ew in self._rates.items()}
        total_rate = sum(ew.value for ew in self._rates.values())
        high = self.config.high_watermark_bytes
        eta = None
        if high > 0 and total_rate > 0:
            headroom = high - self.total_bytes(now)
            eta = max(0.0, headroom / total_rate)
        return {
            "rate_bytes_s": {**per_kind, "total": round(total_rate, 3)},
            "high_watermark_bytes": high,
            "total_bytes": self.total_bytes(now),
            "seconds_to_watermark": eta,
        }

    # -- the admission gate ---------------------------------------------

    def should_shed(self, kind: str, now: Optional[float] = None) -> bool:
        high = self.config.high_watermark_bytes
        if high <= 0:
            return False
        if kind in RECLAIM_KINDS or kind not in _write_kinds():
            return False
        now = self._clock() if now is None else now
        total = self.total_bytes(now)
        if self._shedding:
            low = self.config.low_watermark_bytes or high
            if total < low:
                self._shedding = False
        elif total >= high:
            self._shedding = True
        return self._shedding

    def check_write(self, kind: str,
                    now: Optional[float] = None) -> None:
        """Raise RejectedError(reason='memory') for a memory-growing
        write above the high-watermark; no-op otherwise."""
        if self.should_shed(kind, now):
            self.shed_total += 1
            raise RejectedError(
                "memory high-watermark reached "
                f"({self.config.high_watermark_bytes} bytes); "
                f"write '{kind}' shed",
                retry_after_s=self.config.retry_after_s,
                reason="memory")

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock()
        fc = self.forecast(now)
        snap = {
            "shedding": self._shedding,
            "shed_total": self.shed_total,
            "low_watermark_bytes": self.config.low_watermark_bytes,
            **fc,
        }
        if self.device_fn is not None:
            sections = self.device_fn()
            snap["device"] = next(iter(sections.values()))
            snap["devices"] = sections
        return snap
