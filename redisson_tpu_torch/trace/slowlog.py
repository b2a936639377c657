"""SLOWLOG parity: threshold-gated bounded ring of slow-op records
(counterpart of `redisson_tpu.trace.slowlog`).

Mirrors redis ``SLOWLOG GET/RESET/LEN`` (RedisCommands.java SLOWLOG
descriptors): entries above ``threshold_s`` land in a bounded ring,
newest first on read.  Unlike redis, each entry carries the per-stage
breakdown from the op's span, so a slow op is attributed to admission
queue vs journal fsync vs device time instead of being a bare duration.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.trace.spans import Span


@dataclass
class SlowLogEntry:
    entry_id: int
    ts_wall: float       # unix time, for operator display (SLOWLOG parity)
    kind: str
    target: str
    tenant: str
    duration_s: float
    stages: Dict[str, float]
    events: List[Tuple[str, float]] = field(default_factory=list)
    annotations: Dict[str, Any] = field(default_factory=dict)
    error: Optional[str] = None

    @property
    def worst_stage(self) -> str:
        """The stage that ate the most time (excluding the total)."""
        best, best_d = "", -1.0
        for stage, d in self.stages.items():
            if stage != "total" and d > best_d:
                best, best_d = stage, d
        return best

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.entry_id,
            "ts": self.ts_wall,
            "kind": self.kind,
            "target": self.target,
            "tenant": self.tenant,
            "duration_s": self.duration_s,
            "stages": dict(self.stages),
            "worst_stage": self.worst_stage,
            "events": list(self.events),
            "annotations": dict(self.annotations),
            "error": self.error,
        }


class SlowLog:
    """Bounded ring of ops slower than ``threshold_s``."""

    def __init__(self, threshold_s: float = 0.010, maxlen: int = 128):
        self.threshold_s = float(threshold_s)
        self.maxlen = max(1, int(maxlen))
        self._entries: List[SlowLogEntry] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.total_logged = 0

    def offer(self, span: Span) -> Optional[SlowLogEntry]:
        """Record ``span`` if it crossed the threshold; return the entry."""
        duration = span.duration_s
        if duration < self.threshold_s:
            return None
        entry = SlowLogEntry(
            entry_id=next(self._ids),
            # Wall time is display-only metadata (matches redis SLOWLOG
            # unix timestamps); all durations come from the span's
            # monotonic clock.
            ts_wall=time.time(),  # display only; durations stay monotonic
            kind=span.kind,
            target=span.target,
            tenant=span.tenant,
            duration_s=duration,
            stages=span.stages(),
            events=list(span.events),
            annotations=dict(span.annotations),
            error=span.error,
        )
        with self._lock:
            self._entries.append(entry)
            if len(self._entries) > self.maxlen:
                del self._entries[: len(self._entries) - self.maxlen]
            self.total_logged += 1
        return entry

    def get(self, count: Optional[int] = None) -> List[SlowLogEntry]:
        """Newest-first, like ``SLOWLOG GET [count]``."""
        with self._lock:
            entries = list(reversed(self._entries))
        return entries if count is None else entries[: max(0, int(count))]

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            entries = list(self._entries)
        return {
            "threshold_s": self.threshold_s,
            "maxlen": self.maxlen,
            "len": len(entries),
            "total_logged": self.total_logged,
            "entries": [e.to_dict() for e in entries[-8:]],
        }
