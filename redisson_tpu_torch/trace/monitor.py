"""MONITOR parity: live tap of op traffic with bounded, non-blocking fan-out
(counterpart of `redisson_tpu.trace.monitor`).

Redis MONITOR streams every command to the subscriber; a slow MONITOR
client slows the server.  Here each subscriber gets a bounded queue
that **drops new events and counts them** when full — the publisher
(the executor's dispatch path) never blocks and never allocates more
than one dict per event.  Publishing costs one integer check when no
taps are attached.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class MonitorTap:
    """One subscriber's bounded event queue (drop-and-count on overflow)."""

    __slots__ = ("maxlen", "_events", "_lock", "dropped", "closed")

    def __init__(self, maxlen: int = 1024):
        self.maxlen = max(1, int(maxlen))
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.dropped = 0
        self.closed = False

    def offer(self, event: Dict[str, Any]) -> bool:
        with self._lock:
            if self.closed:
                return False
            if len(self._events) >= self.maxlen:
                self.dropped += 1
                return False
            self._events.append(event)
            return True

    def poll(self, max_items: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if max_items is None or max_items >= len(self._events):
                out, self._events = self._events, []
            else:
                take = max(0, int(max_items))
                out = self._events[:take]
                del self._events[:take]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Monitor:
    """Tap registry; ``publish`` is wait-free for the dispatcher."""

    def __init__(self, default_maxlen: int = 1024):
        self.default_maxlen = max(1, int(default_maxlen))
        self._taps: List[MonitorTap] = []  # copy-on-write
        self._lock = threading.Lock()
        self.published = 0
        self.dropped_total = 0

    def active(self) -> int:
        return len(self._taps)

    def subscribe(self, maxlen: Optional[int] = None) -> MonitorTap:
        tap = MonitorTap(maxlen if maxlen is not None else self.default_maxlen)
        with self._lock:
            self._taps = self._taps + [tap]
        return tap

    def unsubscribe(self, tap: MonitorTap) -> None:
        with self._lock:
            tap.closed = True
            self.dropped_total += tap.dropped
            self._taps = [t for t in self._taps if t is not tap]

    def publish(self, event: Dict[str, Any]) -> None:
        taps = self._taps
        if not taps:
            return
        self.published += 1
        for tap in taps:
            tap.offer(event)

    def dropped(self) -> int:
        return self.dropped_total + sum(t.dropped for t in self._taps)

    def snapshot(self) -> Dict[str, Any]:
        taps = self._taps
        return {
            "subscribers": len(taps),
            "published": self.published,
            "dropped": self.dropped(),
            "queue_depths": [len(t) for t in taps],
        }


def format_event(event: Dict[str, Any]) -> str:
    """Render an event roughly like a redis MONITOR line:
    ``<ts> [<tenant>] "<KIND>" "<target>" <nkeys>``.
    """
    ts = event.get("ts", 0.0)
    tenant = event.get("tenant", "") or "-"
    kind = str(event.get("kind", "?")).upper()
    target = event.get("target", "")
    nkeys = event.get("nkeys", 0)
    tag = event.get("event", "op")
    return '%.6f [%s] "%s" "%s" %d (%s)' % (ts, tenant, kind, target, nkeys, tag)
