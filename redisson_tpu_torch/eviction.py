"""EvictionScheduler — client-driven expiry sweeper for RMapCache/RSetCache.

Reference: `EvictionScheduler.java:47-115` — per-object periodic task
deleting <=300 expired entries per run, with adaptive delay: starts at 1 s
bounds [1 s, 2 h]; sizing ×1.5 after consecutive empty runs, ÷4 when a run
hits the batch limit. Same policy here; the sweep is the engine's
`mc_evict_expired` op.
"""

from __future__ import annotations

import threading
from typing import Dict

MIN_DELAY_S = 1.0
MAX_DELAY_S = 2 * 60 * 60.0
BATCH_LIMIT = 300


class EvictionScheduler:
    def __init__(self, executor=None):
        self._executor = executor
        self._delays: Dict[str, float] = {}
        self._empty_runs: Dict[str, int] = {}
        self._timers: Dict[str, threading.Timer] = {}
        self._sweeps: Dict[str, object] = {}  # name -> callable(limit)->int
        self._lock = threading.Lock()
        self._shutdown = False

    def schedule(self, name: str, sweep=None) -> None:
        """Register an object for adaptive sweeping. Default sweep is the
        engine's `mc_evict_expired` op; redis-mode caches pass their own
        sweep callable (the batched Lua, RedisMapCache.evict_expired)."""
        with self._lock:
            if self._shutdown or name in self._timers:
                return
            if sweep is not None:
                self._sweeps[name] = sweep
            self._delays[name] = MIN_DELAY_S
            self._empty_runs[name] = 0
            self._arm(name)

    def _arm(self, name: str) -> None:
        t = threading.Timer(self._delays[name], self._run, args=(name,))
        t.daemon = True
        self._timers[name] = t
        t.start()

    def _run(self, name: str) -> None:
        sweep = self._sweeps.get(name)
        try:
            if sweep is not None:
                removed = sweep(BATCH_LIMIT)
            else:
                removed = self._executor.execute_sync(
                    name, "mc_evict_expired", {"limit": BATCH_LIMIT}
                )
        except Exception:
            removed = 0
        with self._lock:
            if self._shutdown or name not in self._timers:
                return
            delay = self._delays[name]
            if removed >= BATCH_LIMIT:
                delay = max(MIN_DELAY_S, delay / 4)  # falling behind: speed up
                self._empty_runs[name] = 0
            elif removed == 0:
                self._empty_runs[name] += 1
                if self._empty_runs[name] >= 2:
                    delay = min(MAX_DELAY_S, delay * 1.5)  # idle: back off
            else:
                self._empty_runs[name] = 0
            self._delays[name] = delay
            self._arm(name)

    def unschedule(self, name: str) -> None:
        with self._lock:
            t = self._timers.pop(name, None)
            if t is not None:
                t.cancel()
            self._delays.pop(name, None)
            self._empty_runs.pop(name, None)
            self._sweeps.pop(name, None)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()
