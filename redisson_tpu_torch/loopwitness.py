"""Runtime event-loop stall witness (counterpart of
`redisson_tpu.loopwitness`, the same environment switches).

It measures what actually holds an asyncio loop (the RESP front-end's) on
the interleavings a run exercises. Armed via::

    REDISSON_TPU_LOOP_WITNESS=1          # arm for this process
    REDISSON_TPU_LOOP_WITNESS_OUT=f.json # dump a snapshot at exit
    REDISSON_TPU_LOOP_WITNESS_STALL_MS=N # stall threshold (default 20)

it wraps ``asyncio.events.Handle._run`` — the single funnel every loop
callback (plain ``call_soon`` callbacks AND coroutine task steps) passes
through — and records, per call site:

  * per-callback **hold time** with the same deterministic sampling as
    the JAX package's lock witness (first ``_SAMPLE_CAP`` holds, then every
    ``_SAMPLE_STRIDE``-th — no RNG, runs reproduce);
  * **stalls**: callbacks holding the loop longer than the threshold,
    attributed to the running coroutine (qualname + resume line) or
    callback (qualname + file) — "who blocked the loop" names actual
    code, not "the loop was slow";
  * loop **lag** via a heartbeat coroutine: schedule a sleep, measure
    the overshoot — the user-visible symptom of every stall combined.

``wire.loop_lag_p99_us`` / ``wire.loop_stalls`` observability gauges read
`loop_gauges()`; `loop_witness_snapshot()` is the whole record.

The patch is installed on the first `watch_loop()` and is a no-op for
unregistered loops (one dict probe); `uninstall()` restores the original
``Handle._run`` for test isolation.
"""

from __future__ import annotations

import asyncio
import atexit
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

ENV_FLAG = "REDISSON_TPU_LOOP_WITNESS"
ENV_OUT = "REDISSON_TPU_LOOP_WITNESS_OUT"
ENV_STALL_MS = "REDISSON_TPU_LOOP_WITNESS_STALL_MS"

_DEFAULT_STALL_MS = 20.0
_HEARTBEAT_S = 0.005
_STALL_CAP = 256  # bounded attribution log per loop

# Deterministic sampling, the JAX package's lock-witness policy: all of the
# first _SAMPLE_CAP holds per site, then every _SAMPLE_STRIDE-th.
_SAMPLE_CAP = 2048
_SAMPLE_STRIDE = 32


def loop_witness_enabled() -> bool:
    """True when the loop-stall witness is armed for this process."""
    return os.environ.get(ENV_FLAG, "") == "1"


def _stall_threshold_s() -> float:
    try:
        return float(os.environ.get(ENV_STALL_MS, "")) / 1000.0
    except ValueError:
        return _DEFAULT_STALL_MS / 1000.0


class _SiteStat:
    """Per-callsite hold accounting (count every run; time the sample)."""

    __slots__ = ("count", "total_s", "max_s", "samples")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.samples: List[float] = []

    def record(self, dt: float) -> None:
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt
        if len(self.samples) >= _SAMPLE_CAP:
            self.samples[self.count % _SAMPLE_CAP] = dt
        else:
            self.samples.append(dt)

    def p99(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(len(s) * 0.99))]


class _LoopStats:
    """Witness state for one watched loop. Written by the loop thread
    (record paths); snapshot readers take racy reads of monotonic
    counters."""

    def __init__(self, name: str):
        self.name = name
        self.sites: Dict[str, _SiteStat] = {}
        self.lag = _SiteStat()
        self.stalls: List[dict] = []
        self.stall_threshold_s = _stall_threshold_s()
        self.heartbeat = None  # concurrent.futures.Future of the task

    def record(self, site: str, dt: float) -> None:
        st = self.sites.get(site)
        if st is None:
            st = self.sites[site] = _SiteStat()
        st.count += 1
        if st.count <= _SAMPLE_CAP or st.count % _SAMPLE_STRIDE == 0 \
                or dt > self.stall_threshold_s:
            st.record(dt)
        if dt > self.stall_threshold_s and len(self.stalls) < _STALL_CAP:
            self.stalls.append({"site": site,
                                "ms": round(dt * 1000.0, 3)})

    def to_dict(self) -> dict:
        return {
            "callbacks": {
                site: {
                    "runs": st.count,
                    "total_s": round(st.total_s, 6),
                    "max_s": round(st.max_s, 6),
                    "p99_s": round(st.p99(), 6),
                }
                for site, st in sorted(self.sites.items())
            },
            "lag": {
                "beats": self.lag.count,
                "max_s": round(self.lag.max_s, 6),
                "p99_s": round(self.lag.p99(), 6),
            },
            "stalls": list(self.stalls),
            "stall_threshold_ms": round(self.stall_threshold_s * 1000.0, 3),
        }


# Registry structure is guarded by _STATE_LOCK (plain Lock — the witness
# must not witness itself); per-loop stat VALUES are single-writer (the
# loop thread) with racy cross-thread snapshot reads.
_STATE_LOCK = threading.Lock()
_LOOPS: Dict[int, _LoopStats] = {}
_RETIRED: List[_LoopStats] = []
_ORIG_RUN = None  # asyncio.events.Handle._run before patching
_DUMP_ARMED = False


def _site_of(handle) -> str:
    """Attribute a Handle to code: a task step names the running
    coroutine (qualname + resume line — the line the coroutine will
    resume at, i.e. where a stall happens); a plain callback names the
    function object."""
    cb = getattr(handle, "_callback", None)
    owner = getattr(cb, "__self__", None)
    if owner is not None and hasattr(owner, "get_coro"):
        try:
            coro = owner.get_coro()
            code = getattr(coro, "cr_code", None)
            if code is not None:
                qual = getattr(code, "co_qualname", None) or code.co_name
                frame = getattr(coro, "cr_frame", None)
                line = frame.f_lineno if frame is not None \
                    else code.co_firstlineno
                return (f"task:{qual} "
                        f"({os.path.basename(code.co_filename)}:{line})")
        except Exception:  # noqa: BLE001 — attribution is best-effort
            pass
    if isinstance(cb, functools.partial):
        cb = cb.func
    qual = getattr(cb, "__qualname__", None) or repr(cb)
    code = getattr(cb, "__code__", None)
    if code is not None:
        return f"cb:{qual} ({os.path.basename(code.co_filename)})"
    return f"cb:{qual}"


def _witness_run(handle):
    loop = getattr(handle, "_loop", None)
    st = _LOOPS.get(id(loop)) if loop is not None else None
    if st is None:
        return _ORIG_RUN(handle)
    t0 = time.monotonic()
    try:
        return _ORIG_RUN(handle)
    finally:
        st.record(_site_of(handle), time.monotonic() - t0)


def _install() -> None:
    global _ORIG_RUN
    if _ORIG_RUN is not None:
        return
    _ORIG_RUN = asyncio.events.Handle._run
    asyncio.events.Handle._run = _witness_run


def uninstall() -> None:
    """Restore the original Handle._run and forget all watched loops
    (test isolation; cancels heartbeats best-effort)."""
    global _ORIG_RUN
    with _STATE_LOCK:
        stats = list(_LOOPS.values())
        _LOOPS.clear()
        if _ORIG_RUN is not None:
            asyncio.events.Handle._run = _ORIG_RUN
            _ORIG_RUN = None
    for st in stats:
        if st.heartbeat is not None:
            st.heartbeat.cancel()


async def _heartbeat(stats: _LoopStats) -> None:
    """Measure scheduling lag: sleep a fixed interval, record the
    overshoot. Every callback that holds the loop shows up here as the
    user-visible symptom; the per-site stats say who caused it."""
    while True:
        t0 = time.monotonic()
        await asyncio.sleep(_HEARTBEAT_S)
        lag = time.monotonic() - t0 - _HEARTBEAT_S
        stats.lag.count += 1
        stats.lag.record(max(lag, 0.0))


def watch_loop(loop, name: str, force: bool = False) -> bool:
    """Register `loop` with the witness (no-op unless armed or `force`).
    Called from any thread once the loop is running; returns True when
    the loop is (now) watched."""
    if not (force or loop_witness_enabled()):
        return False
    with _STATE_LOCK:
        _install()
        if id(loop) in _LOOPS:
            return True
        st = _LOOPS[id(loop)] = _LoopStats(name)
    try:
        st.heartbeat = asyncio.run_coroutine_threadsafe(
            _heartbeat(st), loop)
    except RuntimeError:  # loop already closing — hold stats anyway
        st.heartbeat = None
    _arm_dump()
    return True


def unwatch_loop(loop) -> None:
    """Stop watching `loop`; its stats stay visible to snapshots (the
    loop is usually gone by dump time)."""
    with _STATE_LOCK:
        st = _LOOPS.pop(id(loop), None)
        if st is not None:
            _RETIRED.append(st)
    if st is not None and st.heartbeat is not None:
        st.heartbeat.cancel()
        st.heartbeat = None


def loop_witness_snapshot() -> dict:
    """All watched (live + retired) loops' stats, JSON-shaped."""
    with _STATE_LOCK:
        stats = list(_LOOPS.values()) + list(_RETIRED)
    loops: Dict[str, dict] = {}
    for st in stats:
        key = st.name
        n = 2
        while key in loops:  # distinct loops may share a name
            key = f"{st.name}#{n}"
            n += 1
        loops[key] = st.to_dict()
    return {"version": 1, "loops": loops}


def loop_gauges(loop) -> dict:
    """Observability feed: {'loop_lag_p99_us', 'loop_stalls'} for one
    loop — zeros when the loop is not watched, so gauge wiring never
    branches on witness state."""
    st = _LOOPS.get(id(loop)) if loop is not None else None
    if st is None:
        return {"loop_lag_p99_us": 0, "loop_stalls": 0}
    return {"loop_lag_p99_us": int(st.lag.p99() * 1e6),
            "loop_stalls": len(st.stalls)}


def loop_witness_reset() -> None:
    """Drop all witnessed state (test isolation). Watched loops stay
    watched; their counters restart from zero."""
    with _STATE_LOCK:
        _RETIRED.clear()
        for st in _LOOPS.values():
            st.sites = {}
            st.lag = _SiteStat()
            st.stalls = []


def dump_loop_witness(path: Optional[str] = None) -> None:
    """Write the snapshot as JSON (atexit hook when
    REDISSON_TPU_LOOP_WITNESS_OUT names a file — the harvest path of a
    subprocess)."""
    path = path or os.environ.get(ENV_OUT, "")
    if not path:
        return
    try:
        with open(path, "w") as fh:
            json.dump(loop_witness_snapshot(), fh, indent=1, sort_keys=True)
    except OSError:
        pass


def _arm_dump() -> None:
    global _DUMP_ARMED
    out = os.environ.get(ENV_OUT, "")
    if not out or _DUMP_ARMED:
        return
    _DUMP_ARMED = True
    atexit.register(dump_loop_witness, out)
