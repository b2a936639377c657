"""Runtime lock-order witness (a copy of `redisson_tpu.concurrency`).

Threaded modules of the port construct their locks through the factories
here instead of calling `threading.Lock()` directly:

    self._lock = make_lock("executor.CommandExecutor._lock")
    self._cv = make_condition("executor.CommandExecutor._lock", self._lock)

With `REDISSON_TPU_LOCK_WITNESS` unset the factories return the plain
`threading` primitives — zero wrappers, zero per-acquire cost, nothing in
the hot path. The flag is read once, when this module is imported (JAX's
copy reads the environment at every factory call, which would cost the
executor's per-run lock an environment lookup): set it before the process
starts, as the subprocess harvest path does; `_ARMED` holds it. With `REDISSON_TPU_LOCK_WITNESS=1` they return `OrderedLock`
wrappers that record, per thread, the stack of held lock *sites* and merge
every nested acquisition into a global witnessed order graph
(held-site -> acquired-site). `assert_acyclic()` fails on any cycle — a
witnessed lock-order inversion is a potential deadlock even if the run
happened not to interleave into one. Hold durations are recorded per site
(count/total/max + a bounded deterministic sample for p99).
`REDISSON_TPU_LOCK_WITNESS_OUT=f.json` dumps the snapshot at exit, and
`merge_snapshots` joins the dumps of several processes into one graph.

Site names follow the JAX package's static analyzer's node naming
(`<module-stem>.<Class>.<attr>`), so the two packages' witnessed graphs
compare site for site.

Only stdlib imports: every threaded module of the port imports this one
(most through `executor`, which re-exports the factories), so it must sit
at the bottom of the import graph.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "REDISSON_TPU_LOCK_WITNESS"
ENV_OUT = "REDISSON_TPU_LOCK_WITNESS_OUT"

# Bounded deterministic hold-time sampling: keep the first _SAMPLE_CAP
# holds per site, then every _SAMPLE_STRIDE-th. No RNG — runs reproduce.
_SAMPLE_CAP = 2048
_SAMPLE_STRIDE = 32


#: REDISSON_TPU_LOCK_WITNESS as the process started with it
_ARMED = os.environ.get(ENV_FLAG, "") == "1"


def witness_enabled() -> bool:
    """True when the lock-order witness is armed for this process."""
    return _ARMED


# -- global witness state ----------------------------------------------------
# Structure (which keys EXIST in _EDGES/_SAME_SITE/_SITE_STATS/_THREADS) is
# guarded by _STATE_LOCK — a PLAIN threading.Lock, never an OrderedLock
# (the witness must not witness itself). Leaf lock: nothing is acquired
# under it. Counter VALUES are bumped without the lock once the key exists:
# a GIL-interleaved `d[k] += 1` can drop an increment, which only skews
# diagnostics counts — the acyclicity gate and the static cross-check read
# edge existence, which stays exact. This keeps the per-acquire cost off
# the product's hot locks.
_STATE_LOCK = threading.Lock()
_EDGES: Dict[Tuple[str, str], int] = {}  # (held_site, acquired_site) -> count
_EDGE_THREADS: Dict[Tuple[str, str], str] = {}  # first witnessing thread
_SAME_SITE: Dict[str, int] = {}  # site -> nested same-site (distinct instance)
_SITE_STATS: Dict[str, "_SiteStat"] = {}
_THREADS: set = set()
_DUMP_ARMED = False
_EPOCH = 0  # bumped by witness_reset(); invalidates per-thread/-lock caches

_TLS = threading.local()  # .stack/.seen_edges/.epoch for this thread


class _SiteStat:
    """Per-site hold accounting. `count` covers every acquisition; the
    timing fields (total_s/max_s/samples) cover the deterministic sample —
    all of the first _SAMPLE_CAP holds, then every _SAMPLE_STRIDE-th —
    because unsampled holds skip the clock entirely to keep the witness
    cheap."""

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
            # Rotate deterministically: overwrite the slot the count
            # selects, so late-run behaviour still shows up in p99.
            self.samples[self.count % _SAMPLE_CAP] = dt
        else:
            self.samples.append(dt)

    def p99(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(len(s) * 0.99))]


# A held-stack entry is a plain 3-slot list [lock, t0, depth] — cheaper to
# allocate than an object on the per-acquire hot path. t0 == 0.0 marks an
# unsampled hold (no clock read on either side).
_L_LOCK, _L_T0, _L_DEPTH = 0, 1, 2


def _stack() -> list:
    try:
        if _TLS.epoch == _EPOCH:
            return _TLS.stack
        st = _TLS.stack
    except AttributeError:
        st = _TLS.stack = []
    # First touch from this thread (or first after a reset): register
    # the thread name and start a fresh first-witness edge cache. The
    # held stack itself survives a reset — locks may still be held.
    _TLS.seen_edges = set()
    _TLS.epoch = _EPOCH
    with _STATE_LOCK:
        _THREADS.add(threading.current_thread().name)
    return st


def _arm_dump() -> None:
    """Register the atexit JSON dump once per process (subprocess harvest
    path for the --race-smoke gate)."""
    global _DUMP_ARMED
    out = os.environ.get(ENV_OUT, "")
    if not out or _DUMP_ARMED:
        return
    _DUMP_ARMED = True
    atexit.register(dump_witness, out)


class OrderedLock:
    """A witnessing Lock/RLock: records lock-site acquisition order and
    hold times. Duck-types enough of the threading lock protocol that
    `threading.Condition` can wrap it (`acquire`/`release`/`_is_owned`/
    `_release_save`/`_acquire_restore`)."""

    def __init__(self, site: str, reentrant: bool = False):
        self.site = site
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._stat: Optional[_SiteStat] = None  # per-instance cache
        self._stat_epoch = -1
        _arm_dump()

    # -- lock protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _stack()
        if self._reentrant:
            for held in st:
                if held[_L_LOCK] is self:  # reentrant re-acquire: no edge
                    self._inner.acquire(blocking, timeout)
                    held[_L_DEPTH] += 1
                    return True
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return False
        self._push_held(st)
        return True

    def _push_held(self, st: list) -> None:
        if st:
            self._record_edges(st)
        stat = self._stat
        if stat is None or self._stat_epoch != _EPOCH:
            stat = self._site_stat()
        stat.count += 1
        # Sampling decided here so unsampled holds never touch the clock.
        if stat.count <= _SAMPLE_CAP or stat.count % _SAMPLE_STRIDE == 0:
            st.append([self, time.monotonic(), 1])
        else:
            st.append([self, 0.0, 1])

    def _record_edges(self, st: list) -> None:
        seen = _TLS.seen_edges
        site = self.site
        for held in st:
            hsite = held[_L_LOCK].site
            if hsite == site:
                # Distinct instances of the same site (e.g. two per-run
                # tokens) nest without implying an order cycle; counted
                # separately so it stays visible.
                if site in _SAME_SITE:
                    _SAME_SITE[site] += 1
                else:
                    with _STATE_LOCK:
                        _SAME_SITE[site] = _SAME_SITE.get(site, 0) + 1
                continue
            key = (hsite, site)
            if key in seen:
                _EDGES[key] += 1  # approximate count, exact existence
            else:
                with _STATE_LOCK:
                    _EDGES[key] = _EDGES.get(key, 0) + 1
                    _EDGE_THREADS.setdefault(
                        key, threading.current_thread().name)
                seen.add(key)

    def _site_stat(self) -> _SiteStat:
        with _STATE_LOCK:
            stat = _SITE_STATS.get(self.site)
            if stat is None:
                stat = _SITE_STATS[self.site] = _SiteStat()
        self._stat = stat
        self._stat_epoch = _EPOCH
        return stat

    def release(self) -> None:
        st = getattr(_TLS, "stack", None)
        if st:
            held = st[-1]
            if held[_L_LOCK] is self:  # LIFO fast path
                if held[_L_DEPTH] > 1:
                    held[_L_DEPTH] -= 1
                else:
                    del st[-1]
                    t0 = held[_L_T0]
                    if t0:
                        self._stat.record(time.monotonic() - t0)
                self._inner.release()
                return
            for i in range(len(st) - 2, -1, -1):
                held = st[i]
                if held[_L_LOCK] is not self:
                    continue
                if held[_L_DEPTH] > 1:
                    held[_L_DEPTH] -= 1
                else:
                    del st[i]
                    t0 = held[_L_T0]
                    if t0:
                        self._stat.record(time.monotonic() - t0)
                self._inner.release()
                return
        # Released by a thread that never recorded the acquire (shouldn't
        # happen; be faithful to the underlying primitive's error).
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked is not None else False

    # -- Condition integration ---------------------------------------------

    def _is_owned(self) -> bool:
        return any(h[_L_LOCK] is self for h in _stack())

    def _release_save(self):
        """Condition.wait: fully release (all recursion levels for an
        RLock), returning what _acquire_restore needs."""
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            held = st[i]
            if held[_L_LOCK] is not self:
                continue
            depth = held[_L_DEPTH]
            del st[i]
            t0 = held[_L_T0]
            if t0:
                self._site_stat().record(time.monotonic() - t0)
            for _ in range(depth):
                self._inner.release()
            return depth
        raise RuntimeError("cannot wait on un-acquired lock")

    def _acquire_restore(self, depth) -> None:
        st = _stack()
        for _ in range(int(depth)):
            self._inner.acquire()
        self._push_held(st)
        if depth > 1:
            st[-1][_L_DEPTH] = int(depth)


# -- factories ---------------------------------------------------------------


def make_lock(site: str):
    """`threading.Lock()` normally; an OrderedLock witness under
    REDISSON_TPU_LOCK_WITNESS=1. `site` must be the static analyzer's
    node name: `<module-stem>.<Class>.<attr>`."""
    if _ARMED:
        return OrderedLock(site)
    return threading.Lock()


def make_rlock(site: str):
    """Reentrant variant of make_lock."""
    if _ARMED:
        return OrderedLock(site, reentrant=True)
    return threading.RLock()


def make_condition(site: str, lock=None):
    """`threading.Condition` over a witnessed lock. Pass the OrderedLock
    returned by make_lock to alias the condition with an existing guard
    (the executor's `_cv = make_condition(site, self._lock)` shape); with
    `lock=None` a fresh witnessed non-reentrant lock is created."""
    if not _ARMED:
        return threading.Condition(lock)
    if lock is None:
        lock = OrderedLock(site)
    return threading.Condition(lock)


# -- introspection / the --race-smoke surface --------------------------------


def witness_snapshot() -> dict:
    """The witnessed order graph + per-site hold stats, JSON-shaped.
    `holds` counts every acquisition; `total_s`/`max_s`/`p99_s` cover the
    deterministic sample (see _SiteStat)."""
    with _STATE_LOCK:
        edges = [
            {"from": a, "to": b, "count": n,
             "first_thread": _EDGE_THREADS.get((a, b), "")}
            for (a, b), n in sorted(_EDGES.items())
        ]
        sites = {
            site: {
                "holds": st.count,
                "total_s": st.total_s,
                "max_s": st.max_s,
                "p99_s": st.p99(),
            }
            for site, st in sorted(_SITE_STATS.items())
        }
        return {
            "enabled": witness_enabled(),
            "edges": edges,
            "sites": sites,
            "same_site_nesting": dict(sorted(_SAME_SITE.items())),
            "threads": sorted(_THREADS),
        }


def find_cycle(edges) -> Optional[List[str]]:
    """DFS cycle search over [(a, b), ...]; returns the node cycle (first
    node repeated at the end) or None."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    path: List[str] = []

    def visit(n: str) -> Optional[List[str]]:
        color[n] = GREY
        path.append(n)
        for m in adj.get(n, ()):
            c = color.get(m, WHITE)
            if c == GREY:
                return path[path.index(m):] + [m]
            if c == WHITE:
                cyc = visit(m)
                if cyc is not None:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(adj):
        if color.get(n, WHITE) == WHITE:
            cyc = visit(n)
            if cyc is not None:
                return cyc
    return None


def assert_acyclic() -> None:
    """Fail the suite if the witnessed order graph has a cycle — two
    threads were SEEN taking the same locks in opposite orders."""
    with _STATE_LOCK:
        keys = list(_EDGES)
    cyc = find_cycle(keys)
    if cyc is not None:
        raise AssertionError(
            "witnessed lock-order cycle: " + " -> ".join(cyc))


def witness_reset() -> None:
    """Drop all witnessed state (test isolation). Bumps the cache epoch so
    per-thread first-witness sets and per-lock stat handles from before the
    reset are discarded instead of resurrecting stale objects."""
    global _EPOCH
    with _STATE_LOCK:
        _EPOCH += 1
        _EDGES.clear()
        _EDGE_THREADS.clear()
        _SAME_SITE.clear()
        _SITE_STATS.clear()
        _THREADS.clear()


def dump_witness(path: Optional[str] = None) -> None:
    """Write the witness snapshot as JSON (atexit hook when
    REDISSON_TPU_LOCK_WITNESS_OUT names a file — the subprocess harvest
    path)."""
    path = path or os.environ.get(ENV_OUT, "")
    if not path:
        return
    try:
        with open(path, "w") as fh:
            json.dump(witness_snapshot(), fh, indent=1, sort_keys=True)
    except OSError:
        pass


def merge_snapshots(snaps) -> dict:
    """Merge per-process witness snapshots (each a witness_snapshot()
    dict) into one graph for the acyclicity check."""
    edges: Dict[Tuple[str, str], dict] = {}
    sites: Dict[str, dict] = {}
    threads: set = set()
    same: Dict[str, int] = {}
    for snap in snaps:
        for e in snap.get("edges", ()):
            key = (e["from"], e["to"])
            cur = edges.get(key)
            if cur is None:
                edges[key] = dict(e)
            else:
                cur["count"] += e["count"]
        for site, st in snap.get("sites", {}).items():
            cur = sites.get(site)
            if cur is None:
                sites[site] = dict(st)
            else:
                cur["holds"] += st["holds"]
                cur["total_s"] += st["total_s"]
                cur["max_s"] = max(cur["max_s"], st["max_s"])
                cur["p99_s"] = max(cur["p99_s"], st["p99_s"])
        threads.update(snap.get("threads", ()))
        for site, n in snap.get("same_site_nesting", {}).items():
            same[site] = same.get(site, 0) + n
    return {
        "edges": [edges[k] for k in sorted(edges)],
        "sites": {k: sites[k] for k in sorted(sites)},
        "same_site_nesting": dict(sorted(same.items())),
        "threads": sorted(threads),
    }
