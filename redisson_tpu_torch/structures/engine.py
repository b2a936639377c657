"""The in-memory data-structure engine (the "embedded server"; a copy of
`redisson_tpu.structures.engine`).

Op interpreter over a typed keyspace, executed entirely on the executor's
dispatcher thread: every op is atomic with respect to every other, the same
guarantee the reference gets from Redis' single-threaded command loop. Ops
that the reference implements as Lua scripts (lock CAS `RedissonLock.java:
236-252`, map-cache TTL puts `RedissonMapCache.java:75-87`, semaphore
counters `RedissonSemaphore.java`) are single handler calls here.

Values are opaque bytes (the model layer applies codecs); equality is
byte-equality exactly as Redis compares serialized values. Scores are
floats. Expiry is lazy on access plus an EvictionScheduler sweep (see
redisson_tpu_torch.eviction).

Blocking ops (BLPOP-family, `RedisCommands` blocking pops routed through the
reference's no-timeout L2 path `CommandAsyncService.java:491-497`) never
block the dispatcher: the handler either completes immediately or parks the
op's future in a per-key waiter queue; a later push fulfills the earliest
waiter in the same dispatch that performed the push. Client-side timeout
cancellation is itself an op, so the cancel/fulfill race is serialized away.
"""

from __future__ import annotations

import fnmatch
import io
import itertools
import pickle
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.store import WrongTypeError
from redisson_tpu_torch.structures.extended import ExtendedOps


def now_ms() -> int:
    return int(time.time() * 1000)


# SRANDMEMBER randomness (os-entropy seeded; r2 used a now_ms()-derived
# window, so two calls in the same millisecond returned identical members).
_rand = random.Random()


class _DumpUnpickler(pickle.Unpickler):
    """Reads a keyspace dump of either package: the JAX package pickles its
    `redisson_tpu.structures.engine.KV` records, which map onto this
    module's field-for-field copy, so loading such a dump never imports
    the JAX package."""

    def find_class(self, module, name):
        if module == "redisson_tpu" or module.startswith("redisson_tpu."):
            module = "redisson_tpu_torch" + module[len("redisson_tpu"):]
        return super().find_class(module, name)


def _load_dump(blob: bytes):
    return _DumpUnpickler(io.BytesIO(blob)).load()


class T:
    """Value types of the keyspace."""

    STRING = "string"
    HASH = "hash"
    SET = "set"
    ZSET = "zset"
    LIST = "list"
    MAPCACHE = "mapcache"
    SETCACHE = "setcache"
    MULTIMAP_SET = "multimap_set"
    MULTIMAP_LIST = "multimap_list"
    GEO = "geo"
    LOCK = "lock"
    RWLOCK = "rwlock"
    SEMAPHORE = "semaphore"
    LATCH = "latch"


@dataclass
class KV:
    otype: str
    value: Any
    expire_at: Optional[int] = None  # epoch ms
    # SCAN support: member -> monotonic stamp, assigned on first sight by a
    # scan, dropped on deletion, never renumbered (see Engine._scan_page).
    scan_seq: Optional[Dict[Any, int]] = None
    scan_next: int = 1
    # Multimap-cache per-key expiry (key -> deadline ms): the engine-side
    # analogue of the reference's timeout zset (RedissonMultimapCache.java).
    mm_expiry: Optional[Dict[Any, int]] = None


@dataclass
class Waiter:
    """A parked blocking pop (id, future, and how to fulfill it)."""

    wid: int
    op: Op
    side: str  # 'left' | 'right'
    dest: Optional[str] = None  # pollLastAndOfferFirstTo target


class PubSubHub:
    """In-process pub/sub: channel + pattern listeners, async delivery.

    Reference: the L0/L1 pub/sub registry (`RedisPubSubConnection`,
    `MasterSlaveConnectionManager.java:306-479`). Listener callbacks run on a
    dedicated delivery thread, never on the dispatcher (the reference
    likewise dispatches on netty event-loop threads, not the caller's).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._channels: Dict[str, Dict[int, Callable]] = {}
        self._patterns: Dict[str, Dict[int, Callable]] = {}
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._deliver_loop, name="redisson-torch-pubsub", daemon=True
        )
        self._thread.start()

    def subscribe(self, channel: str, listener: Callable[[str, Any], None]) -> int:
        with self._lock:
            lid = next(self._ids)
            self._channels.setdefault(channel, {})[lid] = listener
            return lid

    def psubscribe(self, pattern: str, listener: Callable[[str, str, Any], None]) -> int:
        with self._lock:
            lid = next(self._ids)
            self._patterns.setdefault(pattern, {})[lid] = listener
            return lid

    def unsubscribe(self, channel: str, lid: Optional[int] = None) -> None:
        with self._lock:
            subs = self._channels.get(channel)
            if subs is None:
                return
            if lid is None:
                subs.clear()
            else:
                subs.pop(lid, None)
            if not subs:
                del self._channels[channel]

    def punsubscribe(self, pattern: str, lid: Optional[int] = None) -> None:
        with self._lock:
            subs = self._patterns.get(pattern)
            if subs is None:
                return
            if lid is None:
                subs.clear()
            else:
                subs.pop(lid, None)
            if not subs:
                del self._patterns[pattern]

    def publish(self, channel: str, message: Any) -> int:
        """Queue delivery; returns receiver count (PUBLISH reply)."""
        targets: List[Tuple[Callable, tuple]] = []
        with self._lock:
            for fn in list(self._channels.get(channel, {}).values()):
                targets.append((fn, (channel, message)))
            for pattern, subs in self._patterns.items():
                if fnmatch.fnmatchcase(channel, pattern):
                    for fn in list(subs.values()):
                        targets.append((fn, (pattern, channel, message)))
        if targets:
            with self._cv:
                self._queue.extend(targets)
                self._cv.notify()
        return len(targets)

    def _deliver_loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._queue:
                    return
                fn, args = self._queue.popleft()
            try:
                fn(*args)
            except Exception:
                pass  # listener errors never poison delivery (netty parity)

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


class StructureBackend(ExtendedOps):
    """Op interpreter over the typed keyspace. Runs on the dispatcher thread."""

    def __init__(self, pubsub: Optional[PubSubHub] = None):
        self._data: Dict[str, KV] = {}
        self.pubsub = pubsub or PubSubHub()
        self._waiters: Dict[str, deque] = {}  # key -> Waiter FIFO
        self._waiter_ids = itertools.count(1)
        self._lock = threading.Lock()  # guards reads from non-dispatcher threads
        self._scripts: Dict[str, Callable] = {}  # sha -> fn (SCRIPT cache)

    # -- dispatch (same contract as TpuBackend.run) --------------------------

    def run(self, kind: str, target: str, ops: List[Op]) -> None:
        handler = getattr(self, "_op_" + kind, None)
        if handler is None:
            raise ValueError(f"unknown op kind: {kind}")
        for op in ops:
            try:
                handler(target, op)
            except Exception as exc:
                if not op.future.done():
                    op.future.set_exception(exc)

    def handles(self, kind: str) -> bool:
        return hasattr(self, "_op_" + kind)

    # -- keyspace helpers ----------------------------------------------------

    def _entry(self, key: str, otype: Optional[str] = None) -> Optional[KV]:
        kv = self._data.get(key)
        if kv is None:
            return None
        if kv.expire_at is not None and kv.expire_at <= now_ms():
            with self._lock:
                del self._data[key]
            return None
        if otype is not None and kv.otype != otype:
            raise WrongTypeError(f"key '{key}' holds {kv.otype}, operation needs {otype}")
        return kv

    def _create(self, key: str, otype: str, factory: Callable[[], Any]) -> KV:
        kv = self._entry(key, otype)
        if kv is None:
            kv = KV(otype, factory())
            with self._lock:
                self._data[key] = kv
        return kv

    def _drop(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def _drop_if_empty(self, key: str, kv: KV) -> None:
        if not kv.value:
            self._drop(key)

    # generic store surface (mirrors SketchStore for the RoutingBackend)

    def exists(self, name: str) -> bool:
        return self._entry(name) is not None

    def delete(self, name: str) -> bool:
        return self._drop(name)

    def keys(self, pattern: Optional[str] = None) -> List[str]:
        with self._lock:
            items = list(self._data.items())
        t = now_ms()
        live = [k for k, kv in items if kv.expire_at is None or kv.expire_at > t]
        if pattern is None or pattern == "*":
            return live
        return [k for k in live if fnmatch.fnmatchcase(k, pattern)]

    def flushall(self) -> None:
        with self._lock:
            self._data.clear()

    # -- persistence (persist/snapshotter.py) --------------------------------

    def dump_state(self) -> bytes:
        """Serialize the whole keyspace (the structure-tier half of a
        snapshot cut). Must run on the dispatcher thread — the single
        mutator — so the pickle is a consistent point-in-time copy.
        Excluded on purpose: parked blocking-pop waiters (transient; their
        futures belong to the crashed process) and the SCRIPT cache
        (callables don't pickle; re-register via script_load after
        recovery, same as a restarted Redis loses its script cache)."""
        with self._lock:
            return pickle.dumps({"format": 1, "data": self._data},
                                protocol=pickle.HIGHEST_PROTOCOL)

    def load_state(self, blob: bytes) -> int:
        """Replace the keyspace with a dump_state() capture. Returns the
        number of keys restored. Dispatcher-thread (or pre-traffic) only."""
        payload = _load_dump(blob)
        if payload.get("format") != 1:
            raise ValueError(f"unsupported structure dump format "
                             f"{payload.get('format')!r}")
        data = payload["data"]
        with self._lock:
            self._data = data
        return len(data)

    def load_keys(self, blob: bytes) -> int:
        """Merge a dump_state() capture into the live keyspace (same-named
        keys are overwritten; everything else is untouched). The slot
        migration bootstrap path: a target shard installs the migrating
        slots' keys without disturbing the keys it already owns. Runs as
        the journaled `migrate_install` op on the dispatcher thread."""
        payload = _load_dump(blob)
        if payload.get("format") != 1:
            raise ValueError(f"unsupported structure dump format "
                             f"{payload.get('format')!r}")
        data = payload["data"]
        with self._lock:
            self._data.update(data)
        return len(data)

    # -- generic / expiry (RedissonExpirable surface) ------------------------

    def _op_delete(self, key: str, op: Op) -> None:
        op.future.set_result(self._drop(key))

    def _op_exists(self, key: str, op: Op) -> None:
        op.future.set_result(self._entry(key) is not None)

    def _op_flushall(self, key: str, op: Op) -> None:
        self.flushall()
        op.future.set_result(None)

    def _op_pexpire(self, key: str, op: Op) -> None:
        kv = self._entry(key)
        if kv is None:
            op.future.set_result(False)
            return
        kv.expire_at = now_ms() + int(op.payload["ms"])
        op.future.set_result(True)

    def _op_pexpireat(self, key: str, op: Op) -> None:
        kv = self._entry(key)
        if kv is None:
            op.future.set_result(False)
            return
        kv.expire_at = int(op.payload["ts_ms"])
        op.future.set_result(True)

    def _op_persist(self, key: str, op: Op) -> None:
        kv = self._entry(key)
        if kv is None or kv.expire_at is None:
            op.future.set_result(False)
            return
        kv.expire_at = None
        op.future.set_result(True)

    def _op_pttl(self, key: str, op: Op) -> None:
        """-2 = no key, -1 = no expiry (PTTL reply contract)."""
        kv = self._entry(key)
        if kv is None:
            op.future.set_result(-2)
        elif kv.expire_at is None:
            op.future.set_result(-1)
        else:
            op.future.set_result(max(0, kv.expire_at - now_ms()))

    # -- scripting (RScript / Lua-EVAL analogue) ------------------------------

    def _op_script_load(self, key: str, op: Op) -> None:
        from redisson_tpu_torch.models.script import script_sha

        fn = op.payload["fn"]
        sha = script_sha(fn)
        self._scripts[sha] = fn
        op.future.set_result(sha)

    def _op_script_exists(self, key: str, op: Op) -> None:
        op.future.set_result([s in self._scripts for s in op.payload["shas"]])

    def _op_script_flush(self, key: str, op: Op) -> None:
        self._scripts.clear()
        op.future.set_result(None)

    def _op_script_eval(self, key: str, op: Op) -> None:
        """Runs the function on the dispatcher thread — atomic against every
        other op, the Lua-inside-Redis guarantee."""
        from redisson_tpu_torch.models.script import ScriptContext, script_sha

        p = op.payload
        fn = p.get("fn")
        if fn is None:
            fn = self._scripts.get(p["sha"])
            if fn is None:
                raise ValueError(f"NOSCRIPT no script with sha {p['sha']}")
        else:
            self._scripts.setdefault(script_sha(fn), fn)
        op.future.set_result(fn(ScriptContext(self), p["keys"], p["args"]))

    def _op_rename(self, key: str, op: Op) -> None:
        """RENAME / RENAMENX (payload nx=True): atomic on the dispatcher."""
        kv = self._entry(key)
        if kv is None:
            raise KeyError(f"no such key '{key}'")
        with self._lock:
            if op.payload.get("nx") and op.payload["newkey"] in self._data:
                op.future.set_result(False)
                return
            del self._data[key]
            self._data[op.payload["newkey"]] = kv
        op.future.set_result(True)

    def _op_type(self, key: str, op: Op) -> None:
        kv = self._entry(key)
        op.future.set_result(None if kv is None else kv.otype)

    # -- string / bucket / atomics ------------------------------------------

    def _op_get(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.STRING)
        op.future.set_result(None if kv is None else kv.value)

    def _op_set(self, key: str, op: Op) -> None:
        kv = self._create(key, T.STRING, lambda: None)
        kv.value = op.payload["value"]
        ttl = op.payload.get("ttl_ms")
        kv.expire_at = None if not ttl else now_ms() + int(ttl)
        op.future.set_result(None)

    def _op_getset(self, key: str, op: Op) -> None:
        # A None value means ABSENT: getAndSet(null) deletes the key
        # (reference contract, RedissonBucketTest.java:33-43 — the bucket
        # must not exist afterwards).
        if op.payload["value"] is None:
            kv = self._entry(key, T.STRING)
            old = None if kv is None else kv.value
            self._drop(key)
            op.future.set_result(old)
            return
        kv = self._create(key, T.STRING, lambda: None)
        old, kv.value = kv.value, op.payload["value"]
        op.future.set_result(old)

    def _op_setnx(self, key: str, op: Op) -> None:
        """trySet (SETNX): only if absent."""
        if self._entry(key) is not None:
            op.future.set_result(False)
            return
        kv = self._create(key, T.STRING, lambda: None)
        kv.value = op.payload["value"]
        ttl = op.payload.get("ttl_ms")
        kv.expire_at = None if not ttl else now_ms() + int(ttl)
        op.future.set_result(True)

    def _op_compare_and_set(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.STRING)
        current = None if kv is None else kv.value
        if current != op.payload["expect"]:
            op.future.set_result(False)
            return
        # compareAndSet(expect, null) deletes on match (None == absent,
        # RedissonBucketTest.java:16-31).
        if op.payload["update"] is None:
            self._drop(key)
            op.future.set_result(True)
            return
        kv = self._create(key, T.STRING, lambda: None)
        kv.value = op.payload["update"]
        op.future.set_result(True)

    def _op_strlen(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.STRING)
        op.future.set_result(0 if kv is None or kv.value is None else len(kv.value))

    def _num(self, kv: Optional[KV], as_float: bool):
        if kv is None or kv.value is None:
            return 0.0 if as_float else 0
        return float(kv.value) if as_float else int(kv.value)

    def _op_incr(self, key: str, op: Op) -> None:
        """INCRBY/INCRBYFLOAT — atomics (RAtomicLong/RAtomicDouble)."""
        as_float = bool(op.payload.get("float"))
        kv = self._create(key, T.STRING, lambda: None)
        val = self._num(kv, as_float) + op.payload["by"]
        kv.value = repr(val).encode() if as_float else str(val).encode()
        op.future.set_result(val)

    def _op_num_get(self, key: str, op: Op) -> None:
        op.future.set_result(self._num(self._entry(key, T.STRING), bool(op.payload.get("float"))))

    def _op_num_cas(self, key: str, op: Op) -> None:
        as_float = bool(op.payload.get("float"))
        kv = self._entry(key, T.STRING)
        if self._num(kv, as_float) != op.payload["expect"]:
            op.future.set_result(False)
            return
        kv = self._create(key, T.STRING, lambda: None)
        v = op.payload["update"]
        kv.value = repr(v).encode() if as_float else str(v).encode()
        op.future.set_result(True)

    def _op_num_getandset(self, key: str, op: Op) -> None:
        as_float = bool(op.payload.get("float"))
        kv = self._create(key, T.STRING, lambda: None)
        old = self._num(kv, as_float)
        v = op.payload["value"]
        kv.value = repr(v).encode() if as_float else str(v).encode()
        op.future.set_result(old)

    def _op_mget(self, key: str, op: Op) -> None:
        out = {}
        for name in op.payload["names"]:
            kv = self._entry(name, T.STRING)
            if kv is not None and kv.value is not None:
                out[name] = kv.value
        op.future.set_result(out)

    def _op_mset(self, key: str, op: Op) -> None:
        for name, value in op.payload["pairs"].items():
            self._create(name, T.STRING, lambda: None).value = value
        op.future.set_result(None)

    def _op_msetnx(self, key: str, op: Op) -> None:
        pairs = op.payload["pairs"]
        if any(self._entry(n) is not None for n in pairs):
            op.future.set_result(False)
            return
        for name, value in pairs.items():
            self._create(name, T.STRING, lambda: None).value = value
        op.future.set_result(True)

    # -- hash (RMap) ---------------------------------------------------------

    def _op_hput(self, key: str, op: Op) -> None:
        kv = self._create(key, T.HASH, dict)
        old = kv.value.get(op.payload["field"])
        kv.value[op.payload["field"]] = op.payload["value"]
        op.future.set_result(old)

    def _op_hput_if_absent(self, key: str, op: Op) -> None:
        kv = self._create(key, T.HASH, dict)
        old = kv.value.get(op.payload["field"])
        if old is None:
            kv.value[op.payload["field"]] = op.payload["value"]
        op.future.set_result(old)

    def _op_hputall(self, key: str, op: Op) -> None:
        kv = self._create(key, T.HASH, dict)
        kv.value.update(op.payload["pairs"])
        op.future.set_result(None)

    def _op_hget(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result(None if kv is None else kv.value.get(op.payload["field"]))

    def _op_hmget(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        fields = op.payload["fields"]
        if kv is None:
            op.future.set_result({})
            return
        op.future.set_result({f: kv.value[f] for f in fields if f in kv.value})

    def _op_hgetall(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result({} if kv is None else dict(kv.value))

    def _op_hdel(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        if kv is None:
            op.future.set_result(0)
            return
        n = 0
        for f in op.payload["fields"]:
            if kv.value.pop(f, None) is not None:
                n += 1
        self._drop_if_empty(key, kv)
        op.future.set_result(n)

    def _op_hremove(self, key: str, op: Op) -> None:
        """remove(field) -> old value (reference RMap.remove)."""
        kv = self._entry(key, T.HASH)
        if kv is None:
            op.future.set_result(None)
            return
        old = kv.value.pop(op.payload["field"], None)
        self._drop_if_empty(key, kv)
        op.future.set_result(old)

    def _op_hremove_if(self, key: str, op: Op) -> None:
        """remove(field, value) -> bool (Lua in the reference)."""
        kv = self._entry(key, T.HASH)
        f = op.payload["field"]
        if kv is None or kv.value.get(f) != op.payload["value"]:
            op.future.set_result(False)
            return
        del kv.value[f]
        self._drop_if_empty(key, kv)
        op.future.set_result(True)

    def _op_hreplace(self, key: str, op: Op) -> None:
        """replace(field, value) -> old, only if present."""
        kv = self._entry(key, T.HASH)
        f = op.payload["field"]
        if kv is None or f not in kv.value:
            op.future.set_result(None)
            return
        old = kv.value[f]
        kv.value[f] = op.payload["value"]
        op.future.set_result(old)

    def _op_hreplace_if(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        f = op.payload["field"]
        if kv is None or kv.value.get(f) != op.payload["old"]:
            op.future.set_result(False)
            return
        kv.value[f] = op.payload["new"]
        op.future.set_result(True)

    def _op_hcontains_key(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result(kv is not None and op.payload["field"] in kv.value)

    def _op_hcontains_value(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result(kv is not None and op.payload["value"] in kv.value.values())

    def _op_hlen(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result(0 if kv is None else len(kv.value))

    def _op_hkeys(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result([] if kv is None else list(kv.value.keys()))

    def _op_hvals(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.HASH)
        op.future.set_result([] if kv is None else list(kv.value.values()))

    def _op_hincr(self, key: str, op: Op) -> None:
        """HINCRBY/HINCRBYFLOAT (RMap.addAndGet)."""
        kv = self._create(key, T.HASH, dict)
        f = op.payload["field"]
        as_float = bool(op.payload.get("float"))
        cur = kv.value.get(f)
        base = (float(cur) if as_float else int(cur)) if cur is not None else (0.0 if as_float else 0)
        val = base + op.payload["by"]
        kv.value[f] = repr(val).encode() if as_float else str(val).encode()
        op.future.set_result(val)

    def _scan_page(self, kv, cursor: int, count: int):
        """Stable-cursor SCAN page over a hash/set/zset entry.

        Members are stamped with a monotonic per-entry sequence number the
        first time a scan sees them; a page is the `count` live members with
        stamp > cursor, in stamp order. Deleting a member drops its stamp
        without renumbering the others, so an element present for the whole
        scan is returned exactly once regardless of concurrent mutation (the
        guarantee the reference's iterators rely on,
        `RedissonBaseIterator.java`); members added or re-added mid-scan
        stamp after the cursor and are seen at most once.
        """
        if kv.scan_seq is None:
            kv.scan_seq = {}
        seqs = kv.scan_seq
        members = kv.value  # dict (hash/zset field map) or set
        for m in [m for m in seqs if m not in members]:
            del seqs[m]
        for m in members:
            if m not in seqs:
                seqs[m] = kv.scan_next
                kv.scan_next += 1
        # seqs is insertion-ordered = stamp-ascending (new stamps append,
        # deletions don't reorder), so a page is one ordered walk — no sort.
        page: list = []
        more = False
        for m, s in seqs.items():
            if s <= cursor:
                continue
            if len(page) < count:
                page.append((s, m))
            else:
                more = True
                break
        if not more:
            # Scan complete: drop the stamp map so a scanned 1M-member set
            # doesn't carry a permanent member->stamp shadow. A concurrent
            # scan still in flight degrades to at-least-once (fresh stamps
            # may re-return members) — Redis SCAN's own guarantee.
            kv.scan_seq = None
            return 0, [m for _, m in page]
        return page[-1][0], [m for _, m in page]

    def _op_hscan(self, key: str, op: Op) -> None:
        """Cursor iteration (HSCAN): returns (next_cursor, [(f, v)...])."""
        kv = self._entry(key, T.HASH)
        cursor, count = op.payload["cursor"], op.payload.get("count", 10)
        if kv is None:
            op.future.set_result((0, []))
            return
        nxt, fields = self._scan_page(kv, cursor, count)
        op.future.set_result((nxt, [(f, kv.value[f]) for f in fields]))

    # -- set (RSet) ----------------------------------------------------------

    def _op_sadd(self, key: str, op: Op) -> None:
        kv = self._create(key, T.SET, set)
        before = len(kv.value)
        kv.value.update(op.payload["members"])
        op.future.set_result(len(kv.value) - before)

    def _op_srem(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        if kv is None:
            op.future.set_result(0)
            return
        n = 0
        for m in op.payload["members"]:
            if m in kv.value:
                kv.value.discard(m)
                n += 1
        self._drop_if_empty(key, kv)
        op.future.set_result(n)

    def _op_sismember(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        op.future.set_result(kv is not None and op.payload["member"] in kv.value)

    def _op_smembers(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        op.future.set_result(set() if kv is None else set(kv.value))

    def _op_scard(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        op.future.set_result(0 if kv is None else len(kv.value))

    def _op_spop(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        if kv is None:
            op.future.set_result([])
            return
        count = op.payload.get("count", 1)
        out = []
        for _ in range(min(count, len(kv.value))):
            out.append(kv.value.pop())
        self._drop_if_empty(key, kv)
        op.future.set_result(out)

    def _op_srandmember(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        if kv is None or not kv.value:
            op.future.set_result([])
            return
        count = op.payload.get("count", 1)
        members = list(kv.value)
        if count < 0:
            # Redis semantics: negative count samples with repetition.
            op.future.set_result(_rand.choices(members, k=-count))
            return
        op.future.set_result(_rand.sample(members, min(count, len(members))))

    def _op_smove(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        m = op.payload["member"]
        if kv is None or m not in kv.value:
            op.future.set_result(False)
            return
        kv.value.discard(m)
        self._drop_if_empty(key, kv)
        self._create(op.payload["dst"], T.SET, set).value.add(m)
        op.future.set_result(True)

    def _sets_of(self, names) -> List[set]:
        out = []
        for n in names:
            kv = self._entry(n, T.SET)
            out.append(set() if kv is None else kv.value)
        return out

    def _op_sinter(self, key: str, op: Op) -> None:
        sets = self._sets_of([key, *op.payload["names"]])
        op.future.set_result(set.intersection(*sets) if sets else set())

    def _op_sunion(self, key: str, op: Op) -> None:
        op.future.set_result(set.union(*self._sets_of([key, *op.payload["names"]])))

    def _op_sdiff(self, key: str, op: Op) -> None:
        sets = self._sets_of([key, *op.payload["names"]])
        op.future.set_result(sets[0].difference(*sets[1:]) if sets else set())

    def _op_sstore(self, key: str, op: Op) -> None:
        """SINTERSTORE/SUNIONSTORE/SDIFFSTORE into target key."""
        which = op.payload["op"]
        sets = self._sets_of(op.payload["names"])
        if which == "inter":
            result = set.intersection(*sets) if sets else set()
        elif which == "union":
            result = set.union(*sets) if sets else set()
        else:
            result = sets[0].difference(*sets[1:]) if sets else set()
        if result:
            self._create(key, T.SET, set).value = result
        else:
            self._drop(key)
        op.future.set_result(len(result))

    def _op_sretain(self, key: str, op: Op) -> None:
        """retainAll (the reference's ×100-optimized path uses server-side
        set algebra, `CHANGELOG.md:53`); atomic single op here."""
        kv = self._entry(key, T.SET)
        if kv is None:
            op.future.set_result(False)
            return
        keep = set(op.payload["members"])
        before = len(kv.value)
        kv.value &= keep
        self._drop_if_empty(key, kv)
        op.future.set_result(len(kv.value) != before)

    def _op_sscan(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.SET)
        cursor, count = op.payload["cursor"], op.payload.get("count", 10)
        if kv is None:
            op.future.set_result((0, []))
            return
        op.future.set_result(self._scan_page(kv, cursor, count))

    # -- list (RList / RQueue / RDeque) --------------------------------------

    def _push(self, key: str, values, side: str) -> int:
        kv = self._create(key, T.LIST, deque)
        for v in values:
            if side == "left":
                kv.value.appendleft(v)
            else:
                kv.value.append(v)
        n = len(kv.value)
        self._serve_waiters(key)
        return n

    def _op_rpush(self, key: str, op: Op) -> None:
        op.future.set_result(self._push(key, op.payload["values"], "right"))

    def _op_lpush(self, key: str, op: Op) -> None:
        op.future.set_result(self._push(key, op.payload["values"], "left"))

    def _op_lrange(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result([])
            return
        items = list(kv.value)
        start, stop = op.payload["start"], op.payload["stop"]
        n = len(items)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        op.future.set_result(items[max(0, start) : stop + 1])

    def _op_lindex(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        i = op.payload["index"]
        if kv is None or not -len(kv.value) <= i < len(kv.value):
            op.future.set_result(None)
            return
        op.future.set_result(kv.value[i])

    def _op_lset(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        i = op.payload["index"]
        if kv is None or not -len(kv.value) <= i < len(kv.value):
            raise IndexError(f"list index {i} out of range for '{key}'")
        old = kv.value[i]
        kv.value[i] = op.payload["value"]
        op.future.set_result(old)

    def _op_linsert_at(self, key: str, op: Op) -> None:
        """add(index, value) — the reference does LINSERT/Lua shuffling."""
        kv = self._create(key, T.LIST, deque)
        i = op.payload["index"]
        if i > len(kv.value):
            raise IndexError(f"insert index {i} beyond list size {len(kv.value)}")
        kv.value.insert(i, op.payload["value"])
        self._serve_waiters(key)
        op.future.set_result(True)

    def _op_lsplice(self, key: str, op: Op) -> None:
        """addAll(index, values) as ONE op, mirroring lretain: the old
        model-level loop of linsert_at let concurrent writers interleave
        between elements. Same bound rule as linsert_at (error past the
        current size, RedissonListTest.java:715-719)."""
        kv = self._create(key, T.LIST, deque)
        i = op.payload["index"]
        vals = op.payload["values"]
        if i > len(kv.value):
            self._drop_if_empty(key, kv)
            raise IndexError(
                f"insert index {i} beyond list size {len(kv.value)}")
        if not vals:
            self._drop_if_empty(key, kv)
            op.future.set_result(False)
            return
        items = list(kv.value)
        items[i:i] = vals
        kv.value.clear()
        kv.value.extend(items)
        self._serve_waiters(key)
        op.future.set_result(True)

    def _op_linsert(self, key: str, op: Op) -> None:
        """LINSERT BEFORE|AFTER pivot value -> new size | -1 if no pivot."""
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result(0)
            return
        pivot = op.payload["pivot"]
        try:
            idx = list(kv.value).index(pivot)
        except ValueError:
            op.future.set_result(-1)
            return
        kv.value.insert(idx if op.payload.get("before", True) else idx + 1, op.payload["value"])
        self._serve_waiters(key)
        op.future.set_result(len(kv.value))

    def _op_lrem(self, key: str, op: Op) -> None:
        """LREM count value -> removed count (count>0 head-first, <0 tail-first, 0 all)."""
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result(0)
            return
        count, value = op.payload.get("count", 0), op.payload["value"]
        items = list(kv.value)
        removed = 0
        limit = abs(count) if count else len(items)
        if count < 0:
            items.reverse()
        out = []
        for v in items:
            if v == value and removed < limit:
                removed += 1
            else:
                out.append(v)
        if count < 0:
            out.reverse()
        kv.value = deque(out)
        self._drop_if_empty(key, kv)
        op.future.set_result(removed)

    def _op_lretain(self, key: str, op: Op) -> None:
        """List retainAll: in-place filter keeping order/dups of kept
        elements — one atomic op, expiry untouched (a model-level
        delete()+rpush would drop the TTL and expose a transient empty
        list)."""
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result(False)
            return
        keep = set(op.payload["members"])
        out = deque(v for v in kv.value if v in keep)
        changed = len(out) != len(kv.value)
        kv.value.clear()
        kv.value.extend(out)
        self._drop_if_empty(key, kv)
        op.future.set_result(changed)

    def _op_lrem_index(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        i = op.payload["index"]
        if kv is None or not -len(kv.value) <= i < len(kv.value):
            op.future.set_result(None)
            return
        old = kv.value[i]
        del kv.value[i]
        self._drop_if_empty(key, kv)
        op.future.set_result(old)

    def _op_llen(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        op.future.set_result(0 if kv is None else len(kv.value))

    def _op_lindexof(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result(-1)
            return
        items = list(kv.value)
        v = op.payload["value"]
        if op.payload.get("last"):
            for i in range(len(items) - 1, -1, -1):
                if items[i] == v:
                    op.future.set_result(i)
                    return
            op.future.set_result(-1)
            return
        try:
            op.future.set_result(items.index(v))
        except ValueError:
            op.future.set_result(-1)

    def _op_ltrim(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.LIST)
        if kv is None:
            op.future.set_result(None)
            return
        items = list(kv.value)
        start, stop = op.payload["start"], op.payload["stop"]
        n = len(items)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        kv.value = deque(items[max(0, start) : stop + 1])
        self._drop_if_empty(key, kv)
        op.future.set_result(None)

    def _pop(self, key: str, side: str):
        kv = self._entry(key, T.LIST)
        if kv is None or not kv.value:
            return None
        v = kv.value.popleft() if side == "left" else kv.value.pop()
        self._drop_if_empty(key, kv)
        return v

    def _op_lpop(self, key: str, op: Op) -> None:
        op.future.set_result(self._pop(key, "left"))

    def _op_rpop(self, key: str, op: Op) -> None:
        op.future.set_result(self._pop(key, "right"))

    def _op_rpoplpush(self, key: str, op: Op) -> None:
        v = self._pop(key, "right")
        if v is not None:
            self._push(op.payload["dst"], [v], "left")
        op.future.set_result(v)

    # -- blocking pops (waiter machinery) ------------------------------------

    def _serve_waiters(self, key: str) -> None:
        """Fulfill parked blocking pops right after a push — same dispatch,
        so push→wake is atomic (the reference rides BLPOP inside Redis)."""
        q = self._waiters.get(key)
        while q:
            kv = self._entry(key, T.LIST)
            if kv is None or not kv.value:
                break
            w = q.popleft()
            if w.op.future.done():
                continue  # cancelled
            v = kv.value.popleft() if w.side == "left" else kv.value.pop()
            self._drop_if_empty(key, kv)
            if w.dest is not None:
                self._push(w.dest, [v], "left")
            w.op.future.set_result(v)
        if q is not None and not q:
            self._waiters.pop(key, None)

    def _op_bpop(self, key: str, op: Op) -> None:
        """BLPOP/BRPOP/BRPOPLPUSH: immediate pop or park a waiter.

        The future stays pending; the client thread waits with its own
        timeout and then submits bpop_cancel (the reference's blocking pops
        ride the no-timeout L2 path, `CommandAsyncService.java:491-497`).
        """
        side = op.payload.get("side", "left")
        dest = op.payload.get("dest")
        v = self._pop(key, side)
        if v is not None:
            if dest is not None:
                self._push(dest, [v], "left")
            op.future.set_result(v)
            return
        wid = next(self._waiter_ids)
        op.payload["wid"] = wid
        self._waiters.setdefault(key, deque()).append(Waiter(wid, op, side, dest))

    def _op_bpop_cancel(self, key: str, op: Op) -> None:
        """Resolve the park/fulfill race on the dispatcher thread: if the
        waiter is still pending, complete it with None (timeout).

        The waiter id is read from the *original bpop payload* (shared by
        reference) at dispatch time — per-target FIFO guarantees the bpop
        handler already ran and wrote it.
        """
        wid = op.payload["ref"].get("wid", -1)
        q = self._waiters.get(key)
        if q is not None:
            for w in list(q):
                if w.wid == wid:
                    q.remove(w)
                    if not w.op.future.done():
                        w.op.future.set_result(None)
                    break
            if not q:
                self._waiters.pop(key, None)
        op.future.set_result(None)

    def fail_waiters(self, exc: Optional[Exception] = None) -> None:
        """Complete every parked blocking-pop future on shutdown so client
        threads blocked in take()/poll() don't hang forever. Called after
        the dispatcher has exited (no concurrent handler activity)."""
        exc = exc or RuntimeError("client shut down while blocked")
        for q in list(self._waiters.values()):
            for w in q:
                if not w.op.future.done():
                    w.op.future.set_exception(exc)
        self._waiters.clear()

    # -- zset (RScoredSortedSet / RLexSortedSet) -----------------------------

    @staticmethod
    def _zsorted(d: Dict[bytes, float]) -> List[Tuple[bytes, float]]:
        return sorted(d.items(), key=lambda kvp: (kvp[1], kvp[0]))

    def _op_zadd(self, key: str, op: Op) -> None:
        kv = self._create(key, T.ZSET, dict)
        added = 0
        only_if_absent = op.payload.get("nx", False)
        for member, score in op.payload["pairs"]:
            if member not in kv.value:
                added += 1
                kv.value[member] = float(score)
            elif not only_if_absent:
                kv.value[member] = float(score)
        op.future.set_result(added)

    def _op_zscore(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        op.future.set_result(None if kv is None else kv.value.get(op.payload["member"]))

    def _op_zincrby(self, key: str, op: Op) -> None:
        kv = self._create(key, T.ZSET, dict)
        m = op.payload["member"]
        kv.value[m] = kv.value.get(m, 0.0) + float(op.payload["by"])
        op.future.set_result(kv.value[m])

    def _op_zrem(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(0)
            return
        n = sum(1 for m in op.payload["members"] if kv.value.pop(m, None) is not None)
        self._drop_if_empty(key, kv)
        op.future.set_result(n)

    def _op_zcard(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        op.future.set_result(0 if kv is None else len(kv.value))

    @staticmethod
    def _score_in(score, lo, hi, lo_inc, hi_inc) -> bool:
        if lo is not None and (score < lo or (score == lo and not lo_inc)):
            return False
        if hi is not None and (score > hi or (score == hi and not hi_inc)):
            return False
        return True

    def _op_zcount(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(0)
            return
        p = op.payload
        op.future.set_result(
            sum(
                1
                for s in kv.value.values()
                if self._score_in(s, p.get("min"), p.get("max"), p.get("min_inc", True), p.get("max_inc", True))
            )
        )

    def _op_zrank(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(None)
            return
        ordered = self._zsorted(kv.value)
        if op.payload.get("rev"):
            ordered = ordered[::-1]
        for i, (m, _) in enumerate(ordered):
            if m == op.payload["member"]:
                op.future.set_result(i)
                return
        op.future.set_result(None)

    def _op_zrange(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result([])
            return
        ordered = self._zsorted(kv.value)
        if op.payload.get("rev"):
            ordered = ordered[::-1]
        start, stop = op.payload["start"], op.payload["stop"]
        n = len(ordered)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        chunk = ordered[max(0, start) : stop + 1]
        if op.payload.get("withscores"):
            op.future.set_result(chunk)
        else:
            op.future.set_result([m for m, _ in chunk])

    def _op_zrangebyscore(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result([])
            return
        p = op.payload
        ordered = [
            (m, s)
            for m, s in self._zsorted(kv.value)
            if self._score_in(s, p.get("min"), p.get("max"), p.get("min_inc", True), p.get("max_inc", True))
        ]
        if p.get("rev"):
            ordered = ordered[::-1]
        off, cnt = p.get("offset", 0), p.get("count")
        ordered = ordered[off:] if cnt is None else ordered[off : off + cnt]
        if p.get("withscores"):
            op.future.set_result(ordered)
        else:
            op.future.set_result([m for m, _ in ordered])

    def _op_zremrangebyscore(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(0)
            return
        p = op.payload
        doomed = [
            m
            for m, s in kv.value.items()
            if self._score_in(s, p.get("min"), p.get("max"), p.get("min_inc", True), p.get("max_inc", True))
        ]
        for m in doomed:
            del kv.value[m]
        self._drop_if_empty(key, kv)
        op.future.set_result(len(doomed))

    def _op_zremrangebyrank(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(0)
            return
        ordered = self._zsorted(kv.value)
        start, stop = op.payload["start"], op.payload["stop"]
        n = len(ordered)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        doomed = ordered[max(0, start) : stop + 1]
        for m, _ in doomed:
            del kv.value[m]
        self._drop_if_empty(key, kv)
        op.future.set_result(len(doomed))

    def _op_zpop(self, key: str, op: Op) -> None:
        """pollFirst/pollLast."""
        kv = self._entry(key, T.ZSET)
        if kv is None or not kv.value:
            op.future.set_result(None)
            return
        ordered = self._zsorted(kv.value)
        m, s = ordered[-1] if op.payload.get("last") else ordered[0]
        del kv.value[m]
        self._drop_if_empty(key, kv)
        op.future.set_result((m, s))

    def _op_zmscore(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        members = op.payload["members"]
        if kv is None:
            op.future.set_result([None] * len(members))
            return
        op.future.set_result([kv.value.get(m) for m in members])

    def _op_zstore(self, key: str, op: Op) -> None:
        """ZUNIONSTORE/ZINTERSTORE with SUM aggregation (reference union/intersection)."""
        which = op.payload["op"]
        maps: List[Dict[bytes, float]] = []
        for n in op.payload["names"]:
            kv = self._entry(n, T.ZSET)
            maps.append({} if kv is None else dict(kv.value))
        if which == "union":
            out: Dict[bytes, float] = {}
            for m in maps:
                for member, score in m.items():
                    out[member] = out.get(member, 0.0) + score
        else:
            common = set(maps[0]) if maps else set()
            for m in maps[1:]:
                common &= set(m)
            out = {member: sum(m.get(member, 0.0) for m in maps) for member in common}
        if out:
            self._create(key, T.ZSET, dict).value = out
        else:
            self._drop(key)
        op.future.set_result(len(out))

    # lex ranges over a zset where all scores are equal (RLexSortedSet)

    @staticmethod
    def _lex_in(m, lo, hi, lo_inc, hi_inc) -> bool:
        if lo is not None and (m < lo or (m == lo and not lo_inc)):
            return False
        if hi is not None and (m > hi or (m == hi and not hi_inc)):
            return False
        return True

    def _op_zrangebylex(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result([])
            return
        p = op.payload
        members = sorted(kv.value)
        out = [
            m
            for m in members
            if self._lex_in(m, p.get("min"), p.get("max"), p.get("min_inc", True), p.get("max_inc", True))
        ]
        if p.get("rev"):
            out = out[::-1]
        off, cnt = p.get("offset", 0), p.get("count")
        op.future.set_result(out[off:] if cnt is None else out[off : off + cnt])

    def _op_zremrangebylex(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        if kv is None:
            op.future.set_result(0)
            return
        p = op.payload
        doomed = [
            m
            for m in kv.value
            if self._lex_in(m, p.get("min"), p.get("max"), p.get("min_inc", True), p.get("max_inc", True))
        ]
        for m in doomed:
            del kv.value[m]
        self._drop_if_empty(key, kv)
        op.future.set_result(len(doomed))

    def _op_zscan(self, key: str, op: Op) -> None:
        kv = self._entry(key, T.ZSET)
        cursor, count = op.payload["cursor"], op.payload.get("count", 10)
        if kv is None:
            op.future.set_result((0, []))
            return
        nxt, members = self._scan_page(kv, cursor, count)
        op.future.set_result((nxt, [(m, kv.value[m]) for m in members]))

    # -- pub/sub -------------------------------------------------------------

    def _op_publish(self, key: str, op: Op) -> None:
        op.future.set_result(self.pubsub.publish(op.payload["channel"], op.payload["message"]))


def filter_state_dump(blob: bytes, keep) -> Tuple[bytes, int]:
    """Project a dump_state() capture onto the keys `keep(name)` accepts,
    returning (filtered blob, kept count). Pure host-side pickle surgery —
    the slot migrator filters a source snapshot's structure sidecar down to
    the migrating slots before shipping it as a `migrate_install` op."""
    payload = _load_dump(blob)
    if payload.get("format") != 1:
        raise ValueError(
            f"unsupported structure dump format {payload.get('format')!r}")
    data = {k: v for k, v in payload["data"].items() if keep(k)}
    return (pickle.dumps({"format": 1, "data": data},
                         protocol=pickle.HIGHEST_PROTOCOL), len(data))
