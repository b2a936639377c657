"""Coordination objects over Redis — server-side Lua + pub/sub wake-ups
(counterpart of `redisson_tpu.interop.coordination_redis`).

This is the reference's own execution model for locks, semaphores, latches,
topics and map-cache TTL: an atomic Lua script per state transition
(`RedissonLock.java:236-252` tryAcquire CAS, `:324-343` unlock+publish;
`RedissonSemaphore.java`; `RedissonCountDownLatch.java`;
`RedissonMapCache.java:75-87` TTL puts over companion zsets), with waiters
parked on a pub/sub channel instead of polling
(`pubsub/LockPubSub.java`, `RedissonLock.java:107-142`).

Scripts here are written fresh against those semantics — structured for
this client, not transcribed — and run on any RESP server with EVAL,
including the in-process fake (`fake_server.py` + `mini_lua.py`).

Naming follows the reference so a real Redisson client sharing the server
interoperates: lock owner field ``uuid:threadId`` (`RedissonLock.java:83-85`),
wake-up channel ``redisson_lock__channel__{name}`` (`:79-81`), map-cache
timeout zset ``redisson__timeout__set__{name}``
(`RedissonMapCache.java getTimeoutSetName`).

Objects mirror the engine-backed models' public surface (`models/lock.py`,
`models/topic.py`, `models/mapcache.py`) so mode='redis' is a drop-in.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from redisson_tpu_torch.models.lock import DEFAULT_LEASE_S, _OWNER_CTX
from redisson_tpu_torch.native import RespError

UNLOCK_MESSAGE = b"0"
ZERO_COUNT_MESSAGE = b"0"
NEW_COUNT_MESSAGE = b"1"
RELEASE_MESSAGE = b"1"


def _now_ms() -> int:
    return int(time.time() * 1000)


class ScriptRunner:
    """EVALSHA with EVAL fallback over the shared RESP client — the
    reference's evalWriteAsync path (`command/CommandAsyncService.java:290-363`)
    with the standard NOSCRIPT upgrade."""

    def __init__(self, resp):
        self.resp = resp
        self._shas: Dict[str, str] = {}  # script text -> sha1

    def run(self, script: str, keys: Iterable, args: Iterable) -> Any:
        keys = [k if isinstance(k, (bytes, str)) else str(k) for k in keys]
        args = [a if isinstance(a, (bytes, str)) else str(a) for a in args]
        sha = self._shas.get(script)
        if sha is None:
            sha = hashlib.sha1(script.encode()).hexdigest()
            if len(self._shas) > 4096:
                self._shas.clear()
            self._shas[script] = sha
        try:
            return self.resp.execute("EVALSHA", sha, str(len(keys)), *keys, *args)
        except RespError as e:
            if "NOSCRIPT" not in str(e):
                raise
            return self.resp.execute("EVAL", script, str(len(keys)), *keys, *args)


class RedisLockWatchdog:
    """Lease auto-renewal for held locks: every lease/3 an atomic Lua
    renew-if-still-owner runs server-side (`RedissonLock.java:59-61,
    197-227`)."""

    RENEW = """
    if (redis.call('hexists', KEYS[1], ARGV[2]) == 1) then
        redis.call('pexpire', KEYS[1], ARGV[1])
        return 1
    end
    return 0
    """

    def __init__(self, scripts: ScriptRunner, lease_s: float = DEFAULT_LEASE_S):
        self._scripts = scripts
        self.lease_s = lease_s
        # Set semantics, like the engine LockWatchdog: register is idempotent
        # across reentrant acquires, unregister fires once on final release.
        self._held: Dict[Tuple[str, str], bool] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="rtpu-redis-lock-watchdog", daemon=True)
        self._thread.start()

    def register(self, name: str, owner: str) -> None:
        with self._cv:
            self._held[(name, owner)] = True
            self._cv.notify()

    def unregister(self, name: str, owner: str) -> None:
        with self._cv:
            self._held.pop((name, owner), None)

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                self._cv.wait(timeout=self.lease_s / 3)
                if self._stop:
                    return
                held = list(self._held)
            for name, owner in held:
                try:
                    ok = self._scripts.run(
                        self.RENEW, [name], [int(self.lease_s * 1000), owner])
                except Exception:  # noqa: BLE001 - renewals retry next tick
                    continue
                if not ok:
                    # No longer the holder (expired / force-unlocked):
                    # self-heal instead of renewing a future reacquisition
                    # by this owner with a deliberately short lease.
                    self.unregister(name, owner)


class RedisLock:
    """Reentrant distributed lock executed on the Redis server.

    State: hash ``name`` with one field ``uuid:contextId`` holding the
    reentrancy count, key TTL as the lease. Contract identical to
    `RedissonLock.java:236-252`: try-script returns nil when acquired, else
    the holder's remaining ttl ms.
    """

    TRY_ACQUIRE = """
    if (redis.call('exists', KEYS[1]) == 0) then
        redis.call('hset', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    if (redis.call('hexists', KEYS[1], ARGV[2]) == 1) then
        redis.call('hincrby', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    return redis.call('pttl', KEYS[1])
    """

    UNLOCK = """
    -- Absent key => nil (caller raises): matches the engine-mode RLock,
    -- which surfaces a lost lease / double-unlock as an error. (The
    -- reference's script treats exists==0 as success,
    -- RedissonLock.java:324-330 — we prefer the louder contract and keep
    -- both of our modes identical.)
    if (redis.call('exists', KEYS[1]) == 0) then
        return nil
    end
    if (redis.call('hexists', KEYS[1], ARGV[3]) == 0) then
        return nil
    end
    local counter = redis.call('hincrby', KEYS[1], ARGV[3], -1)
    if (counter > 0) then
        redis.call('pexpire', KEYS[1], ARGV[2])
        return 0
    end
    redis.call('del', KEYS[1])
    redis.call('publish', KEYS[2], ARGV[1])
    return 1
    """

    FORCE_UNLOCK = """
    if (redis.call('del', KEYS[1]) == 1) then
        redis.call('publish', KEYS[2], ARGV[1])
        return 1
    end
    return 0
    """

    def __init__(self, name: str, scripts: ScriptRunner, pubsub, client_id: str,
                 watchdog: RedisLockWatchdog):
        self.name = name
        self._scripts = scripts
        self._pubsub = pubsub
        self._client_id = client_id
        self._watchdog = watchdog

    @property
    def channel(self) -> str:
        return "redisson_lock__channel__{%s}" % self.name

    def _owner(self) -> str:
        override = _OWNER_CTX.get()
        ctx = override if override is not None else threading.get_ident()
        return f"{self._client_id}:{ctx}"

    def _try_once(self, lease_s: Optional[float]) -> Optional[int]:
        effective = DEFAULT_LEASE_S if lease_s is None else lease_s
        ttl = self._scripts.run(
            self.TRY_ACQUIRE, [self.name],
            [int(effective * 1000), self._owner()])
        if ttl is None and lease_s is None:
            self._watchdog.register(self.name, self._owner())
        return ttl

    def try_lock(self, wait_time_s: Optional[float] = None,
                 lease_time_s: Optional[float] = None) -> bool:
        ttl = self._try_once(lease_time_s)
        if ttl is None:
            return True
        if not wait_time_s:
            return False
        deadline = time.monotonic() + wait_time_s
        event = threading.Event()
        listener = lambda ch, msg: event.set()  # noqa: E731
        self._pubsub.subscribe(self.channel, listener)
        try:
            self._pubsub.wait_subscribed(self.channel, min(wait_time_s, 5.0))
            # Retry at loop head: an unlock published between probe and
            # subscribe is otherwise a missed wakeup (RedissonLock.java:124-137).
            while True:
                ttl = self._try_once(lease_time_s)
                if ttl is None:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                wait_for = remaining if ttl is None or ttl < 0 else min(
                    remaining, ttl / 1000)
                event.wait(timeout=wait_for)
                event.clear()
        finally:
            self._pubsub.unsubscribe(self.channel, listener)

    def lock(self, lease_time_s: Optional[float] = None) -> None:
        while not self.try_lock(5.0, lease_time_s):
            pass

    def unlock(self) -> None:
        res = self._scripts.run(
            self.UNLOCK, [self.name, self.channel],
            [UNLOCK_MESSAGE, int(DEFAULT_LEASE_S * 1000), self._owner()])
        if res is None:
            raise RuntimeError(
                f"attempt to unlock '{self.name}' not locked by current "
                f"thread (owner {self._owner()})")
        if res == 1:
            self._watchdog.unregister(self.name, self._owner())

    def force_unlock(self) -> bool:
        return bool(self._scripts.run(
            self.FORCE_UNLOCK, [self.name, self.channel], [UNLOCK_MESSAGE]))

    def is_locked(self) -> bool:
        return bool(self._scripts.resp.execute("EXISTS", self.name))

    def is_held_by_current_thread(self) -> bool:
        return self.get_hold_count() > 0

    def get_hold_count(self) -> int:
        v = self._scripts.resp.execute("HGET", self.name, self._owner())
        return int(v) if v is not None else 0

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class RedisFairLock(RedisLock):
    """FIFO-fair lock: a waiter list + per-waiter deadline zset beside the
    lock hash (`RedissonFairLock.java`'s Lua thread queue, re-derived).
    Expired waiters are pruned at every attempt so an abandoned process
    never wedges the queue."""

    FAIR_TRY = """
    while true do
        local head = redis.call('lindex', KEYS[2], 0)
        if (head == false) then
            break
        end
        local dl = redis.call('zscore', KEYS[3], head)
        if (dl ~= false and tonumber(dl) <= tonumber(ARGV[4])) then
            redis.call('lpop', KEYS[2])
            redis.call('zrem', KEYS[3], head)
        else
            break
        end
    end
    if (redis.call('exists', KEYS[1]) == 0) then
        local head = redis.call('lindex', KEYS[2], 0)
        if (head == false or head == ARGV[2]) then
            if (head == ARGV[2]) then
                redis.call('lpop', KEYS[2])
                redis.call('zrem', KEYS[3], ARGV[2])
            end
            redis.call('hset', KEYS[1], ARGV[2], 1)
            redis.call('pexpire', KEYS[1], ARGV[1])
            return nil
        end
    end
    if (redis.call('hexists', KEYS[1], ARGV[2]) == 1) then
        redis.call('hincrby', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    if (tonumber(ARGV[3]) > 0) then
        if (redis.call('zscore', KEYS[3], ARGV[2]) == false) then
            redis.call('rpush', KEYS[2], ARGV[2])
        end
        redis.call('zadd', KEYS[3], tonumber(ARGV[4]) + tonumber(ARGV[3]), ARGV[2])
    end
    return redis.call('pttl', KEYS[1])
    """

    DEQUEUE = """
    redis.call('lrem', KEYS[2], 1, ARGV[1])
    redis.call('zrem', KEYS[3], ARGV[1])
    return 1
    """

    @property
    def queue_name(self) -> str:
        return "redisson_lock_queue:{%s}" % self.name

    @property
    def timeout_name(self) -> str:
        return "redisson_lock_timeout:{%s}" % self.name

    def _try_once(self, lease_s: Optional[float],
                  wait_ms: int = 0) -> Optional[int]:
        effective = DEFAULT_LEASE_S if lease_s is None else lease_s
        ttl = self._scripts.run(
            self.FAIR_TRY, [self.name, self.queue_name, self.timeout_name],
            [int(effective * 1000), self._owner(),
             # waiter entry TTL: wait budget + slack (engine lock_try parity)
             wait_ms + 5000 if wait_ms else 0, _now_ms()])
        if ttl is None and lease_s is None:
            self._watchdog.register(self.name, self._owner())
        return ttl

    def try_lock(self, wait_time_s: Optional[float] = None,
                 lease_time_s: Optional[float] = None) -> bool:
        return self._try_lock_fair(wait_time_s, lease_time_s,
                                   dequeue_on_timeout=True)

    def _try_lock_fair(self, wait_time_s: Optional[float],
                       lease_time_s: Optional[float],
                       dequeue_on_timeout: bool) -> bool:
        wait_ms = int(wait_time_s * 1000) if wait_time_s else 0
        ttl = self._try_once(lease_time_s, wait_ms)
        if ttl is None:
            return True
        if not wait_time_s:
            return False
        deadline = time.monotonic() + wait_time_s
        event = threading.Event()
        listener = lambda ch, msg: event.set()  # noqa: E731
        self._pubsub.subscribe(self.channel, listener)
        try:
            self._pubsub.wait_subscribed(self.channel, min(wait_time_s, 5.0))
            while True:
                remaining = deadline - time.monotonic()
                ttl = self._try_once(lease_time_s, max(int(remaining * 1000), 0))
                if ttl is None:
                    return True
                if remaining <= 0:
                    if dequeue_on_timeout:  # give up our queue slot
                        self._scripts.run(
                            self.DEQUEUE,
                            [self.name, self.queue_name, self.timeout_name],
                            [self._owner()])
                    return False
                wait_for = remaining if ttl < 0 else min(remaining, ttl / 1000)
                event.wait(timeout=wait_for)
                event.clear()
        finally:
            self._pubsub.unsubscribe(self.channel, listener)

    def lock(self, lease_time_s: Optional[float] = None) -> None:
        # Keep the queue slot across 5 s rounds (each retry refreshes the
        # waiter-entry TTL), so FIFO position is never forfeited.
        while not self._try_lock_fair(5.0, lease_time_s,
                                      dequeue_on_timeout=False):
            pass


class RedisReadWriteLock:
    """Read/write lock over one hash: field ``mode`` = read|write plus
    per-owner hold counts (`RedissonReadWriteLock.java` Lua semantics:
    readers share; writer excludes; the writer may take read locks)."""

    READ_TRY = """
    local mode = redis.call('hget', KEYS[1], 'mode')
    if (mode == false) then
        redis.call('hset', KEYS[1], 'mode', 'read')
        redis.call('hset', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    if (mode == 'read') or (redis.call('hexists', KEYS[1], ARGV[3]) == 1) then
        redis.call('hincrby', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    return redis.call('pttl', KEYS[1])
    """

    WRITE_TRY = """
    local mode = redis.call('hget', KEYS[1], 'mode')
    if (mode == false) then
        redis.call('hset', KEYS[1], 'mode', 'write')
        redis.call('hset', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    if (mode == 'write') and (redis.call('hexists', KEYS[1], ARGV[2]) == 1) then
        redis.call('hincrby', KEYS[1], ARGV[2], 1)
        redis.call('pexpire', KEYS[1], ARGV[1])
        return nil
    end
    return redis.call('pttl', KEYS[1])
    """

    RELEASE = """
    -- returns: nil = not a holder; 0 = still reentrant-held by this owner;
    -- 2 = this owner fully released but others hold on; 1 = lock freed
    if (redis.call('hexists', KEYS[1], ARGV[2]) == 0) then
        return nil
    end
    local counter = redis.call('hincrby', KEYS[1], ARGV[2], -1)
    if (counter > 0) then
        redis.call('pexpire', KEYS[1], ARGV[3])
        return 0
    end
    redis.call('hdel', KEYS[1], ARGV[2])
    if (redis.call('hlen', KEYS[1]) > 1) then
        -- Recompute mode from the remaining hold fields: when the released
        -- write hold leaves only read holds (the writer-reads-then-releases
        -- downgrade this tier allows), flip mode to 'read' and publish so
        -- blocked readers/writers stop TTL-paced polling (r2 advisor
        -- finding: mode stayed 'write' and no wake-up was published).
        local fields = redis.call('hkeys', KEYS[1])
        local writers = 0
        for i = 1, #fields do
            local f = fields[i]
            if (f ~= 'mode') and (string.sub(f, -6) == ':write') then
                writers = writers + 1
            end
        end
        if (writers == 0) and (redis.call('hget', KEYS[1], 'mode') == 'write') then
            redis.call('hset', KEYS[1], 'mode', 'read')
            redis.call('publish', KEYS[2], ARGV[1])
        end
        return 2
    end
    redis.call('del', KEYS[1])
    redis.call('publish', KEYS[2], ARGV[1])
    return 1
    """

    def __init__(self, name: str, scripts: ScriptRunner, pubsub,
                 client_id: str, watchdog: RedisLockWatchdog):
        self.name = name
        self._scripts = scripts
        self._pubsub = pubsub
        self._client_id = client_id
        self._watchdog = watchdog

    def read_lock(self) -> "_RedisRWHandle":
        return _RedisRWHandle(self, "read")

    def write_lock(self) -> "_RedisRWHandle":
        return _RedisRWHandle(self, "write")


class _RedisRWHandle(RedisLock):
    def __init__(self, parent: RedisReadWriteLock, mode: str):
        super().__init__(parent.name, parent._scripts, parent._pubsub,
                         parent._client_id, parent._watchdog)
        self._mode = mode

    def _owner(self) -> str:
        return super()._owner() + ":" + self._mode

    def _try_once(self, lease_s: Optional[float]) -> Optional[int]:
        effective = DEFAULT_LEASE_S if lease_s is None else lease_s
        owner = self._owner()
        write_owner = super()._owner() + ":write"
        script = (RedisReadWriteLock.READ_TRY if self._mode == "read"
                  else RedisReadWriteLock.WRITE_TRY)
        args = [int(effective * 1000), owner]
        if self._mode == "read":
            args.append(write_owner)  # writer may re-enter as reader
        ttl = self._scripts.run(script, [self.name], args)
        if ttl is None and lease_s is None:
            self._watchdog.register(self.name, owner)
        return ttl

    def unlock(self) -> None:
        res = self._scripts.run(
            RedisReadWriteLock.RELEASE, [self.name, self.channel],
            [UNLOCK_MESSAGE, self._owner(), int(DEFAULT_LEASE_S * 1000)])
        if res is None:
            raise RuntimeError(
                f"attempt to unlock '{self.name}' not locked by current "
                f"thread (owner {self._owner()})")
        if res in (1, 2):  # this owner's hold fully released
            self._watchdog.unregister(self.name, self._owner())

    def get_hold_count(self) -> int:
        v = self._scripts.resp.execute("HGET", self.name, self._owner())
        return int(v) if v is not None else 0


class RedisSemaphore:
    """Counting semaphore: a plain integer of available permits + release
    publish (`RedissonSemaphore.java` Lua contract)."""

    TRY_ACQUIRE = """
    local value = redis.call('get', KEYS[1])
    if (value ~= false and tonumber(value) >= tonumber(ARGV[1])) then
        redis.call('decrby', KEYS[1], ARGV[1])
        return 1
    end
    return 0
    """

    RELEASE = """
    redis.call('incrby', KEYS[1], ARGV[1])
    redis.call('publish', KEYS[2], ARGV[2])
    return 1
    """

    def __init__(self, name: str, scripts: ScriptRunner, pubsub):
        self.name = name
        self._scripts = scripts
        self._pubsub = pubsub

    @property
    def channel(self) -> str:
        return "redisson_semaphore__channel__{%s}" % self.name

    def try_set_permits(self, permits: int) -> bool:
        return bool(self._scripts.resp.execute(
            "SETNX", self.name, str(int(permits))))

    def try_acquire(self, permits: int = 1,
                    timeout_s: Optional[float] = None) -> bool:
        if bool(self._scripts.run(self.TRY_ACQUIRE, [self.name], [permits])):
            return True
        if not timeout_s:
            return False
        deadline = time.monotonic() + timeout_s
        event = threading.Event()
        listener = lambda ch, msg: event.set()  # noqa: E731
        self._pubsub.subscribe(self.channel, listener)
        try:
            self._pubsub.wait_subscribed(self.channel, min(timeout_s, 5.0))
            while True:
                if bool(self._scripts.run(
                        self.TRY_ACQUIRE, [self.name], [permits])):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                event.wait(timeout=remaining)
                event.clear()
        finally:
            self._pubsub.unsubscribe(self.channel, listener)

    def acquire(self, permits: int = 1) -> None:
        while not self.try_acquire(permits, timeout_s=5.0):
            pass

    def release(self, permits: int = 1) -> None:
        self._scripts.run(
            self.RELEASE, [self.name, self.channel],
            [permits, RELEASE_MESSAGE])

    def set_permits(self, permits: int) -> None:
        """Force the permit count atomically + wake waiters (reference
        setPermits)."""
        self._scripts.run(
            "redis.call('set', KEYS[1], ARGV[1]) "
            "redis.call('publish', KEYS[2], ARGV[2]) return 1",
            [self.name, self.channel], [int(permits), RELEASE_MESSAGE])

    def available_permits(self) -> int:
        v = self._scripts.resp.execute("GET", self.name)
        return int(v) if v is not None else 0

    def drain_permits(self) -> int:
        return int(self._scripts.run(
            """
            local value = redis.call('get', KEYS[1])
            if (value == false or tonumber(value) == 0) then
                return 0
            end
            redis.call('set', KEYS[1], 0)
            return tonumber(value)
            """, [self.name], []) or 0)

    def add_permits(self, permits: int) -> None:
        self.release(permits)

    def reduce_permits(self, permits: int) -> None:
        self._scripts.resp.execute("DECRBY", self.name, str(int(permits)))


class RedisCountDownLatch:
    """CountDownLatch: integer count; zero deletes + publishes
    (`RedissonCountDownLatch.java` contract, zeroCountMessage=0)."""

    COUNT_DOWN = """
    local v = redis.call('decr', KEYS[1])
    if (v <= 0) then
        redis.call('del', KEYS[1])
        redis.call('publish', KEYS[2], ARGV[1])
    end
    return v
    """

    def __init__(self, name: str, scripts: ScriptRunner, pubsub):
        self.name = name
        self._scripts = scripts
        self._pubsub = pubsub

    @property
    def channel(self) -> str:
        return "redisson_countdownlatch__channel__{%s}" % self.name

    def try_set_count(self, count: int) -> bool:
        return bool(self._scripts.run(
            """
            if (redis.call('exists', KEYS[1]) == 0) then
                redis.call('set', KEYS[1], ARGV[2])
                redis.call('publish', KEYS[2], ARGV[1])
                return 1
            end
            return 0
            """, [self.name, self.channel], [NEW_COUNT_MESSAGE, int(count)]))

    def count_down(self) -> None:
        self._scripts.run(
            self.COUNT_DOWN, [self.name, self.channel], [ZERO_COUNT_MESSAGE])

    def get_count(self) -> int:
        v = self._scripts.resp.execute("GET", self.name)
        return int(v) if v is not None else 0

    def delete(self) -> bool:
        """Drop the latch; True if it existed, waking waiters (reference
        deleteAsync: del + zero-count publish,
        RedissonCountDownLatchTest.java:120-131)."""
        return bool(self._scripts.run(
            """
            if (redis.call('exists', KEYS[1]) == 1) then
                redis.call('del', KEYS[1])
                redis.call('publish', KEYS[2], ARGV[1])
                return 1
            end
            return 0
            """,
            [self.name, self.channel], [ZERO_COUNT_MESSAGE]))

    def await_(self, timeout_s: Optional[float] = None) -> bool:
        if self.get_count() == 0:
            return True
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        event = threading.Event()
        listener = lambda ch, msg: event.set()  # noqa: E731
        self._pubsub.subscribe(self.channel, listener)
        try:
            self._pubsub.wait_subscribed(self.channel, 5.0)
            while True:
                if self.get_count() == 0:
                    return True
                if deadline is None:
                    event.wait(timeout=5.0)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    event.wait(timeout=remaining)
                event.clear()
        finally:
            self._pubsub.unsubscribe(self.channel, listener)


class RedisTopic:
    """Pub/sub topic over the server (`RedissonTopic.java`): publish returns
    the receiver count; listeners ride the shared subscribe connection."""

    def __init__(self, name: str, resp, pubsub, codec):
        self.name = name
        self._resp = resp
        self._pubsub = pubsub
        self._codec = codec
        self._listeners: Dict[int, Callable] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def publish(self, message: Any) -> int:
        return int(self._resp.execute(
            "PUBLISH", self.name, self._codec.encode(message)))

    def add_listener(self, listener: Callable[[str, Any], None]) -> int:
        def wrapped(channel: str, raw: bytes):
            listener(channel, self._codec.decode(raw))

        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._listeners[lid] = wrapped
        self._pubsub.subscribe(self.name, wrapped)
        self._pubsub.wait_subscribed(self.name, 5.0)
        return lid

    def remove_listener(self, listener_id: int) -> None:
        with self._lock:
            wrapped = self._listeners.pop(listener_id, None)
        if wrapped is not None:
            self._pubsub.unsubscribe(self.name, wrapped)

    def remove_all_listeners(self) -> None:
        with self._lock:
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for wrapped in listeners:
            self._pubsub.unsubscribe(self.name, wrapped)


class RedisPatternTopic:
    """Pattern topic (`RedissonPatternTopic.java`) via PSUBSCRIBE."""

    def __init__(self, pattern: str, resp, pubsub, codec):
        self.pattern = pattern
        self._pubsub = pubsub
        self._codec = codec
        self._listeners: Dict[int, Callable] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def add_listener(self, listener: Callable[[str, str, Any], None]) -> int:
        def wrapped(channel: str, raw: bytes):
            listener(self.pattern, channel, self._codec.decode(raw))

        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._listeners[lid] = wrapped
        self._pubsub.psubscribe(self.pattern, wrapped)
        self._pubsub.wait_subscribed(self.pattern, 5.0)
        return lid

    def remove_listener(self, listener_id: int) -> None:
        with self._lock:
            wrapped = self._listeners.pop(listener_id, None)
        if wrapped is not None:
            self._pubsub.punsubscribe(self.pattern, wrapped)

    def remove_all_listeners(self) -> None:
        with self._lock:
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for wrapped in listeners:
            self._pubsub.punsubscribe(self.pattern, wrapped)


class RedisMapCache:
    """Map with per-entry TTL over Redis: hash ``name`` + companion timeout
    zset ``redisson__timeout__set__{name}`` scored by the expiry deadline,
    plus an idle zset ``redisson__idle__set__{name}`` scored by the idle
    deadline with the idle durations in ``redisson__idle__ms__{name}`` —
    the reference's RMapCache design (`RedissonMapCache.java:75-87` custom
    EVAL commands; read-side idle refresh per
    `RedissonMapCache.java:501,538-567`; sweeping analogue of
    `EvictionScheduler.java:47-115`).

    Every script takes KEYS = [hash, timeout zset, idle zset, idle-ms
    hash]; an entry is dead when EITHER deadline has passed. Reads refresh
    the idle deadline (that is what distinguishes maxIdle from ttl).

    Expired entries are dropped lazily on access and in bulk by
    :meth:`evict_expired` (call it from a scheduler for parity with the
    reference's client-driven sweeper).
    """

    # The mini-Lua EVAL subset (interop/mini_lua.py) has no function
    # definitions, so the shared is-dead check is spliced inline: it
    # binds `dead` for `key` at time `now`.
    _DEAD = """
    local tscore = redis.call('zscore', KEYS[2], key)
    local iscore = redis.call('zscore', KEYS[3], key)
    local dead = ((tscore ~= false and tonumber(tscore) <= now) or
                  (iscore ~= false and tonumber(iscore) <= now))
    """

    PUT = """
    local now = tonumber(ARGV[4])
    local key = ARGV[1]
    """ + _DEAD + """
    local old = redis.call('hget', KEYS[1], ARGV[1])
    if (old ~= false and dead) then
        old = false
    end
    redis.call('hset', KEYS[1], ARGV[1], ARGV[2])
    if (tonumber(ARGV[3]) > 0) then
        redis.call('zadd', KEYS[2], now + tonumber(ARGV[3]), ARGV[1])
    else
        redis.call('zrem', KEYS[2], ARGV[1])
    end
    if (tonumber(ARGV[5]) > 0) then
        redis.call('zadd', KEYS[3], now + tonumber(ARGV[5]), ARGV[1])
        redis.call('hset', KEYS[4], ARGV[1], ARGV[5])
    else
        redis.call('zrem', KEYS[3], ARGV[1])
        redis.call('hdel', KEYS[4], ARGV[1])
    end
    return old
    """

    PUT_IF_ABSENT = """
    local now = tonumber(ARGV[4])
    local key = ARGV[1]
    """ + _DEAD + """
    local old = redis.call('hget', KEYS[1], ARGV[1])
    if (old ~= false and not dead) then
        return old
    end
    redis.call('hset', KEYS[1], ARGV[1], ARGV[2])
    if (tonumber(ARGV[3]) > 0) then
        redis.call('zadd', KEYS[2], now + tonumber(ARGV[3]), ARGV[1])
    else
        redis.call('zrem', KEYS[2], ARGV[1])
    end
    if (tonumber(ARGV[5]) > 0) then
        redis.call('zadd', KEYS[3], now + tonumber(ARGV[5]), ARGV[1])
        redis.call('hset', KEYS[4], ARGV[1], ARGV[5])
    else
        redis.call('zrem', KEYS[3], ARGV[1])
        redis.call('hdel', KEYS[4], ARGV[1])
    end
    return nil
    """

    GET = """
    local now = tonumber(ARGV[2])
    local key = ARGV[1]
    """ + _DEAD + """
    if (dead) then
        redis.call('hdel', KEYS[1], key)
        redis.call('zrem', KEYS[2], key)
        redis.call('zrem', KEYS[3], key)
        redis.call('hdel', KEYS[4], key)
        return nil
    end
    local idle = redis.call('hget', KEYS[4], key)
    if (idle ~= false) then
        redis.call('zadd', KEYS[3], now + tonumber(idle), key)
    end
    return redis.call('hget', KEYS[1], key)
    """

    REMOVE = """
    local old = redis.call('hget', KEYS[1], ARGV[1])
    redis.call('hdel', KEYS[1], ARGV[1])
    redis.call('zrem', KEYS[2], ARGV[1])
    redis.call('zrem', KEYS[3], ARGV[1])
    redis.call('hdel', KEYS[4], ARGV[1])
    return old
    """

    EVICT = """
    local now = tonumber(ARGV[1])
    local n = 0
    for z = 2, 3 do
        local expired = redis.call('zrangebyscore', KEYS[z], '-inf', now,
                                   'LIMIT', 0, ARGV[2])
        for i, key in ipairs(expired) do
            if (redis.call('hdel', KEYS[1], key) == 1) then
                n = n + 1
            end
            redis.call('zrem', KEYS[2], key)
            redis.call('zrem', KEYS[3], key)
            redis.call('hdel', KEYS[4], key)
        end
    end
    return n
    """

    SIZE = """
    local now = tonumber(ARGV[1])
    local fields = redis.call('hkeys', KEYS[1])
    local live = 0
    for i, key in ipairs(fields) do
    """ + _DEAD + """
        if (not dead) then
            live = live + 1
        end
    end
    return live
    """

    READ_ALL = """
    local now = tonumber(ARGV[1])
    local flat = redis.call('hgetall', KEYS[1])
    local out = {}
    for i = 1, #flat, 2 do
        local key = flat[i]
    """ + _DEAD + """
        if (not dead) then
            out[#out + 1] = flat[i]
            out[#out + 1] = flat[i + 1]
        end
    end
    return out
    """

    def __init__(self, name: str, scripts: ScriptRunner, codec):
        self.name = name
        self._scripts = scripts
        self._codec = codec

    @property
    def timeout_set_name(self) -> str:
        return "redisson__timeout__set__{%s}" % self.name

    @property
    def idle_set_name(self) -> str:
        return "redisson__idle__set__{%s}" % self.name

    @property
    def idle_ms_name(self) -> str:
        return "redisson__idle__ms__{%s}" % self.name

    @property
    def _keys(self) -> list:
        return [self.name, self.timeout_set_name,
                self.idle_set_name, self.idle_ms_name]

    def _k(self, key) -> bytes:
        return self._codec.encode(key)

    def put(self, key, value, ttl_s: float = 0, max_idle_s: float = 0):
        """Returns the previous live value or None. ttl and max_idle are
        independent deadlines (separate zsets); reads refresh only the
        idle one."""
        old = self._scripts.run(
            self.PUT, self._keys,
            [self._k(key), self._codec.encode(value),
             int(ttl_s * 1000) if ttl_s else 0, _now_ms(),
             int(max_idle_s * 1000) if max_idle_s else 0])
        return None if old is None else self._codec.decode(old)

    def put_if_absent(self, key, value, ttl_s: float = 0, max_idle_s: float = 0):
        old = self._scripts.run(
            self.PUT_IF_ABSENT, self._keys,
            [self._k(key), self._codec.encode(value),
             int(ttl_s * 1000) if ttl_s else 0, _now_ms(),
             int(max_idle_s * 1000) if max_idle_s else 0])
        return None if old is None else self._codec.decode(old)

    def fast_put(self, key, value, ttl_s: float = 0, max_idle_s: float = 0) -> bool:
        """Reference fastPut: True iff the key was newly inserted (an
        expired entry counts as absent), False on overwrite."""
        return self.put(key, value, ttl_s, max_idle_s) is None

    def get(self, key):
        raw = self._scripts.run(
            self.GET, self._keys, [self._k(key), _now_ms()])
        return None if raw is None else self._codec.decode(raw)

    def remove(self, key):
        old = self._scripts.run(
            self.REMOVE, self._keys, [self._k(key)])
        return None if old is None else self._codec.decode(old)

    def contains_key(self, key) -> bool:
        return self.get(key) is not None

    def size(self) -> int:
        return int(self._scripts.run(self.SIZE, self._keys, [_now_ms()]))

    def read_all_map(self) -> dict:
        """Reference readAllMap: every live entry, expired ones skipped
        (without touching their idle clocks)."""
        flat = self._scripts.run(self.READ_ALL, self._keys, [_now_ms()])
        it = iter(flat or [])
        return {
            self._codec.decode(k): self._codec.decode(v)
            for k, v in zip(it, it)
        }

    def evict_expired(self, limit: int = 300) -> int:
        """One sweeper pass, <=limit entries (EvictionScheduler's batch cap,
        `EvictionScheduler.java:47-115`)."""
        return int(self._scripts.run(
            self.EVICT, self._keys, [_now_ms(), limit]))

    def delete(self) -> bool:
        n = self._scripts.resp.execute(
            "DEL", self.name, self.timeout_set_name,
            self.idle_set_name, self.idle_ms_name)
        return bool(n)

    def clear(self) -> None:
        self.delete()


class RedisScript:
    """RScript over the wire (`RedissonScript.java`): script load + eval."""

    def __init__(self, resp, codec):
        self._resp = resp
        self._codec = codec

    def script_load(self, script: str) -> str:
        sha = self._resp.execute("SCRIPT", "LOAD", script)
        return sha.decode() if isinstance(sha, bytes) else sha

    def script_exists(self, *shas: str):
        return [bool(v) for v in self._resp.execute("SCRIPT", "EXISTS", *shas)]

    def eval(self, script: str, keys=(), args=()) -> Any:
        return self._resp.execute(
            "EVAL", script, str(len(tuple(keys))), *keys, *args)

    def eval_sha(self, sha: str, keys=(), args=()) -> Any:
        return self._resp.execute(
            "EVALSHA", sha, str(len(tuple(keys))), *keys, *args)
