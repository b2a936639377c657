"""Coordination objects: RLock / RFairLock / RReadWriteLock / RMultiLock /
RSemaphore / RCountDownLatch.

Reference mechanics preserved:
  * lock = CAS on owner `uuid:threadId` with reentrancy count
    (`RedissonLock.java:236-252` Lua -> the engine's `lock_try` op);
  * waiters block on a pub/sub latch, not polling (`RedissonLock.java:
    107-142`, woken by the unlock publish `:324-343`);
  * watchdog auto-renews a 30 s lease every lease/3 while held
    (`RedissonLock.java:59-61, 197-227`) so a dead client can't orphan a
    lock;
  * RMultiLock = lock-all-or-release-all across independent locks
    (`core/RedissonMultiLock.java`, RedLock-style);
  * semaphore / countdownlatch = engine counters + publish wake-up
    (`RedissonSemaphore.java`, `RedissonCountDownLatch.java`).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from redisson_tpu_torch.structures.extended import (
    LATCH_CHANNEL_PREFIX,
    LATCH_ZERO_MESSAGE,
    LOCK_CHANNEL_PREFIX,
    SEMAPHORE_CHANNEL_PREFIX,
)

DEFAULT_LEASE_S = 30.0  # lockWatchdogTimeout (RedissonLock.java:59-61)

# Per-context lock-owner override (see RLock._owner). contextvars propagate
# through asyncio.to_thread, so an async task's identity survives the hop
# onto a worker thread.
import contextvars

_OWNER_CTX: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "rtpu_lock_owner", default=None)


class owner_context:
    """Context manager pinning the lock-owner context id (async tasks)."""

    def __init__(self, context_id: str):
        self._id = context_id
        self._token = None

    def __enter__(self):
        self._token = _OWNER_CTX.set(self._id)
        return self

    def __exit__(self, *exc):
        _OWNER_CTX.reset(self._token)


class LockWatchdog:
    """Client-side lease renewal (expirationRenewalMap analogue).

    One daemon timer loop renews every registered (lock, owner) every
    lease/3 via the `lock_renew` op; entries drop on unlock or when the
    renewal finds the lock no longer held.
    """

    def __init__(self, executor, lease_s: float = DEFAULT_LEASE_S):
        self._executor = executor
        self.lease_s = lease_s
        self._entries: Dict[Tuple[str, str], bool] = {}
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._renewing: Optional[Tuple[str, str]] = None  # renewal in flight

    def register(self, name: str, owner: str) -> None:
        with self._cv:
            self._entries[(name, owner)] = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="redisson-torch-lock-watchdog", daemon=True
                )
                self._thread.start()
            self._cv.notify()

    def unregister(self, name: str, owner: str) -> None:
        """Drop the entry; if its renewal is in flight, wait for it to land,
        so no renewal of the entry follows the return."""
        key = (name, owner)
        with self._cv:
            self._entries.pop(key, None)
            while self._renewing == key:
                self._cv.wait()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def _loop(self):
        while True:
            with self._cv:
                if self._shutdown:
                    return
                self._cv.wait(timeout=self.lease_s / 3)
                if self._shutdown:
                    return
                entries = list(self._entries)
            for key in entries:
                with self._cv:
                    if key not in self._entries:  # unregistered since
                        continue
                    self._renewing = key
                try:
                    ok = self._executor.execute_sync(
                        key[0], "lock_renew", {"owner": key[1], "lease_ms": int(self.lease_s * 1000)}
                    )
                except Exception:
                    ok = False
                with self._cv:
                    self._renewing = None
                    if not ok:
                        self._entries.pop(key, None)
                    self._cv.notify_all()


class RLock:
    """Reentrant distributed lock (mode='write'); also the base for read/write
    handles and the fair lock."""

    _MODE = "write"
    _FAIR = False

    def __init__(self, name: str, executor, pubsub, client_id: str, watchdog: LockWatchdog):
        self.name = name
        self._executor = executor
        self._pubsub = pubsub
        self._client_id = client_id
        self._watchdog = watchdog

    def _owner(self) -> str:
        """Lock owner identity: client uuid + execution-context id.

        Default context id is the OS thread (the reference's uuid:threadId).
        Async callers override it per logical task via `owner_context` —
        the analogue of the reference passing an explicit threadId into
        lockAsync/unlockAsync — so mutual exclusion holds between asyncio
        tasks regardless of which worker thread runs the call."""
        override = _OWNER_CTX.get()
        ctx = override if override is not None else threading.get_ident()
        return f"{self._client_id}:{ctx}"

    def _try_once(
        self,
        lease_s: Optional[float],
        enqueue: bool = False,
        wait_s: Optional[float] = None,
    ) -> Optional[int]:
        """None = acquired, else remaining ttl ms (Lua contract).

        enqueue registers this owner as a fair-queue waiter (with a TTL of
        the wait budget + slack so an abandoned waiter never wedges the
        queue)."""
        effective = DEFAULT_LEASE_S if lease_s is None else lease_s
        if lease_s is not None:
            # An explicit lease is never renewed. A registration left by an
            # earlier hold of this name and owner (the key flushed or
            # force-unlocked before the watchdog noticed) would otherwise
            # stretch this lease to the watchdog's 30 s: drop it before the
            # lease is set, so no renewal can land after it.
            self._watchdog.unregister(self.name, self._owner())
        ttl = self._executor.execute_sync(
            self.name,
            "lock_try",
            {
                "owner": self._owner(),
                "lease_ms": int(effective * 1000),
                "mode": self._MODE,
                "fair": self._FAIR,
                "enqueue": enqueue,
                "wait_ms": None if wait_s is None else int(wait_s * 1000),
            },
        )
        if ttl is None and lease_s is None:
            self._watchdog.register(self.name, self._owner())
        return ttl

    def try_lock(
        self, wait_time_s: Optional[float] = None, lease_time_s: Optional[float] = None
    ) -> bool:
        """tryLock(waitTime, leaseTime): spin on the pub/sub latch until
        acquired or the wait budget runs out (`RedissonLock.java:107-142`)."""
        return self._try_lock(wait_time_s, lease_time_s, dequeue_on_timeout=True)

    def _try_lock(
        self,
        wait_time_s: Optional[float],
        lease_time_s: Optional[float],
        dequeue_on_timeout: bool,
    ) -> bool:
        will_wait = bool(wait_time_s)
        ttl = self._try_once(lease_time_s, enqueue=will_wait, wait_s=wait_time_s)
        if ttl is None:
            return True
        if not will_wait:
            return False
        deadline = time.monotonic() + wait_time_s
        event = threading.Event()
        lid = self._pubsub.subscribe(LOCK_CHANNEL_PREFIX + self.name, lambda ch, msg: event.set())
        try:
            # Retry at loop head: an unlock published between the probe above
            # and the subscribe would otherwise be a missed wakeup (the
            # reference re-tries right after subscription too).
            while True:
                remaining = deadline - time.monotonic()
                ttl = self._try_once(lease_time_s, enqueue=True, wait_s=max(remaining, 0))
                if ttl is None:
                    return True
                if remaining <= 0:
                    if self._FAIR and dequeue_on_timeout:  # give up our slot
                        self._executor.execute_sync(
                            self.name, "lock_queue_remove", {"owner": self._owner()}
                        )
                    return False
                wait_for = remaining if ttl < 0 else min(remaining, ttl / 1000)
                event.wait(timeout=wait_for)
                event.clear()
        finally:
            self._pubsub.unsubscribe(LOCK_CHANNEL_PREFIX + self.name, lid)

    def lock(self, lease_time_s: Optional[float] = None) -> None:
        """Block until acquired (lockInterruptibly analogue). Fair locks keep
        their queue slot across retry rounds (the engine-side entry TTL is
        refreshed by each retry), so FIFO position is never forfeited."""
        while not self._try_lock(5.0, lease_time_s, dequeue_on_timeout=False):
            pass

    def unlock(self) -> None:
        res = self._executor.execute_sync(
            self.name, "lock_unlock", {"owner": self._owner(), "mode": self._MODE}
        )
        if res is None:
            raise RuntimeError(
                f"attempt to unlock '{self.name}' not locked by current thread "
                f"(owner {self._owner()})"
            )
        if res is True:
            self._watchdog.unregister(self.name, self._owner())

    def force_unlock(self) -> bool:
        return self._executor.execute_sync(self.name, "lock_force_unlock", None)

    def is_locked(self) -> bool:
        locked, _, _ = self._executor.execute_sync(self.name, "lock_state", {})
        return locked

    def is_held_by_current_thread(self) -> bool:
        _, count, _ = self._executor.execute_sync(
            self.name, "lock_state", {"owner": self._owner()}
        )
        return count > 0

    def get_hold_count(self) -> int:
        _, count, _ = self._executor.execute_sync(
            self.name, "lock_state", {"owner": self._owner()}
        )
        return count

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class RFairLock(RLock):
    """FIFO-fair lock: waiters queue in the engine (`RedissonFairLock.java`'s
    Lua thread queue)."""

    _FAIR = True


class _ReadLock(RLock):
    _MODE = "read"


class RReadWriteLock:
    """Reference `RedissonReadWriteLock.java`: shared mode field — many
    readers or one writer; write-holder may re-enter for read."""

    def __init__(self, name: str, executor, pubsub, client_id: str, watchdog: LockWatchdog):
        self.name = name
        self._read = _ReadLock(name, executor, pubsub, client_id, watchdog)
        self._write = RLock(name, executor, pubsub, client_id, watchdog)

    def read_lock(self) -> RLock:
        return self._read

    def write_lock(self) -> RLock:
        return self._write


class RMultiLock:
    """Lock-all-or-release-all over independent locks (RedLock pattern,
    `core/RedissonMultiLock.java`)."""

    def __init__(self, *locks: RLock):
        if not locks:
            raise ValueError("at least one lock required")
        self.locks: List[RLock] = list(locks)

    def try_lock(
        self, wait_time_s: Optional[float] = None, lease_time_s: Optional[float] = None
    ) -> bool:
        per_lock_wait = None if wait_time_s is None else wait_time_s / len(self.locks)
        acquired: List[RLock] = []
        for lk in self.locks:
            ok = False
            try:
                ok = lk.try_lock(wait_time_s=per_lock_wait, lease_time_s=lease_time_s)
            finally:
                if ok:
                    acquired.append(lk)
                else:
                    for a in acquired:
                        try:
                            a.unlock()
                        except Exception:
                            pass
            if not ok:
                return False
        return True

    def lock(self, lease_time_s: Optional[float] = None) -> None:
        while not self.try_lock(wait_time_s=10.0, lease_time_s=lease_time_s):
            pass

    def unlock(self) -> None:
        for lk in self.locks:
            try:
                lk.unlock()
            except Exception:
                pass

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class RSemaphore:
    def __init__(self, name: str, executor, pubsub):
        self.name = name
        self._executor = executor
        self._pubsub = pubsub

    def try_set_permits(self, permits: int) -> bool:
        return self._executor.execute_sync(self.name, "sem_try_set_permits", {"permits": permits})

    def try_acquire(self, permits: int = 1, timeout_s: Optional[float] = None) -> bool:
        ok = self._executor.execute_sync(self.name, "sem_try_acquire", {"permits": permits})
        if ok or not timeout_s:
            return ok
        deadline = time.monotonic() + timeout_s
        event = threading.Event()
        lid = self._pubsub.subscribe(
            SEMAPHORE_CHANNEL_PREFIX + self.name, lambda ch, msg: event.set()
        )
        try:
            # Retry at loop head: a release published between the probe and
            # the subscribe must not become a missed wakeup.
            while True:
                if self._executor.execute_sync(
                    self.name, "sem_try_acquire", {"permits": permits}
                ):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                event.wait(timeout=remaining)
                event.clear()
        finally:
            self._pubsub.unsubscribe(SEMAPHORE_CHANNEL_PREFIX + self.name, lid)

    def acquire(self, permits: int = 1) -> None:
        while not self.try_acquire(permits, timeout_s=5.0):
            pass

    def release(self, permits: int = 1) -> None:
        self._executor.execute_sync(self.name, "sem_release", {"permits": permits})

    def available_permits(self) -> int:
        return self._executor.execute_sync(self.name, "sem_available", None)

    def drain_permits(self) -> int:
        return self._executor.execute_sync(self.name, "sem_drain", None)

    def set_permits(self, permits: int) -> None:
        """Force the permit count (reference setPermits — unlike
        try_set_permits this overwrites unconditionally). One atomic op on
        the dispatcher: concurrent acquire/release cannot interleave."""
        self._executor.execute_sync(
            self.name, "sem_set_permits", {"permits": int(permits)})

    def add_permits(self, permits: int) -> None:
        self._executor.execute_sync(self.name, "sem_add_permits", {"permits": permits})

    def reduce_permits(self, permits: int) -> None:
        self.add_permits(-permits)


class RCountDownLatch:
    def __init__(self, name: str, executor, pubsub):
        self.name = name
        self._executor = executor
        self._pubsub = pubsub

    def try_set_count(self, count: int) -> bool:
        return self._executor.execute_sync(self.name, "latch_try_set", {"count": count})

    def count_down(self) -> None:
        self._executor.execute_sync(self.name, "latch_count_down", None)

    def get_count(self) -> int:
        return self._executor.execute_sync(self.name, "latch_get", None)

    def delete(self) -> bool:
        """Drop the latch; True if it existed (reference deleteAsync,
        RedissonCountDownLatchTest.java:120-131). Waiters wake — a deleted
        latch reads count 0."""
        existed = bool(self._executor.execute_sync(self.name, "delete", None))
        if existed:
            self._pubsub.publish(LATCH_CHANNEL_PREFIX + self.name, b"0")
        return existed

    def await_(self, timeout_s: Optional[float] = None) -> bool:
        """Block until count hits zero; True if it did within the timeout."""
        if self.get_count() == 0:
            return True
        event = threading.Event()
        lid = self._pubsub.subscribe(
            LATCH_CHANNEL_PREFIX + self.name, lambda ch, msg: event.set()
        )
        try:
            deadline = None if timeout_s is None else time.monotonic() + timeout_s
            while True:
                if self.get_count() == 0:
                    return True
                wait_for = 5.0
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    wait_for = min(wait_for, remaining)
                event.wait(timeout=wait_for)
                event.clear()
        finally:
            self._pubsub.unsubscribe(LATCH_CHANNEL_PREFIX + self.name, lid)


def new_client_id() -> str:
    return uuid.uuid4().hex
