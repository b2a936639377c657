"""RQueue / RDeque / RBlockingQueue / RBlockingDeque.

Reference: `RedissonQueue.java` (LPUSH/RPOP family), `RedissonDeque.java`,
`RedissonBlockingQueue.java` — blocking pops ride the L2 no-timeout path
(`CommandAsyncService.java:491-497`); here they ride the engine's waiter
protocol (park a future, fulfilled by the push that satisfies it; timeouts
resolved by a `bpop_cancel` op so the race is serialized on the dispatcher).
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Iterable, List, Optional

from redisson_tpu_torch.models.collections import RList


class RQueue(RList):
    """FIFO over the list type (offer=RPUSH, poll=LPOP)."""

    def offer(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "rpush", {"values": [self._e(value)]}) > 0

    def offer_async(self, value: Any):
        return self._executor.execute_async(self.name, "rpush", {"values": [self._e(value)]})

    def poll(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lpop", None))

    def peek(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": 0}))

    def poll_last_and_offer_first_to(self, dest: str) -> Any:
        """RPOPLPUSH."""
        return self._d(self._executor.execute_sync(self.name, "rpoplpush", {"dst": dest}))


class RDeque(RQueue):
    def add_first(self, value: Any) -> None:
        self._executor.execute_sync(self.name, "lpush", {"values": [self._e(value)]})

    def add_last(self, value: Any) -> None:
        self._executor.execute_sync(self.name, "rpush", {"values": [self._e(value)]})

    def offer_first(self, value: Any) -> bool:
        return self._executor.execute_sync(self.name, "lpush", {"values": [self._e(value)]}) > 0

    def offer_last(self, value: Any) -> bool:
        return self.offer(value)

    def poll_first(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lpop", None))

    def poll_last(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "rpop", None))

    def peek_first(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": 0}))

    def peek_last(self) -> Any:
        return self._d(self._executor.execute_sync(self.name, "lindex", {"index": -1}))

    def pop(self) -> Any:
        return self.poll_first()

    def push(self, value: Any) -> None:
        self.add_first(value)

    # -- java Deque surface (RDequeAsync.java declares the async twins) -----

    def remove_first(self) -> Any:
        """Pop head; raises IndexError when empty (java removeFirst)."""
        v = self.poll_first()
        if v is None:
            raise IndexError("remove_first from an empty deque")
        return v

    def remove_last(self) -> Any:
        v = self.poll_last()
        if v is None:
            raise IndexError("remove_last from an empty deque")
        return v

    def get_last(self) -> Any:
        """Peek tail; raises IndexError when empty (java getLast)."""
        v = self.peek_last()
        if v is None:
            raise IndexError("get_last from an empty deque")
        return v

    def remove_first_occurrence(self, value: Any) -> bool:
        """LREM count=1 head-side (java removeFirstOccurrence)."""
        return self._executor.execute_sync(
            self.name, "lrem", {"value": self._e(value), "count": 1}) > 0

    def remove_last_occurrence(self, value: Any) -> bool:
        """LREM count=-1 tail-side (java removeLastOccurrence)."""
        return self._executor.execute_sync(
            self.name, "lrem", {"value": self._e(value), "count": -1}) > 0


class RBlockingQueue(RQueue):
    """take()/poll(timeout) parity with `RedissonBlockingQueue.java`."""

    def _blocking_pop(self, timeout_s: Optional[float], side: str, dest: Optional[str] = None):
        # timeout_s rides along for backends that push the wait server-side
        # (redis BLPOP timeout); the engine backend parks a waiter and
        # ignores it.
        payload = {"side": side, "timeout_s": timeout_s}
        if dest is not None:
            payload["dest"] = dest
        f = self._executor.execute_async(self.name, "bpop", payload)
        try:
            raw = f.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            # Serialize the cancel/fulfill race on the dispatcher: the cancel
            # op reads the waiter id the bpop handler wrote into the shared
            # payload. If a push won the race, the future already has the
            # value and the cancel is a no-op.
            self._executor.execute_sync(self.name, "bpop_cancel", {"ref": payload})
            raw = f.result(timeout=0) if f.done() else None
        return self._d(raw)

    def take(self) -> Any:
        """Block until an element arrives (BLPOP with no timeout)."""
        return self._blocking_pop(None, "left")

    def poll(self, timeout_s: Optional[float] = None) -> Any:
        if timeout_s is None:
            return super().poll()
        return self._blocking_pop(timeout_s, "left")

    def poll_last_and_offer_first_to(self, dest: str, timeout_s: Optional[float] = None) -> Any:
        """BRPOPLPUSH / RPOPLPUSH."""
        if timeout_s is None:
            return super().poll_last_and_offer_first_to(dest)
        return self._blocking_pop(timeout_s, "right", dest=dest)

    def put(self, value: Any) -> None:
        self.offer(value)

    def drain_to(self, collection: List[Any], max_elements: Optional[int] = None) -> int:
        n = 0
        while max_elements is None or n < max_elements:
            v = super().poll()
            if v is None:
                break
            collection.append(v)
            n += 1
        return n

    def _poll_from_any(self, timeout_s: Optional[float], side: str,
                       names: tuple):
        """Reference pollFromAny (multi-key BLPOP): round-robin the queues
        — an immediate pop wins; otherwise short blocking slices rotate
        across the keys until the deadline. (The reference's server-side
        BLPOP watches all keys in one command; the rotation reaches the
        same outcome with a bounded wake-up latency per slice.)"""
        import time as _time

        queues = [self.name, *names]
        # BLPOP rule: timeout 0 (or None) blocks indefinitely.
        deadline = None if not timeout_s else _time.monotonic() + timeout_s
        slice_s = 0.05
        first_sweep = True
        while True:
            for i, q in enumerate(queues):
                remaining = None if deadline is None else max(
                    0.0, deadline - _time.monotonic())
                # Always finish one full non-blocking sweep before giving
                # up, so an already-available element is returned even at a
                # zero/elapsed deadline.
                if (remaining is not None and remaining <= 0
                        and not first_sweep):
                    return None, None
                # Block briefly only on the last queue of the rotation so a
                # quiet system still parks instead of spinning.
                wait = slice_s if i == len(queues) - 1 else 0
                if wait and remaining is not None:
                    wait = min(wait, remaining) or 0
                other = RBlockingQueue(q, self._executor, self._codec)
                v = (other._blocking_pop(wait, side) if wait
                     else other._executor.execute_sync(
                         q, "lpop" if side == "left" else "rpop", None))
                if v is not None:
                    return (other._d(v) if not wait else v), q
                if (first_sweep and i == len(queues) - 1
                        and deadline is not None
                        and deadline - _time.monotonic() <= 0):
                    return None, None
            first_sweep = False

    def poll_from_any(self, timeout_s: Optional[float] = None,
                      *queue_names: str) -> Any:
        """First element from this queue or any of `queue_names`
        (reference pollFromAny, BLPOP key1..keyN)."""
        v, _ = self._poll_from_any(timeout_s, "left", queue_names)
        return v


class RBlockingDeque(RBlockingQueue, RDeque):
    def take_first(self) -> Any:
        return self._blocking_pop(None, "left")

    def take_last(self) -> Any:
        return self._blocking_pop(None, "right")

    def poll_first(self, timeout_s: Optional[float] = None) -> Any:
        if timeout_s is None:
            return RDeque.poll_first(self)
        return self._blocking_pop(timeout_s, "left")

    def poll_last(self, timeout_s: Optional[float] = None) -> Any:
        if timeout_s is None:
            return RDeque.poll_last(self)
        return self._blocking_pop(timeout_s, "right")

    def put_first(self, value: Any) -> None:
        """Head insert (java BlockingDeque putFirst; capacity is unbounded
        here, so it never blocks — same as the reference on Redis lists)."""
        self.add_first(value)

    def put_last(self, value: Any) -> None:
        self.add_last(value)

    def poll_first_from_any(self, timeout_s: Optional[float] = None,
                            *queue_names: str) -> Any:
        v, _ = self._poll_from_any(timeout_s, "left", queue_names)
        return v

    def poll_last_from_any(self, timeout_s: Optional[float] = None,
                           *queue_names: str) -> Any:
        v, _ = self._poll_from_any(timeout_s, "right", queue_names)
        return v
