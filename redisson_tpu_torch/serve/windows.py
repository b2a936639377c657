"""Per-connection inflight windows + strict reply-order accounting
(counterpart of `redisson_tpu.serve.windows`).

The wire front-end's engine-side dual of the reference's per-connection
``CommandsQueue.java``: every command a connection submits reserves a
*reply slot* in arrival order; results land on slots in whatever order the
engine retires them (futures resolve out of order across a coalesced
multi-connection window), and ``drain()`` releases only the maximal
*completed prefix* — so bytes go back on the socket in exactly the order
the commands came off it, no matter how the batch was scheduled.

The window is also the connection's shed point: ``try_reserve`` refuses
past ``max_inflight`` and the caller renders the refusal as a ``-BUSY``
frame (RejectedError semantics) without ever touching admission.

Thread model: slots are reserved on the wire event loop only, so the
reply sequence (``_next_seq``) is dense in socket arrival order;
completions may arrive from executor/completer threads (future
done-callbacks), so the deque is lock-guarded. ``drain()`` is called from
the event loop only. Pure Python: no torch, no executor.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, List, Optional, Tuple


class ReplySlot:
    """One command's place in the reply order."""

    __slots__ = ("seq", "data", "done")

    def __init__(self, seq: int):
        self.seq = seq
        self.data: Optional[bytes] = None
        self.done = False


class ConnectionWindow:
    """Ordered reply slots + inflight cap for ONE connection."""

    def __init__(self, max_inflight: int = 128):
        self.max_inflight = max(1, int(max_inflight))
        self._lock = threading.Lock()
        self._slots: Deque[ReplySlot] = collections.deque()
        self._inflight = 0
        self._next_seq = 0
        self.completed = 0
        self.shed = 0
        self.peak_inflight = 0

    # -- submission side (event loop) ---------------------------------------

    def _append_locked(self, slot: ReplySlot) -> ReplySlot:
        self._next_seq += 1
        self._slots.append(slot)
        self._inflight += 1
        if self._inflight > self.peak_inflight:
            self.peak_inflight = self._inflight
        return slot

    def try_reserve(self) -> Optional[ReplySlot]:
        """Reserve the next reply slot, or None when the connection is at
        its inflight cap (the caller sheds with -BUSY; the refused command
        consumes NO slot, so the reply order stays dense)."""
        with self._lock:
            if self._inflight >= self.max_inflight:
                self.shed += 1
                return None
            return self._append_locked(ReplySlot(self._next_seq))

    def reserve_immediate(self, data: bytes) -> ReplySlot:
        """Reserve + complete in one step (inline commands like PING that
        resolve on the event loop): keeps them ordered BEHIND any engine
        commands already in flight on this connection."""
        with self._lock:
            slot = ReplySlot(self._next_seq)
            slot.data = data
            slot.done = True
            return self._append_locked(slot)

    # -- completion side (any thread) ---------------------------------------

    def complete(self, slot: ReplySlot, data: bytes) -> None:
        """Attach the rendered reply; idempotent (a fault-injected double
        completion must not corrupt the order accounting)."""
        with self._lock:
            if slot.done:
                return
            slot.data = data
            slot.done = True

    # -- drain side (event loop) --------------------------------------------

    def drain(self) -> List[bytes]:
        """Pop the completed prefix, in submission order. A slot whose
        command is still in flight blocks everything behind it — replies
        can never be misattributed to an earlier command."""
        out: List[bytes] = []
        with self._lock:
            while self._slots and self._slots[0].done:
                slot = self._slots.popleft()
                out.append(slot.data or b"")
                self._inflight -= 1
                self.completed += 1
        return out

    # -- introspection -------------------------------------------------------

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def pending(self) -> int:
        """Slots still awaiting their result (a completed slot not yet
        drained is not pending)."""
        with self._lock:
            return sum(1 for s in self._slots if not s.done)

    def stats(self) -> Tuple[int, int, int, int]:
        """(inflight, completed, shed, peak_inflight) snapshot."""
        with self._lock:
            return (self._inflight, self.completed, self.shed,
                    self.peak_inflight)
