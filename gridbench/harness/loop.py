"""A closed loop of client threads: each keeps `depth` calls outstanding,
and sends the next only when its oldest one has completed.

The loop runs without pause from the warm-up through the measured window
to the drain. The window is two marks on the clock: a call counts in it
when it completes between them; calls are submitted until the second mark
and every outstanding one is then waited for (its answer is still
judged). A call's latency runs from its submission to its completion; for
a call that returns a `Future`, completion is the moment its result is
set, not the moment the client gets round to reading it.

A `side` task (a writer at a fixed rate, say) runs in a thread of its own
from the loop's start until the second mark, and is waited for with the
clients.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


@dataclass
class Call:
    client: int
    seq: int
    t_submit: float
    units: int  # the work's own count (keys, queries)
    info: Any = None
    t_done: float = 0.0
    result: Any = None
    error: Optional[BaseException] = None


@dataclass
class LoopResult:
    calls: List[Call] = field(default_factory=list)
    t0: float = 0.0  # window start (perf_counter)
    t1: float = 0.0  # window end

    def in_window(self) -> List[Call]:
        return [c for c in self.calls if self.t0 <= c.t_done <= self.t1]

    def submitted_in(self, lo: float, hi: float) -> List[Call]:
        return [c for c in self.calls if lo <= c.t_submit <= hi]


def _stamp(call: Call) -> Callable[[Future], None]:
    def done(_fut: Future) -> None:
        call.t_done = time.perf_counter()
    return done


def run(clients: int, depth: int, start: Callable[[int, int], tuple],
        warm_s: float, seconds: float,
        at_start: Optional[Callable[[], None]] = None,
        after_drain: Optional[Callable[[], None]] = None,
        side: Optional[Callable[[threading.Event], None]] = None) -> LoopResult:
    """Drive `clients` threads. `start(client, seq)` begins one call and
    returns (handle, units, info): the handle is a `Future` or the call's
    answer already. `at_start` runs at the window's first mark,
    `after_drain` once every call has completed; `side(stop)` runs until
    `stop` is set."""
    out = LoopResult()
    stop = threading.Event()
    lock = threading.Lock()
    errors: List[BaseException] = []

    def client(c: int) -> None:
        pending: deque = deque()
        seq = 0
        mine: List[Call] = []
        try:
            while True:
                while not stop.is_set() and len(pending) < depth:
                    t = time.perf_counter()
                    handle, units, info = start(c, seq)
                    call = Call(c, seq, t, units, info)
                    seq += 1
                    if isinstance(handle, Future):
                        handle.add_done_callback(_stamp(call))
                    else:
                        call.t_done = time.perf_counter()
                        call.result = handle
                    pending.append((call, handle))
                    mine.append(call)
                if not pending:
                    break
                call, handle = pending.popleft()
                if isinstance(handle, Future):
                    try:
                        call.result = handle.result()
                    except Exception as exc:  # noqa: BLE001 - counted as failed
                        call.error = exc
                    if not call.t_done:
                        call.t_done = time.perf_counter()
        except BaseException as exc:  # noqa: BLE001 - re-raised by run()
            errors.append(exc)
            stop.set()
        with lock:
            out.calls.extend(mine)

    def side_task() -> None:
        try:
            side(stop)
        except BaseException as exc:  # noqa: BLE001 - re-raised by run()
            errors.append(exc)
            stop.set()

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"gridbench-client-{c}")
               for c in range(clients)]
    if side is not None:
        threads.append(threading.Thread(target=side_task, daemon=True,
                                        name="gridbench-side"))
    for t in threads:
        t.start()
    time.sleep(warm_s)
    if at_start is not None:
        at_start()
    out.t0 = time.perf_counter()
    time.sleep(seconds)
    out.t1 = time.perf_counter()
    stop.set()
    for t in threads:
        t.join()
    if after_drain is not None:
        after_drain()
    if errors:
        raise errors[0]
    out.calls.sort(key=lambda c: (c.client, c.seq))
    return out


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile by nearest rank (None for no values)."""
    if not values:
        return None
    vals = sorted(values)
    k = max(0, -(-95 * len(vals) // 100) - 1)
    return vals[k]
