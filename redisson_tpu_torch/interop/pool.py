"""Connection pool for the redis tier: min-idle fill, failure freeze,
ping re-probe, and a dedicated-connection path for blocking commands
(counterpart of `redisson_tpu.interop.pool`).

The reference's pool machinery, re-derived for asyncio:

  * eager ``minimumIdleSize`` fill at startup —
    `connection/pool/ConnectionPool.java:73-130`;
  * acquire = round-robin over live connections for ordinary commands
    (RESP2 pipelining means a connection serves many in-flight commands,
    so ordinary traffic multiplexes instead of checking out), but an
    EXCLUSIVE checkout for blocking commands so a parked BLPOP never
    stalls anyone else's replies — the reference gives blocking commands
    their own timeoutless handling (`command/CommandAsyncService.java:
    491-497, 514-577`);
  * failure counting -> endpoint freeze after ``failed_attempts``
    consecutive connect failures (`ConnectionPool.java:184-186, 283-295`),
    then a background re-probe loop: dial -> AUTH -> PING -> unfreeze +
    refill (`ConnectionPool.java:297-386`);
  * connect/disconnect listener fan-out (`connection/ConnectionEventsHub.java`).

All connections live on ONE private event-loop thread (the netty
event-loop-group analogue); the public surface is blocking.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, List, Optional, Sequence

from redisson_tpu_torch.interop.resp_client import ConnectionClosed, RespClient


# graftlint Tier D (G017): every key below is owned by the pool's private
# event-loop thread — mutations must come from coroutine/callback context
# on that loop; the blocking facade marshals through
# run_coroutine_threadsafe/call_soon_threadsafe. The var-based
# `_pool.*` keys cover the RespConnectionPool facade's reach-ins.
LOOP_CONFINED = {
    "_AsyncPool._conns": "live-connection list",
    "_AsyncPool._listeners": "connect/disconnect listener fan-out list",
    "_AsyncPool._failures": "consecutive connect-failure counter",
    "_AsyncPool._frozen": "endpoint freeze latch",
    "_AsyncPool._probe_task": "re-probe loop task ref",
    "_AsyncPool._reaper_task": "idle-reaper loop task ref",
    "_AsyncPool._bg_tasks": "held refs for fire-and-forget closes",
    "_AsyncPool._closed": "pool shutdown latch",
    "_AsyncPool._last_used": "idle-reap bookkeeping",
    "_pool._listeners": "facade view of the listener list",
    "_pool._conns": "facade view of the connection list",
}


class EndpointFrozen(ConnectionError):
    """The endpoint accumulated failed_attempts connect failures and is
    frozen; the re-probe loop will unfreeze it when PING succeeds."""


class _AsyncPool:
    def __init__(self, host: str, port: int, *, password=None, db=0,
                 timeout=3.0, retry_attempts=3, retry_interval=1.0,
                 size=4, min_idle=1, failed_attempts=3,
                 reconnection_timeout=3.0, idle_timeout=10.0):
        self.host = host
        self.port = port
        self._mk = lambda: RespClient(
            host=host, port=port, password=password, db=db, timeout=timeout,
            retry_attempts=retry_attempts, retry_interval=retry_interval)
        self.size = max(size, 1)
        self.min_idle = min(max(min_idle, 1), self.size)
        self.failed_attempts = failed_attempts
        self.reconnection_timeout = reconnection_timeout
        self.timeout = timeout
        self._conns: List[RespClient] = []
        self._rr = itertools.count()
        self._failures = 0
        self._frozen = False
        self._probe_task: Optional[asyncio.Task] = None
        self._closed = False
        self._lock = asyncio.Lock()
        self._listeners: List[Callable[[str], None]] = []
        self.freezes = 0  # observability
        self.idle_timeout = idle_timeout
        self.reaped = 0  # observability: idle connections retired
        self._reaper_task: Optional[asyncio.Task] = None
        self._last_used: dict = {}  # id(conn) -> monotonic seconds
        # Strong refs for fire-and-forget close() tasks: the loop keeps
        # only a weak reference to a task, so without these the GC can
        # collect a close mid-flight and leak the socket (graftlint G016).
        self._bg_tasks: set = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Eager min-idle fill (initConnections semantics): fail startup if
        not even one connection dials."""
        errors = []
        for _ in range(self.min_idle):
            try:
                await self._dial_one()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        if not self._conns:
            raise errors[0] if errors else ConnectionClosed("no connections")
        self._reaper_task = asyncio.ensure_future(self._reap_loop())

    async def _reap_loop(self) -> None:
        """Close connections idle past `idle_timeout`, keeping `min_idle`
        alive (`connection/IdleConnectionWatcher.java:42-60`)."""
        import time as _time

        period = max(self.idle_timeout / 2, 0.05)
        while not self._closed:
            await asyncio.sleep(period)
            async with self._lock:
                live = [c for c in self._conns if c.connected]
                if len(live) <= self.min_idle:
                    continue
                now = _time.monotonic()
                for conn in live:
                    if len([c for c in self._conns if c.connected]) <= self.min_idle:
                        break
                    if getattr(conn, "_pending", None):
                        continue  # never close under an in-flight command
                    last = self._last_used.get(id(conn))
                    if last is not None and now - last > self.idle_timeout:
                        self._conns.remove(conn)
                        self._last_used.pop(id(conn), None)
                        self.reaped += 1
                        self._close_later(conn)

    def _touch(self, conn: RespClient) -> None:
        import time as _time

        self._last_used[id(conn)] = _time.monotonic()

    def _close_later(self, conn: RespClient) -> None:
        """Fire-and-forget close with a held reference (G016 fix)."""
        task = asyncio.ensure_future(conn.close())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _dial_one(self, register: bool = True) -> RespClient:
        """Dial a fresh connection; register=False keeps it OUT of the
        shared rotation (exclusive checkout for blocking commands)."""
        conn = self._mk()
        try:
            await conn.connect()
        except Exception:
            await conn.close()
            self._note_failure()
            raise
        self._note_success()
        if register:
            self._conns.append(conn)
            self._touch(conn)
        self._fire("connect")
        return conn

    def _note_failure(self) -> None:
        self._failures += 1
        if self._failures >= self.failed_attempts and not self._frozen:
            self._frozen = True
            self.freezes += 1
            self._fire("freeze")
            if self._probe_task is None or self._probe_task.done():
                self._probe_task = asyncio.ensure_future(self._probe_loop())

    def _note_success(self) -> None:
        self._failures = 0

    async def _probe_loop(self) -> None:
        """Background unfreeze probe: dial + PING until the endpoint
        answers, then refill to min_idle (ConnectionPool.java:297-386)."""
        while not self._closed and self._frozen:
            await asyncio.sleep(self.reconnection_timeout)
            conn = self._mk()
            try:
                await conn.connect()
                pong = await conn._roundtrip("PING")
                if pong != b"PONG":
                    raise ConnectionClosed(f"bad PING reply {pong!r}")
            except Exception:  # noqa: BLE001 - endpoint still down
                await conn.close()
                continue
            # Endpoint is back: keep the probe connection, unfreeze, refill.
            self._conns.append(conn)
            self._frozen = False
            self._failures = 0
            self._fire("unfreeze")
            while len([c for c in self._conns if c.connected]) < self.min_idle:
                try:
                    await self._dial_one()
                except Exception:  # noqa: BLE001
                    break
            return

    def _fire(self, event: str) -> None:
        for fn in tuple(self._listeners):
            try:
                fn(event)
            except Exception:  # noqa: BLE001
                pass

    # -- acquire ------------------------------------------------------------

    async def _acquire(self) -> RespClient:
        """A live connection for ordinary (multiplexable) traffic."""
        async with self._lock:
            if self._closed:
                raise ConnectionClosed("pool is closed")
            live = [c for c in self._conns if c.connected]
            if live:
                conn = live[next(self._rr) % len(live)]
                self._touch(conn)
                return conn
            if self._frozen:
                raise EndpointFrozen(
                    f"{self.host}:{self.port} frozen after "
                    f"{self.failed_attempts} failed attempts")
            # No live connection: all dropped. The per-connection watchdog
            # reconnects lazily on use; pick one and let execute() retry it,
            # or dial fresh if the pool is empty.
            if self._conns:
                conn = self._conns[next(self._rr) % len(self._conns)]
                self._touch(conn)
                return conn
            return await self._dial_one()

    async def _acquire_exclusive(self) -> RespClient:
        """A dedicated connection for a blocking command, outside the
        shared rotation so a parked pop never serves ordinary traffic."""
        async with self._lock:
            if self._closed:
                raise ConnectionClosed("pool is closed")
            if self._frozen:
                raise EndpointFrozen(
                    f"{self.host}:{self.port} frozen after "
                    f"{self.failed_attempts} failed attempts")
            return await self._dial_one(register=False)

    def _release_exclusive(self, conn: RespClient) -> None:
        # Adopt the spare into the rotation if under budget, else close.
        if conn.connected and len(self._conns) < self.size:
            self._conns.append(conn)
            self._touch(conn)
        else:
            self._close_later(conn)

    # -- ops ----------------------------------------------------------------

    @staticmethod
    def _counts_toward_freeze(e: BaseException) -> bool:
        """Only genuine connection failures freeze the endpoint (the
        reference counts consecutive *connect* failures,
        ConnectionPool.java:184-186). Response timeouts — including
        PossiblyExecuted, a TimeoutError — are per-command errors: three
        slow-but-successful commands on a healthy endpoint must not flip it
        to fail-fast (r2 advisor finding)."""
        if isinstance(e, (EndpointFrozen, TimeoutError)):
            return False
        return isinstance(e, (ConnectionError, OSError))

    async def execute(self, *args) -> Any:
        try:
            conn = await self._acquire()
            result = await conn.execute(*args)
            self._note_success()
            return result
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            if self._counts_toward_freeze(e):
                self._note_failure()
            raise

    async def execute_blocking(self, *args, response_timeout: float) -> Any:
        conn = await self._acquire_exclusive()
        try:
            return await conn.execute_blocking(
                *args, response_timeout=response_timeout)
        finally:
            self._release_exclusive(conn)

    async def pipeline(self, commands: Sequence[Sequence]) -> List[Any]:
        try:
            conn = await self._acquire()
            result = await conn.pipeline(commands)
            self._note_success()
            return result
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            if self._counts_toward_freeze(e):
                self._note_failure()
            raise

    async def close(self) -> None:
        self._closed = True
        if self._reaper_task is not None:
            self._reaper_task.cancel()
            try:
                await self._reaper_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reaper_task = None
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):
                pass
        for conn in self._conns:
            try:
                await conn.close()
            except Exception:  # noqa: BLE001
                pass
        self._conns.clear()
        if self._bg_tasks:
            await asyncio.gather(*tuple(self._bg_tasks),
                                 return_exceptions=True)
            self._bg_tasks.clear()

    @property
    def live_count(self) -> int:
        return len([c for c in self._conns if c.connected])

    @property
    def frozen(self) -> bool:
        return self._frozen


class RespConnectionPool:
    """Blocking facade over _AsyncPool on a private IO thread. Drop-in for
    SyncRespClient (execute/pipeline/close) wherever the redis tier needs
    more than one socket: passthrough traffic, durability flushes, blocking
    pops."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, **kwargs):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="rtpu-pool-io", daemon=True)
        self._thread.start()
        self._pool = _AsyncPool(host, port, **kwargs)
        # loop-stall witness (no-op unless REDISSON_TPU_LOOP_WITNESS=1)
        from redisson_tpu_torch.loopwitness import watch_loop

        watch_loop(self._loop, f"pool:{host}:{port}")

    def _run(self, coro, timeout: float = 60.0):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()
            raise

    def connect(self) -> None:
        self._run(self._pool.start())

    @property
    def timeout(self) -> float:
        return self._pool.timeout

    @property
    def host(self) -> str:
        return self._pool.host

    @property
    def port(self) -> int:
        return self._pool.port

    def execute(self, *args) -> Any:
        return self._run(self._pool.execute(*args))

    def execute_blocking(self, *args, response_timeout: float) -> Any:
        return self._run(
            self._pool.execute_blocking(*args, response_timeout=response_timeout),
            timeout=response_timeout + 30.0)

    def pipeline(self, commands: Sequence[Sequence]) -> List[Any]:
        return self._run(self._pool.pipeline(commands), timeout=120.0)

    def add_listener(self, fn: Callable[[str], None]) -> None:
        """Events: connect / freeze / unfreeze (ConnectionEventsHub).

        The listener list is loop-confined (`_fire` iterates it on the
        pool's IO thread); appending from the caller's thread raced the
        iteration (graftlint G017). call_soon_threadsafe keeps the loop
        the single writer, and FIFO ordering means the listener is
        registered before any event fired after this call returns to the
        loop."""
        self._loop.call_soon_threadsafe(self._pool._listeners.append, fn)

    @property
    def live_count(self) -> int:
        return self._pool.live_count

    @property
    def frozen(self) -> bool:
        return self._pool.frozen

    @property
    def freezes(self) -> int:
        return self._pool.freezes

    @property
    def reaped(self) -> int:
        return self._pool.reaped

    @property
    def closed(self) -> bool:
        return self._loop.is_closed()

    def close(self) -> None:
        from redisson_tpu_torch.loopwitness import unwatch_loop

        unwatch_loop(self._loop)
        try:
            self._run(self._pool.close())
        finally:
            try:
                from redisson_tpu_torch.interop.resp_client import (
                    _cancel_leftover_tasks)

                self._run(_cancel_leftover_tasks())
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            self._loop.close()

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()
