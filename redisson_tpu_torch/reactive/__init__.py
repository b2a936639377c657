"""Reactive (asyncio) API — the async mirror of every object (counterpart
of `redisson_tpu.reactive`).

The reference ships a full reactive tier: `RedissonReactive` + 25 wrappers
adapting each object's `*Async` methods into reactor-stream Publishers via
`NettyFuturePublisher` (reference `reactive/`, `api/`, SURVEY.md §2 L4/L5).
Python's Publisher is the awaitable, so our adapter is:

  * every sync-object method with an `*_async` twin becomes a coroutine
    awaiting the executor future (`asyncio.wrap_future` bridges the
    `concurrent.futures.Future` from the L2 executor into the caller's
    event loop — the NettyFuturePublisher role);
  * methods without an async twin (blocking ops like `lock()`, `take()`,
    or host-side conveniences) run in a worker thread via
    `asyncio.to_thread`, keeping the event loop unblocked; each such worker
    first makes the client's device current (`device.bind_thread`), since
    a fresh thread has no CUDA device of its own;
  * non-callable attributes (`.name`, …) pass through.

`RedissonTorchReactive` (JAX's `RedissonTPUReactive`) mirrors the facade
getters; typed wrapper classes add
the async-native affordances (async context-manager locks, async iteration)
on top of the generic proxy.
"""

from __future__ import annotations

import asyncio
import functools
import itertools
from concurrent.futures import Future as _CFuture
from typing import Any, AsyncIterator

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.device import bind_thread

__all__ = ["RedissonTorchReactive", "AsyncProxy", "create_reactive"]


async def _to_thread(device, fn, *args, **kwargs):
    """`asyncio.to_thread`, with `device` made current in the worker."""

    def call():
        if device is not None:
            bind_thread(device)
        return fn(*args, **kwargs)

    return await asyncio.to_thread(call)


class AsyncProxy:
    """Generic async mirror of one sync object. `device` (the client's) is
    made current in every worker thread a blocking method runs in."""

    __slots__ = ("_sync", "_device")

    def __init__(self, sync_obj: Any, device=None):
        object.__setattr__(self, "_sync", sync_obj)
        object.__setattr__(self, "_device", device)

    @property
    def sync(self) -> Any:
        """The underlying synchronous object."""
        return self._sync

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        sync = self._sync
        async_impl = getattr(sync, name + "_async", None)
        if callable(async_impl):

            @functools.wraps(async_impl)
            async def via_future(*args, **kwargs):
                out = async_impl(*args, **kwargs)
                if isinstance(out, _CFuture):
                    return await asyncio.wrap_future(out)
                if isinstance(out, (list, tuple)) and out and all(
                        isinstance(f, _CFuture) for f in out):
                    return type(out)(
                        await asyncio.gather(*(asyncio.wrap_future(f) for f in out)))
                return out  # already a plain value

            return via_future
        attr = getattr(sync, name)
        if callable(attr):

            @functools.wraps(attr)
            async def via_thread(*args, **kwargs):
                return await _to_thread(self._device, attr, *args, **kwargs)

            return via_thread
        return attr

    def __repr__(self) -> str:
        return f"Async({self._sync!r})"


_task_seq = itertools.count(1)


def _task_owner_id() -> str:
    """A stable per-asyncio-task lock-owner context id. A monotonic token is
    stamped on the task once — id(task) alone could be reused by a new task
    allocated at a freed task's address, inheriting its lock ownership."""
    task = asyncio.current_task()
    if task is None:
        return "loopless"
    token = getattr(task, "_rtpu_owner_token", None)
    if token is None:
        token = next(_task_seq)
        task._rtpu_owner_token = token
    return f"task-{token}"


class AsyncLock(AsyncProxy):
    """Adds `async with` acquire/release on top of the proxy.

    Lock ownership defaults to `client_id:thread_id` (models/lock.py, the
    reference's uuid:threadId); a shared to_thread pool would acquire on
    one worker thread and release on another. Instead of pinning threads,
    every call runs under an `owner_context` carrying the calling asyncio
    TASK's identity — the analogue of the reference passing an explicit
    threadId through lockAsync/unlockAsync. Mutual exclusion is therefore
    between tasks, and reentrancy works within one task."""

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self._sync, name)
        if callable(attr):
            from redisson_tpu_torch.models.lock import owner_context

            @functools.wraps(attr)
            async def via_task_owner(*args, **kwargs):
                oid = _task_owner_id()

                def call():
                    with owner_context(oid):
                        return attr(*args, **kwargs)

                return await _to_thread(self._device, call)

            return via_task_owner
        return attr

    async def __aenter__(self):
        await self.lock()
        return self

    async def __aexit__(self, *exc):
        await self.unlock()


class AsyncReadWriteLock(AsyncProxy):
    """read_lock()/write_lock() return AsyncLocks (task-owner semantics)."""

    def read_lock(self) -> AsyncLock:
        return AsyncLock(self._sync.read_lock(), self._device)

    def write_lock(self) -> AsyncLock:
        return AsyncLock(self._sync.write_lock(), self._device)


class AsyncIterableProxy(AsyncProxy):
    """Adds `async for` over the sync object's iterator (driven off-loop,
    including iterator construction — iter() itself does an executor
    round-trip for most objects)."""

    def __aiter__(self) -> AsyncIterator:
        sync, device = self._sync, self._device
        sentinel = object()

        async def gen():
            it = await _to_thread(device, iter, sync)
            while True:
                item = await _to_thread(device, next, it, sentinel)
                if item is sentinel:
                    return
                yield item

        return gen()


class RedissonTorchReactive:
    """The RedissonReactiveClient analogue: same getters, async objects.

    Construct via `create_reactive(config)` or wrap an existing sync client:
    `RedissonTorchReactive(client)`. The sync client remains fully usable; the
    reactive facade shares its executor, store and pub/sub (mirroring how
    the reference's reactive wrappers delegate to the same command services).
    """

    def __init__(self, client: RedissonTorch):
        self._client = client
        self._device = client.device

    # -- sketch tier --------------------------------------------------------

    def get_hyper_log_log(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_hyper_log_log(name, codec),
                          self._device)

    def get_bit_set(self, name: str) -> AsyncProxy:
        return AsyncProxy(self._client.get_bit_set(name), self._device)

    def get_bloom_filter(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_bloom_filter(name, codec),
                          self._device)

    def create_batch(self) -> AsyncProxy:
        return AsyncProxy(self._client.create_batch(), self._device)

    # -- structures ---------------------------------------------------------

    def get_bucket(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_bucket(name, codec), self._device)

    def get_buckets(self, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_buckets(codec), self._device)

    def get_atomic_long(self, name: str) -> AsyncProxy:
        return AsyncProxy(self._client.get_atomic_long(name), self._device)

    def get_atomic_double(self, name: str) -> AsyncProxy:
        return AsyncProxy(self._client.get_atomic_double(name), self._device)

    def get_map(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_map(name, codec),
                                  self._device)

    def get_map_cache(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_map_cache(name, codec),
                                  self._device)

    def get_set(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_set(name, codec),
                                  self._device)

    def get_set_cache(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_set_cache(name, codec),
                                  self._device)

    def get_list(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_list(name, codec),
                                  self._device)

    def get_queue(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_queue(name, codec),
                                  self._device)

    def get_deque(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_deque(name, codec),
                                  self._device)

    def get_blocking_queue(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_blocking_queue(name, codec),
                                  self._device)

    def get_blocking_deque(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_blocking_deque(name, codec),
                                  self._device)

    def get_sorted_set(self, name: str, codec=None, key=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_sorted_set(name, codec, key),
                                  self._device)

    def get_scored_sorted_set(self, name: str, codec=None) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_scored_sorted_set(name, codec),
                                  self._device)

    def get_lex_sorted_set(self, name: str) -> AsyncIterableProxy:
        return AsyncIterableProxy(self._client.get_lex_sorted_set(name),
                                  self._device)

    def get_set_multimap(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_set_multimap(name, codec),
                          self._device)

    def get_list_multimap(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_list_multimap(name, codec),
                          self._device)

    def get_set_multimap_cache(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_set_multimap_cache(name, codec),
                          self._device)

    def get_list_multimap_cache(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_list_multimap_cache(name, codec),
                          self._device)

    def get_geo(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_geo(name, codec), self._device)

    def get_topic(self, name: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_topic(name, codec), self._device)

    def get_pattern_topic(self, pattern: str, codec=None) -> AsyncProxy:
        return AsyncProxy(self._client.get_pattern_topic(pattern, codec),
                          self._device)

    # -- coordination -------------------------------------------------------

    def get_lock(self, name: str) -> AsyncLock:
        return AsyncLock(self._client.get_lock(name), self._device)

    def get_fair_lock(self, name: str) -> AsyncLock:
        return AsyncLock(self._client.get_fair_lock(name), self._device)

    def get_read_write_lock(self, name: str) -> AsyncReadWriteLock:
        return AsyncReadWriteLock(self._client.get_read_write_lock(name),
                                  self._device)

    def get_semaphore(self, name: str) -> AsyncProxy:
        return AsyncProxy(self._client.get_semaphore(name), self._device)

    def get_count_down_latch(self, name: str) -> AsyncProxy:
        return AsyncProxy(self._client.get_count_down_latch(name),
                          self._device)

    # -- keys / lifecycle ---------------------------------------------------

    def get_keys(self) -> AsyncProxy:
        return AsyncProxy(self._client.get_keys(), self._device)

    async def keys(self, pattern: str = "*"):
        return await _to_thread(self._device, self._client.keys, pattern)

    async def flushall(self):
        await _to_thread(self._device, self._client.flushall)

    async def delete(self, name: str) -> bool:
        return await _to_thread(self._device, self._client.delete, name)

    @property
    def sync(self) -> RedissonTorch:
        return self._client

    async def shutdown(self):
        await _to_thread(self._device, self._client.shutdown)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.shutdown()


def create_reactive(config=None) -> RedissonTorchReactive:
    """Build a reactive client (creates the underlying sync client; like
    `RedissonTorch.create`, it runs on the card unless the config names
    the CPU, and takes a Config or the CudaConfig section)."""
    return RedissonTorchReactive(RedissonTorch.create(config))
