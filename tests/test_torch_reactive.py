"""reactive/ of the port on the CPU: the counterpart of every test of
tests/test_reactive.py (the asyncio mirror of the object surface), on
`create_reactive(Config().use_cuda(device="cpu"))`; then the port held
against the JAX package (the same seeded PFADDs awaited concurrently give
bit-identical registers), the worker threads' device binding, and the
default config's device.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from redisson_tpu.config import Config as JConfig
from redisson_tpu.reactive import create_reactive as jcreate_reactive
from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch import reactive as reactive_mod
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.reactive import (AsyncProxy, RedissonTorchReactive,
                                         create_reactive)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture()
def rx():
    client = create_reactive(Config().use_cuda(device="cpu"))
    yield client
    client.sync.shutdown()


def test_hll_async(rx):
    async def go():
        h = rx.get_hyper_log_log("rx:hll")
        assert isinstance(h, AsyncProxy)
        await h.add_all([b"k%d" % i for i in range(5000)])
        est = await h.count()
        assert abs(est - 5000) / 5000 < 0.05
        await h.add(b"one-more")
        h2 = rx.get_hyper_log_log("rx:hll2")
        await h2.add_all([b"x%d" % i for i in range(100)])
        union = await h.count_with("rx:hll2")
        assert union >= est
    run(go())


def test_bitset_bloom_async(rx):
    async def go():
        bs = rx.get_bit_set("rx:bits")
        await bs.set(5)
        assert await bs.get(5)
        assert not await bs.get(6)
        assert await bs.cardinality() == 1

        bf = rx.get_bloom_filter("rx:bloom")
        await bf.try_init(expected_insertions=1000, false_probability=0.01)
        await bf.add(b"hello")
        assert await bf.contains(b"hello")
    run(go())


def test_map_and_iteration(rx):
    async def go():
        m = rx.get_map("rx:map")
        await m.put("a", 1)
        await m.put("b", 2)
        assert await m.get("a") == 1
        assert await m.size() == 2
        keys = set()
        async for k in m:
            keys.add(k)
        assert keys == {"a", "b"}
    run(go())


def test_concurrent_ops_interleave(rx):
    async def go():
        # Many concurrent coroutines against one object: all complete,
        # totals add up (per-object FIFO order preserved by the executor).
        counter = rx.get_atomic_long("rx:ctr")
        await asyncio.gather(*(counter.increment_and_get() for _ in range(50)))
        assert await counter.get() == 50
    run(go())


def test_async_lock_context_manager(rx):
    async def go():
        lock = rx.get_lock("rx:lock")
        async with lock:
            assert await lock.is_locked()
        assert not await lock.is_locked()
    run(go())


def test_blocking_queue_producer_consumer(rx):
    async def go():
        q = rx.get_blocking_queue("rx:bq")

        async def producer():
            await asyncio.sleep(0.05)
            await q.offer("payload")

        async def consumer():
            return await q.take()  # runs off-loop; must not block the loop

        got, _ = await asyncio.gather(consumer(), producer())
        assert got == "payload"
    run(go())


def test_topic_pubsub_async(rx):
    async def go():
        topic = rx.get_topic("rx:topic")
        seen = []
        await topic.add_listener(lambda ch, msg: seen.append(msg))
        receivers = await topic.publish("hello")
        assert receivers == 1
        deadline = asyncio.get_event_loop().time() + 2
        while not seen and asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.01)
        assert seen == ["hello"]
    run(go())


def test_facade_keys_flushall(rx):
    async def go():
        await rx.get_bucket("rx:b1").set(1)
        await rx.get_bucket("rx:b2").set(2)
        ks = await rx.keys("rx:b*")
        assert set(ks) == {"rx:b1", "rx:b2"}
        assert await rx.delete("rx:b1")
        await rx.flushall()
        assert await rx.keys() == []
    run(go())


def test_sync_escape_hatch(rx):
    h = rx.get_hyper_log_log("rx:sync")
    h.sync.add(b"v")  # the underlying sync object stays usable
    assert h.sync.count() == 1


def test_batch_async(rx):
    async def go():
        b = rx.create_batch()
        sb = b.sync
        # Staging is async-only (like the reference's RBatch *Async clones).
        sb.get_hyper_log_log("rx:bt").add_all_async([b"a", b"b", b"c"])
        sb.get_bit_set("rx:bb").set_bits_async([7])
        results = await b.execute()
        assert len(results) == 2
        assert await rx.get_bit_set("rx:bb").get(7)
    run(go())


def test_async_lock_owner_is_per_task_not_per_thread(rx):
    # Lock ops run via a shared to_thread pool; ownership must follow the
    # asyncio TASK (owner_context), not whichever worker thread serves the
    # call. Acquire/release inside one task while the pool churns.
    async def go():
        async def churn(i):
            b = rx.get_bucket(f"rx:churn{i}")
            await b.set(i)
            return await b.get()

        lock = rx.get_lock("rx:aff")

        async def lock_cycle():
            for _ in range(5):
                await lock.lock()
                assert await lock.is_locked()
                await lock.unlock()

        await asyncio.gather(lock_cycle(),
                             asyncio.gather(*(churn(i) for i in range(16))))
        assert not await lock.is_locked()
    run(go())


def test_async_lock_mutual_exclusion_between_tasks(rx):
    # Two tasks sharing ONE AsyncLock instance must exclude each other —
    # the regression where a pinned thread gave every task the same owner.
    async def go():
        lock = rx.get_lock("rx:mx")
        inside = []

        async def critical(tag):
            async with lock:
                inside.append(tag)
                assert len(inside) == 1, "both tasks inside the lock!"
                await asyncio.sleep(0.05)
                inside.remove(tag)

        await asyncio.gather(critical("a"), critical("b"))
        assert not await lock.is_locked()
    run(go())


def test_async_rw_lock(rx):
    async def go():
        rw = rx.get_read_write_lock("rx:rw")
        r = rw.read_lock()
        await r.lock()
        assert await r.is_locked()
        await r.unlock()
        w = rw.write_lock()
        async with w:
            assert await w.is_locked()
        assert not await w.is_locked()
    run(go())


def test_map_cache_async_iteration(rx):
    async def go():
        mc = rx.get_map_cache("rx:mc")
        await mc.put("x", 1)
        await mc.put("y", 2)
        seen = set()
        async for k in mc:
            seen.add(k)
        assert seen == {"x", "y"}
    run(go())


def test_lock_instances_share_ownership_by_task(rx):
    # Fresh AsyncLock proxies over the same name still agree on ownership
    # (owner = client:task, not instance identity).
    async def go():
        a = rx.get_lock("same")
        b = rx.get_lock("same")
        await a.lock()
        assert await b.is_locked()
        await b.unlock()  # same task, same owner -> valid release
        assert not await a.is_locked()
    run(go())


# ---- the port against the JAX package, and its own rules -----------------


def test_async_pfadds_rows_equal_jax(rx):
    """Eight seeded PFADDs and their PFCOUNTs awaited concurrently: the
    port's registers equal the JAX client's bit for bit, the counts agree
    within rel 1e-5 (float32 sum order in the estimator)."""
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 2**63, 4000, dtype=np.uint64)
               for _ in range(8)]
    jcfg = JConfig()
    jcfg.use_tpu()
    jrx = jcreate_reactive(jcfg)

    async def go(client):
        hlls = [client.get_hyper_log_log(f"rx:p{i}") for i in range(8)]
        await asyncio.gather(*(h.add_ints(b) for h, b in zip(hlls, batches)))
        return await asyncio.gather(*(h.count() for h in hlls))

    try:
        got, want = run(go(rx)), run(go(jrx))
        bank, rows = rx.sync.to_numpy_state()
        jback = jrx.sync._routing.sketch
        jbank, jrows = np.asarray(jback.bank), dict(jback._rows)
        for i in range(8):
            name = f"rx:p{i}"
            assert np.array_equal(bank[rows[name]], jbank[jrows[name]]), name
        np.testing.assert_allclose(got, want, rtol=1e-5)
    finally:
        jrx.sync.shutdown()


def test_worker_threads_bind_the_clients_device(rx, monkeypatch):
    """A blocking method runs in a fresh worker thread, which first makes
    the client's device current (device.bind_thread)."""
    bound = []
    monkeypatch.setattr(reactive_mod, "bind_thread",
                        lambda dev: bound.append((dev, threading.get_ident())))

    async def go():
        q = rx.get_blocking_queue("rx:bind")
        await q.offer("v")
        return await q.take()  # no async twin: a worker thread

    assert run(go()) == "v"
    assert bound and all(dev == torch.device("cpu") for dev, _ in bound)
    assert threading.get_ident() not in {t for _, t in bound}


def test_default_config_runs_on_the_card_or_raises(monkeypatch):
    """create_reactive() with no config asks for cuda:0, like the sync
    client: without a card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_reactive()


def test_wraps_an_existing_client():
    from redisson_tpu_torch.client import RedissonTorch

    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        r = RedissonTorchReactive(c)
        assert r.sync is c
        assert run(r.get_bucket("w").set(3)) is None
        assert c.get_bucket("w").get() == 3
        assert device_mod.resolve("cpu") == r._device
    finally:
        c.shutdown()
