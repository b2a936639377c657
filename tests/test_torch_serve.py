"""serve/ of the port on the CPU: the counterpart of every test of
tests/test_serve.py (admission, deadlines, adaptive batching, retry,
breakers, and the executor regressions that rode along: the shutdown
sweep, the global steal, RBatch concurrency, the client wiring), then the
port held against the JAX package: the same scripted submissions through
JAX's ServingLayer + CommandExecutor and the port's, on one fake clock
and a scripted backend, give the same per-op outcomes, retry counts,
breaker states and admission snapshot; an RBatch through
`ServingLayer.batch()` with a fault mid-batch resolves in staging order
in both.

All port clients run on `Config().use_cuda(device="cpu")`.
"""

import threading
import time
import types
from concurrent.futures import CancelledError

import numpy as np
import pytest

from redisson_tpu import executor as jexecutor
from redisson_tpu.config import ServeConfig as JServeConfig
from redisson_tpu.observability import MetricsRegistry as JMetricsRegistry
from redisson_tpu.serve import ServingLayer as JServingLayer
from redisson_tpu.serve import errors as jerrors
from redisson_tpu.serve.policy import AdaptiveBatchPolicy as JPolicy
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config, ServeConfig
from redisson_tpu_torch.executor import CommandExecutor
from redisson_tpu_torch.observability import ExecutorMetrics, MetricsRegistry
from redisson_tpu_torch.serve import (AdaptiveBatchPolicy, AdmissionController,
                                      CircuitBreaker, CircuitOpenError, CostModel,
                                      DeadlineExceeded, RejectedError,
                                      RetryableError, ServingLayer, TokenBucket)
from redisson_tpu_torch.serve import errors as terrors

#: tests of tests/test_serve.py with no counterpart here, and why (none:
#: every one runs against the port below)
EXCLUDED = {}


def cpu_client(cfg=None):
    """A port client on the CPU (`device="cpu"`), other sections as given."""
    cfg = cfg or Config()
    cfg.use_cuda(device="cpu")
    return RedissonTorch.create(cfg)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class RecordingBackend:
    """Instant backend: records every run, resolves futures with payload."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def run(self, kind, target, ops):
        with self.lock:
            self.calls.append((kind, target, [op.target for op in ops]))
        for op in ops:
            op.future.set_result(op.payload)


def _serve(backend, cfg, clock=None, policy=None, registry=None):
    ex = CommandExecutor(backend, policy=policy, clock=clock)
    reg = registry or MetricsRegistry()
    return ServingLayer(ex, cfg, registry=reg), ex, reg


# ---------------------------------------------------------------------------
# (a) deadline propagation
# ---------------------------------------------------------------------------

def test_expired_deadline_never_reaches_backend():
    clock = FakeClock(100.0)
    backend = RecordingBackend()
    ex = CommandExecutor(backend, clock=clock)
    try:
        f = ex.execute_async("t", "noop", "v", deadline=99.0)
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=5)
        assert backend.calls == []  # pre-dispatch filter, no device time
        # a live op behind it still dispatches
        assert ex.execute_async("t", "noop", "w").result(timeout=5) == "w"
    finally:
        ex.shutdown()


def test_serve_expired_deadline_fails_before_submission():
    clock = FakeClock(50.0)
    backend = RecordingBackend()
    serve, ex, reg = _serve(backend, ServeConfig(retry_attempts=0), clock=clock)
    try:
        f = serve.execute_async("t", "noop", "v", deadline=49.0)
        assert f.done()  # failed synchronously, never enqueued
        with pytest.raises(DeadlineExceeded):
            f.result()
        assert backend.calls == []
        assert ex.queue_depth() == 0
        assert reg.counter("serve.deadline_expired_total") == 1
    finally:
        serve.shutdown()


def test_serve_timeout_s_stamps_absolute_deadline():
    clock = FakeClock(10.0)
    backend = RecordingBackend()
    serve, _, _ = _serve(backend, ServeConfig(retry_attempts=0), clock=clock)
    try:
        # ample budget: completes fine
        assert serve.execute_async("t", "noop", "x",
                                   timeout_s=5.0).result(timeout=5) == "x"
        # timeout_s=0 / default_timeout_ms=0 would mean no deadline at all
        assert serve._resolve_deadline(10.0, None, 0) is None
        assert serve._resolve_deadline(10.0, None, 2.5) == 12.5
        assert serve._resolve_deadline(10.0, 11.0, 2.5) == 11.0
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# (b) shed under overload, admitted p99 within budget (deterministic)
# ---------------------------------------------------------------------------

def test_overload_sheds_while_admitted_p99_stays_under_budget():
    """Offered load 2x capacity against a delay-bounded queue: the delay
    gate sheds the excess and every ADMITTED op waits <= the budget.
    Simulated server + fake clock, no threads, no wall time."""
    budget_s = 0.010
    s_per_key = 1e-6  # capacity: 1e6 keys/s
    cm = CostModel(default_s_per_key=s_per_key, default_overhead_s=0.0)
    adm = AdmissionController(cost_model=cm, max_queue_ops=100_000,
                              max_queue_delay_s=budget_s)

    op_keys = 1000          # 1ms service per op
    arrival_dt = 0.0005     # 2000 ops/s offered = 2x capacity
    now = 0.0
    server_free_at = 0.0    # single-server FIFO drain
    in_service = []         # (finish_time, nkeys) not yet released
    delays = []
    shed = 0
    for _ in range(4000):   # 2 simulated seconds
        now += arrival_dt
        while in_service and in_service[0][0] <= now:
            adm.release(in_service.pop(0)[1])
        try:
            adm.admit("tenant", "k", op_keys, now)
        except RejectedError as exc:
            shed += 1
            assert exc.retry_after_s > 0.0
            continue
        start = max(now, server_free_at)
        delays.append(start - now)
        server_free_at = start + op_keys * s_per_key
        in_service.append((server_free_at, op_keys))

    assert shed > 0
    assert len(delays) > 0
    p99 = sorted(delays)[int(0.99 * (len(delays) - 1))]
    assert p99 <= budget_s + 1e-9, f"p99 {p99 * 1e3:.2f}ms over budget"
    # roughly half the offered load fits: shedding is doing real work,
    # not rejecting everything
    assert 0.2 < shed / 4000 < 0.8
    snap = adm.snapshot(now)
    assert snap["shed_by_reason"].get("queue_delay", 0) == shed


def test_queue_depth_watermark_sheds_with_retry_after():
    adm = AdmissionController(max_queue_ops=2)
    adm.admit("t", "k", 1, now=0.0)
    adm.admit("t", "k", 1, now=0.0)
    with pytest.raises(RejectedError) as ei:
        adm.admit("t", "k", 1, now=0.0)
    assert ei.value.reason == "queue_depth"
    adm.release(1)
    adm.admit("t", "k", 1, now=0.0)  # freed capacity admits again


# ---------------------------------------------------------------------------
# (c) circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine_fake_clock():
    br = CircuitBreaker(failure_threshold=3, reset_timeout_s=1.0,
                        half_open_probes=1)
    for _ in range(3):
        br.allow(now=0.0)
        br.on_failure(now=0.0)
    assert br.state == "open"
    with pytest.raises(CircuitOpenError) as ei:
        br.allow(now=0.5)  # fail fast while open
    assert ei.value.retry_after_s == pytest.approx(0.5)
    # reset elapsed: half-open, one probe slot
    br.allow(now=1.5)
    assert br.state == "half_open"
    with pytest.raises(CircuitOpenError):
        br.allow(now=1.5)  # probe quota in flight
    br.on_success(now=1.6)
    assert br.state == "closed"
    br.allow(now=1.7)  # closed admits freely


def test_breaker_failed_probe_reopens():
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=1.0)
    for _ in range(2):
        br.allow(now=0.0)
        br.on_failure(now=0.0)
    br.allow(now=1.5)  # half-open probe
    br.on_failure(now=1.5)
    assert br.state == "open"
    with pytest.raises(CircuitOpenError):
        br.allow(now=2.0)  # wait restarted from t=1.5
    br.allow(now=2.6)
    br.on_success(now=2.6)
    assert br.state == "closed"


def test_breaker_release_probe_returns_slot():
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=1.0)
    br.allow(now=0.0)
    br.on_failure(now=0.0)
    br.allow(now=1.5)  # takes the probe slot
    br.release_probe()  # op shed before the backend: slot returned
    br.allow(now=1.5)  # slot available again
    br.on_success(now=1.5)
    assert br.state == "closed"


class FlakyBackend:
    """Fails the first `fail_n` runs, then succeeds."""

    def __init__(self, fail_n, exc_factory=lambda: RetryableError("flap")):
        self.fail_n = fail_n
        self.calls = 0
        self.exc_factory = exc_factory

    def run(self, kind, target, ops):
        self.calls += 1
        if self.calls <= self.fail_n:
            exc = self.exc_factory()
            for op in ops:
                op.future.set_exception(exc)
            return
        for op in ops:
            op.future.set_result(op.payload)


def test_breaker_end_to_end_open_fast_fail_half_open_recover():
    backend = FlakyBackend(3, exc_factory=lambda: ValueError("down"))
    cfg = ServeConfig(retry_attempts=0, breaker_failure_threshold=3,
                      breaker_reset_timeout_ms=80, default_timeout_ms=0)
    serve, _, reg = _serve(backend, cfg)
    try:
        for _ in range(3):
            with pytest.raises(ValueError):
                serve.execute_async("t", "noop", "x").result(timeout=5)
        assert backend.calls == 3
        # open: the next op fails fast without touching the backend
        with pytest.raises(CircuitOpenError):
            serve.execute_async("t", "noop", "x").result(timeout=5)
        assert backend.calls == 3
        assert reg.counter("serve.breaker_rejected_total") == 1
        assert serve.snapshot()["breakers"]["noop"]["state"] == "open"
        time.sleep(0.12)  # past the reset timeout: half-open probe admitted
        assert serve.execute_async("t", "noop", "ok").result(timeout=5) == "ok"
        assert serve.snapshot()["breakers"]["noop"]["state"] == "closed"
        assert serve.execute_async("t", "noop", "ok2").result(timeout=5) == "ok2"
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# (d) tenant fairness under 100x offered-load skew
# ---------------------------------------------------------------------------

def test_equal_rate_tenants_within_2x_under_100x_skew():
    clock = FakeClock()
    backend = RecordingBackend()
    cfg = ServeConfig(
        tenant_rates={"a": 1000.0, "b": 1000.0},   # keys/s each
        tenant_bursts={"a": 10.0, "b": 10.0},
        default_timeout_ms=0, retry_attempts=0, max_queue_ops=1_000_000)
    serve, _, reg = _serve(backend, cfg, clock=clock)
    futs = {"a": [], "b": []}
    try:
        for _ in range(100):  # 1 simulated second, 10ms steps
            clock.advance(0.01)
            for i in range(100):  # tenant a offers 100x tenant b's rate
                futs["a"].append(serve.execute_async(
                    "t", "noop", i, nkeys=10, tenant="a"))
            futs["b"].append(serve.execute_async(
                "t", "noop", 0, nkeys=10, tenant="b"))
        ok = {}
        for tenant, fs in futs.items():
            n = 0
            for f in fs:
                try:
                    f.result(timeout=5)
                    n += 1
                except RejectedError as exc:
                    assert exc.reason == "tenant_rate"
            ok[tenant] = n
        assert ok["a"] > 0 and ok["b"] > 0
        ratio = max(ok["a"], ok["b"]) / min(ok["a"], ok["b"])
        assert ratio <= 2.0, f"throughput skew {ratio:.2f}x ({ok})"
        assert reg.counter("serve.shed.tenant_rate") > 0
    finally:
        serve.shutdown()


def test_tenant_context_manager_tags_submissions():
    clock = FakeClock()
    backend = RecordingBackend()
    cfg = ServeConfig(tenant_rates={"noisy": 1.0}, tenant_bursts={"noisy": 1.0},
                      default_timeout_ms=0, retry_attempts=0)
    serve, _, _ = _serve(backend, cfg, clock=clock)
    try:
        with serve.tenant("noisy"):
            assert serve.execute_async("t", "noop", 1, nkeys=1) \
                .result(timeout=5) == 1
            f = serve.execute_async("t", "noop", 2, nkeys=1)  # bucket empty
        with pytest.raises(RejectedError):
            f.result(timeout=5)
        # outside the context: default tenant, unlimited
        assert serve.execute_async("t", "noop", 3, nkeys=1) \
            .result(timeout=5) == 3
    finally:
        serve.shutdown()


def test_token_bucket_refill_and_retry_after():
    b = TokenBucket(rate=100.0, burst=10.0)
    assert b.try_acquire(10.0, now=0.0)
    assert not b.try_acquire(5.0, now=0.0)
    assert b.time_to_tokens(5.0, now=0.0) == pytest.approx(0.05)
    assert b.try_acquire(5.0, now=0.06)  # refilled 6 tokens
    assert b.level(now=1.0) == pytest.approx(10.0)  # capped at burst


# ---------------------------------------------------------------------------
# retry with backoff
# ---------------------------------------------------------------------------

def test_retryable_fault_retries_to_success():
    backend = FlakyBackend(2)
    cfg = ServeConfig(retry_attempts=3, retry_interval_ms=1,
                      breaker_failure_threshold=50, default_timeout_ms=0)
    serve, _, reg = _serve(backend, cfg)
    try:
        assert serve.execute_async("t", "noop", "v").result(timeout=5) == "v"
        assert backend.calls == 3
        assert reg.counter("serve.retries_total") == 2
        assert reg.counter("serve.retry_exhausted_total") == 0
    finally:
        serve.shutdown()


def test_retry_exhaustion_surfaces_the_fault():
    backend = FlakyBackend(100)
    cfg = ServeConfig(retry_attempts=2, retry_interval_ms=1,
                      breaker_failure_threshold=50, default_timeout_ms=0)
    serve, _, reg = _serve(backend, cfg)
    try:
        with pytest.raises(RetryableError):
            serve.execute_async("t", "noop", "v").result(timeout=5)
        assert backend.calls == 3  # initial + 2 retries
        assert reg.counter("serve.retry_exhausted_total") == 1
    finally:
        serve.shutdown()


def test_non_retryable_fault_fails_immediately():
    backend = FlakyBackend(100, exc_factory=lambda: ValueError("hard"))
    cfg = ServeConfig(retry_attempts=3, retry_interval_ms=1,
                      breaker_failure_threshold=50, default_timeout_ms=0)
    serve, _, _ = _serve(backend, cfg)
    try:
        with pytest.raises(ValueError):
            serve.execute_async("t", "noop", "v").result(timeout=5)
        assert backend.calls == 1
    finally:
        serve.shutdown()


def test_retries_do_not_recharge_tenant_tokens():
    backend = FlakyBackend(2)
    cfg = ServeConfig(retry_attempts=3, retry_interval_ms=1,
                      breaker_failure_threshold=50, default_timeout_ms=0,
                      tenant_rates={"t1": 1.0}, tenant_bursts={"t1": 1.0})
    serve, _, _ = _serve(backend, cfg)
    try:
        # one token in the bucket: the op (and both its retries) cost 1 total
        f = serve.execute_async("t", "noop", "v", nkeys=1, tenant="t1")
        assert f.result(timeout=5) == "v"
        assert backend.calls == 3
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# cost model + adaptive policy
# ---------------------------------------------------------------------------

def test_cost_model_learns_per_key_rate():
    cm = CostModel(alpha=1.0, default_overhead_s=0.0)
    cm.observe("hll_add", 1_000_000, 0.01)
    assert cm.s_per_key("hll_add") == pytest.approx(1e-8)
    assert cm.estimate("hll_add", 2_000_000) == pytest.approx(0.02)
    # unmeasured kinds fall back to the generic cross-kind rate
    assert cm.s_per_key("bloom_add") == pytest.approx(1e-8)


def test_adaptive_batch_key_limit_tracks_target_service_time():
    cm = CostModel(alpha=1.0, default_overhead_s=0.0)
    cm.observe("k", 1_000_000, 0.01)  # 10ns/key
    tight = AdaptiveBatchPolicy(cm, target_batch_service_s=0.001,
                                min_batch_keys=64)
    loose = AdaptiveBatchPolicy(cm, target_batch_service_s=0.010,
                                min_batch_keys=64)
    cap = 1 << 21
    t, l = tight.batch_key_limit("k", cap), loose.batch_key_limit("k", cap)
    assert 64 <= t < l <= cap
    assert t == pytest.approx(100_000, rel=0.01)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_policy_decides_as_jax_on_the_same_observations(seed):
    """Both packages' AdaptiveBatchPolicy (their defaults: the same priors,
    5 ms target, 2 ms linger) fed one seeded stream of completions and
    staging times give the same key caps, estimates and linger times.
    40,000-key hll_add runs of ~3.35 ms (the service time learned on a
    card) cap a run below two such ops."""
    rng = np.random.default_rng(seed)
    pols = (JPolicy(), AdaptiveBatchPolicy())
    kinds = ("hll_add", "bloom_add", "bitset_set")
    for _ in range(200):
        kind = kinds[int(rng.integers(3))]
        nkeys = int(rng.choice([1, 8, 16, 4096, 40_000, 1 << 20]))
        sec = float(rng.uniform(0.5, 1.5)) * (50e-6 + nkeys * 84e-9)
        stage = sec * float(rng.uniform(0.2, 0.9))
        for pol in pols:
            pol.observe(kind, nkeys, sec)
            pol.observe_dispatch(kind, nkeys, stage)
    run = [types.SimpleNamespace(enqueued_at=1.0 + i * 1e-4,
                                 deadline=1.5 if i == 2 else None)
           for i in range(4)]
    got = []
    for pol in pols:
        got.append([(pol.batch_key_limit(k, cap), pol.cost_model.estimate(k, n),
                     pol.linger_s(k, 4096, cap, run, 1.0005))
                    for k in kinds + ("other",) for cap in (1 << 16, 1 << 23)
                    for n in (1, 40_000)])
    assert got[1] == got[0]
    for pol in (JPolicy(), AdaptiveBatchPolicy()):
        for _ in range(20):
            pol.observe("hll_add", 40_000, 3.35e-3)
        assert 40_000 <= pol.batch_key_limit("hll_add", 1 << 23) < 80_000


def test_adaptive_linger_bounded_by_deadline_slack():
    cm = CostModel(default_s_per_key=0.0, default_overhead_s=0.0)
    pol = AdaptiveBatchPolicy(cm, max_linger_s=0.1, min_batch_keys=1)
    mk = lambda enq, dl: types.SimpleNamespace(enqueued_at=enq, deadline=dl,
                                               nkeys=1)
    # no deadlines: age bound only
    assert pol.linger_s("k", 1, 100, [mk(10.0, None)], now=10.02) \
        == pytest.approx(0.08)
    # a tight member deadline closes the batch earlier than max_linger
    assert pol.linger_s("k", 1, 100, [mk(10.0, None), mk(10.0, 10.03)],
                        now=10.0) == pytest.approx(0.03)
    # batch full: dispatch now
    assert pol.linger_s("k", 100, 100, [mk(10.0, None)], now=10.0) == 0.0


def test_adaptive_linger_coalesces_late_arrival_into_one_dispatch():
    backend = RecordingBackend()
    pol = AdaptiveBatchPolicy(CostModel(), max_linger_s=0.5,
                              target_batch_service_s=1.0, min_batch_keys=10)
    ex = CommandExecutor(backend, policy=pol)
    try:
        f1 = ex.execute_async("t", "bitset_set", "a", nkeys=1)
        time.sleep(0.1)  # within the linger window
        f2 = ex.execute_async("t", "bitset_set", "b", nkeys=1)
        assert f1.result(timeout=5) == "a"
        assert f2.result(timeout=5) == "b"
        runs = [c for c in backend.calls if c[0] == "bitset_set"]
        assert len(runs) == 1 and len(runs[0][2]) == 2, (
            "the late arrival should have joined the lingering batch")
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# executor regressions: shutdown sweep + global steal + round-robin
# ---------------------------------------------------------------------------

class GatedBackend:
    """First run blocks until released; later runs are instant."""

    def __init__(self, global_kinds=()):
        self.GLOBAL_COALESCE = frozenset(global_kinds)
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = []
        self._first = True

    def run(self, kind, target, ops):
        if self._first:
            self._first = False
            self.entered.set()
            self.release.wait(10)
        self.calls.append((kind, target, [op.target for op in ops]))
        for op in ops:
            op.future.set_result(op.payload)


def test_shutdown_cancels_queued_ops_behind_a_wedged_backend():
    backend = GatedBackend()
    ex = CommandExecutor(backend)
    f1 = ex.execute_async("a", "noop", "in-flight")
    assert backend.entered.wait(5)
    f2 = ex.execute_async("b", "noop", "stranded")
    ex.shutdown(wait=True, timeout=0.2)  # join times out: sweep runs
    with pytest.raises(CancelledError):
        f2.result(timeout=1)
    backend.release.set()  # the in-flight run still completes normally
    assert f1.result(timeout=5) == "in-flight"


def test_shutdown_sweep_records_cancelled_metric():
    backend = GatedBackend()
    metrics = ExecutorMetrics()
    ex = CommandExecutor(backend, metrics=metrics)
    ex.execute_async("a", "noop", "x")
    assert backend.entered.wait(5)
    stranded = [ex.execute_async("b", "noop", i) for i in range(3)]
    ex.shutdown(wait=True, timeout=0.2)
    for f in stranded:
        with pytest.raises(CancelledError):
            f.result(timeout=1)
    assert metrics.registry.counter("executor.cancelled_total") == 3
    backend.release.set()


def test_global_steal_interleaved_with_submissions_keeps_all_targets():
    """Cross-target steal empties some queues mid-scan; the round-robin and
    queue map must stay consistent (regression: mutating _ready while
    iterating dropped targets / crashed the dispatcher)."""
    backend = GatedBackend(global_kinds=("gk",))
    ex = CommandExecutor(backend)
    try:
        blocker = ex.execute_async("z", "blk", "hold")
        assert backend.entered.wait(5)
        futs = []
        futs.append(ex.execute_async("t1", "gk", "t1", nkeys=1))
        futs.append(ex.execute_async("t2", "gk", "t2", nkeys=1))
        other = ex.execute_async("t2", "other", "t2-other")  # survives steal
        futs.append(ex.execute_async("t3", "gk", "t3", nkeys=1))
        futs.append(ex.execute_async("t4", "gk", "t4a", nkeys=1))
        futs.append(ex.execute_async("t4", "gk", "t4b", nkeys=1))
        futs.append(ex.execute_async("t5", "gk", "t5", nkeys=1))
        backend.release.set()
        assert blocker.result(timeout=5) == "hold"
        assert [f.result(timeout=5) for f in futs] == \
            ["t1", "t2", "t3", "t4a", "t4b", "t5"]
        assert other.result(timeout=5) == "t2-other"
        gk_runs = [c for c in backend.calls if c[0] == "gk"]
        assert len(gk_runs) == 1  # one steal collected every head
        assert gk_runs[0][2] == ["t1", "t2", "t3", "t4", "t4", "t5"]
        # the dispatcher survived: a fresh op still completes
        assert ex.execute_async("t9", "noop", "alive").result(timeout=5) \
            == "alive"
    finally:
        ex.shutdown()


def test_round_robin_interleaves_targets():
    backend = GatedBackend()
    ex = CommandExecutor(backend)
    try:
        blocker = ex.execute_async("z", "blk", "hold")
        assert backend.entered.wait(5)
        fa = [ex.execute_async("A", "k", f"a{i}") for i in range(3)]
        fb = [ex.execute_async("B", "k", f"b{i}") for i in range(3)]
        backend.release.set()
        blocker.result(timeout=5)
        for f in fa + fb:
            f.result(timeout=5)
        order = [c[1] for c in backend.calls if c[0] == "k"]
        assert order == ["A", "B", "A", "B", "A", "B"]
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# RBatch / BatchCollector under concurrency (satellite s3)
# ---------------------------------------------------------------------------

def test_concurrent_batch_collectors_resolve_in_submission_order():
    backend = RecordingBackend()
    ex = CommandExecutor(backend)
    done_log = []
    log_lock = threading.Lock()
    errors = []

    def worker(tid):
        try:
            batch = ex.batch()
            staged = [batch.add("shared", "bitset_set", (tid, i), nkeys=1)
                      for i in range(20)]
            for i, sf in enumerate(staged):
                sf.add_done_callback(
                    lambda f, tid=tid, i=i: _log(tid, i))
            outs = batch.execute_async()
            for i, f in enumerate(outs):
                assert f.result(timeout=10) == (tid, i)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def _log(tid, i):
        with log_lock:
            done_log.append((tid, i))

    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        # execute_many enqueues each batch contiguously under one lock, so
        # every caller's StagedFutures resolve in its own submission order
        per_tid = {}
        for tid, i in done_log:
            per_tid.setdefault(tid, []).append(i)
        for tid, seq in per_tid.items():
            assert seq == sorted(seq), f"thread {tid} resolved out of order"
        assert sum(len(s) for s in per_tid.values()) == 120
    finally:
        ex.shutdown()


def test_staged_future_result_before_execute_raises():
    backend = RecordingBackend()
    ex = CommandExecutor(backend)
    try:
        batch = ex.batch()
        sf = batch.add("t", "noop", 1)
        with pytest.raises(RuntimeError, match="not executed"):
            sf.result()
        assert batch.execute() == [1]
        assert sf.result(timeout=5) == 1
    finally:
        ex.shutdown()


def test_serve_batch_single_admission_decision():
    clock = FakeClock()
    backend = RecordingBackend()
    cfg = ServeConfig(default_timeout_ms=0, retry_attempts=0,
                      max_queue_ops=1000)
    serve, _, reg = _serve(backend, cfg, clock=clock)
    try:
        batch = serve.batch(tenant="bt")
        staged = [batch.add("t", "noop", i, nkeys=5) for i in range(4)]
        assert batch.execute() == [0, 1, 2, 3]
        # one admission for the whole pipeline
        assert reg.counter("serve.admitted_total") == 1
        # completion released the whole key weight
        assert serve._admission.queue_stats() == \
            {"queued_ops": 0, "queued_keys": 0}
    finally:
        serve.shutdown()


def test_serve_batch_fast_fails_on_open_breaker():
    clock = FakeClock()
    backend = RecordingBackend()
    cfg = ServeConfig(default_timeout_ms=0, retry_attempts=0,
                      breaker_failure_threshold=1)
    serve, _, _ = _serve(backend, cfg, clock=clock)
    try:
        br = serve._breakers.get("noop")
        br.allow(now=clock())
        br.on_failure(now=clock())
        assert br.state == "open"
        futs = serve.execute_many([("t", "noop", 1, 1), ("t", "noop", 2, 1)])
        for f in futs:
            with pytest.raises(CircuitOpenError):
                f.result(timeout=5)
        assert backend.calls == []
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# observability + snapshot endpoint
# ---------------------------------------------------------------------------

def test_snapshot_debug_endpoint_shape():
    clock = FakeClock()
    backend = RecordingBackend()
    serve, _, _ = _serve(backend, ServeConfig(default_timeout_ms=0,
                                              retry_attempts=0), clock=clock)
    try:
        serve.execute_async("t", "noop", 1).result(timeout=5)
        snap = serve.snapshot()
        assert snap["admission"]["admitted_total"] == 1
        assert snap["executor_queue_depth"] == 0
        assert snap["counters"]["serve.admitted_total"] == 1
        assert "breakers" in snap and "policy" in snap
    finally:
        serve.shutdown()


def test_queue_delay_and_occupancy_histograms_recorded():
    backend = RecordingBackend()
    metrics = ExecutorMetrics()
    ex = CommandExecutor(backend, metrics=metrics)
    try:
        ex.execute_async("t", "noop", 1, nkeys=4).result(timeout=5)
        snap = metrics.registry.snapshot()["histograms"]
        assert snap["executor.queue_delay_s"]["count"] == 1
        assert snap["executor.batch_occupancy"]["count"] == 1
    finally:
        ex.shutdown()


def test_expired_counter_recorded():
    clock = FakeClock(10.0)
    backend = RecordingBackend()
    metrics = ExecutorMetrics()
    ex = CommandExecutor(backend, metrics=metrics, clock=clock)
    try:
        f = ex.execute_async("t", "noop", 1, deadline=9.0)
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=5)
        assert metrics.registry.counter("executor.expired_total") == 1
        assert metrics.registry.counter("executor.expired.noop") == 1
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# client wiring
# ---------------------------------------------------------------------------

def test_client_serve_mode_end_to_end():
    cfg = Config()
    cfg.use_serve()
    client = cpu_client(cfg)
    try:
        assert client.serve is not None
        bs = client.get_bit_set("serve:bs")
        bs.set(3)
        assert bs.get(3) is True
        assert bs.cardinality() == 1
        snap = client.serve.snapshot()
        assert snap["admission"]["admitted_total"] > 0
        assert snap["policy"]["policy"] == "adaptive"
        # maintenance traffic bypasses admission: the raw executor is NOT
        # the serving layer
        assert client._executor is client.serve.executor
        assert client._dispatch is client.serve
    finally:
        client.shutdown()


def test_client_without_serve_config_keeps_raw_executor():
    client = cpu_client(Config())
    try:
        assert client.serve is None
        assert client._dispatch is client._executor
    finally:
        client.shutdown()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


class ScriptedBackend:
    """Synchronous fake backend. A target's attempts follow its script:
    "r<N>" fails the first N attempts with the package's RetryableError,
    "bad" always fails with a non-retryable error, "q" always fails
    retryably; anything else succeeds with its payload."""

    batch_dims = {}

    def __init__(self, errors):
        self.errors = errors
        self.attempts = {}

    def run(self, kind, target, ops):
        for op in ops:
            n = self.attempts[op.target] = self.attempts.get(op.target, 0) + 1
            t = op.target
            if t == "bad":
                op.future.set_exception(RuntimeError("backend fault"))
            elif t == "q" or (t.startswith("r") and n <= int(t[1:])):
                op.future.set_exception(self.errors.RetryableError("transient"))
            else:
                op.future.set_result(op.payload)


def _script():
    """(clock advance, tenant, kind, target, nkeys, deadline offset)."""
    out = []
    for i in range(40):
        tenant = ("a", "b", "limited")[i % 3]
        if i in (5, 6, 7, 8, 9, 10):
            out.append((0.01, tenant, "hll_count", "bad", 1, None))
        elif i == 11:
            out.append((0.5, tenant, "hll_count", "ok", 1, None))  # still open
        elif i == 12:
            out.append((1.0, tenant, "hll_count", "ok", 1, None))  # half-open probe
        elif i % 7 == 0:
            out.append((0.01, tenant, "hll_add", "r2", 50, None))
        elif i % 11 == 0:
            out.append((0.01, tenant, "hll_add", "q", 50, None))
        elif i % 13 == 0:
            out.append((0.01, tenant, "hll_add", "late", 10, -0.5))
        else:
            out.append((0.02, tenant, "hll_add", f"t{i}", 60, 5.0))
    return out


def _drive(pkg):
    if pkg == "jax":
        ex_mod, cfg_cls, serve_cls, reg_cls, errors = (
            jexecutor, JServeConfig, JServingLayer, JMetricsRegistry, jerrors)
    else:
        import redisson_tpu_torch.executor as ex_mod
        cfg_cls, serve_cls, reg_cls, errors = (
            ServeConfig, ServingLayer, MetricsRegistry, terrors)
    clock = FakeClock(100.0)
    cfg = cfg_cls(tenant_rates={"limited": 100.0}, retry_attempts=3,
                  retry_interval_ms=1, breaker_failure_threshold=3,
                  breaker_reset_timeout_ms=1000, default_timeout_ms=0)
    backend = ScriptedBackend(errors)
    ex = ex_mod.CommandExecutor(backend, clock=clock)
    reg = reg_cls()
    serve = serve_cls(ex, cfg, registry=reg, clock=clock)
    outcomes, states = [], []
    try:
        for dt, tenant, kind, target, nkeys, dl in _script():
            clock.advance(dt)
            deadline = None if dl is None else clock.t + dl
            f = serve.execute_async(target, kind, {"v": target}, nkeys,
                                    tenant=tenant, deadline=deadline)
            try:
                outcomes.append(("ok", f.result(timeout=10)["v"]))
            except errors.RejectedError as exc:
                outcomes.append(("RejectedError", exc.reason,
                                 round(exc.retry_after_s, 9)))
            except Exception as exc:  # noqa: BLE001 — recorded by type
                outcomes.append((type(exc).__name__,))
            states.append(serve._breakers.get(kind).state)
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith("serve.")}
        adm = serve.snapshot()["admission"]
        return outcomes, states, counters, adm, dict(backend.attempts)
    finally:
        serve.shutdown()


def test_scripted_submissions_match_jax():
    j = _drive("jax")
    t = _drive("torch")
    names = ("outcomes", "breaker states", "serve counters", "admission",
             "backend attempts")
    for name, a, b in zip(names, t, j):
        assert a == b, name
    kinds = {o[0] for o in j[0]}
    # q's retries open hll_add's breaker, so it ends in CircuitOpenError
    assert {"ok", "RejectedError", "CircuitOpenError", "DeadlineExceeded",
            "RuntimeError"} <= kinds
    assert j[2]["serve.retries_total"] >= 4


class MidBatchFault:
    """Fails the op whose payload says so; the rest of the run succeeds."""

    batch_dims = {}

    def __init__(self, errors):
        self.errors = errors

    def run(self, kind, target, ops):
        for op in ops:
            if op.payload == "boom":
                op.future.set_exception(self.errors.RetryableError("mid-batch"))
            else:
                op.future.set_result(op.payload)


def _batch_results(pkg):
    if pkg == "jax":
        ex = jexecutor.CommandExecutor(MidBatchFault(jerrors))
        serve = JServingLayer(ex, JServeConfig(), registry=JMetricsRegistry())
    else:
        ex = CommandExecutor(MidBatchFault(terrors))
        serve = ServingLayer(ex, ServeConfig(), registry=MetricsRegistry())
    try:
        b = serve.batch()
        staged = [b.add(f"t{i % 3}", ("noop", "other")[i % 2],
                        "boom" if i == 4 else i, 1) for i in range(9)]
        futs = b.execute_async()
        assert [f is s.outermost() for f, s in zip(futs, staged)] == [True] * 9
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=10))
            except Exception as exc:  # noqa: BLE001 — recorded by type
                out.append(type(exc).__name__)
        return out, serve.snapshot()["admission"]["admitted_total"]
    finally:
        serve.shutdown()


def test_served_batch_with_a_mid_batch_fault_resolves_in_staging_order():
    j, t = _batch_results("jax"), _batch_results("torch")
    assert t == j
    assert t[0] == [0, 1, 2, 3, "RetryableError", 5, 6, 7, 8]


# ---------------------------------------------------------------------------
# serve/windows.py: the wire tier's per-connection reply order
# ---------------------------------------------------------------------------

def _window_script(win, seed: int, cap: int):
    """A seeded reserve / complete / drain script against one window: the
    log of every reservation, drain and stats snapshot it saw."""
    rng = np.random.default_rng(seed)
    open_slots, log = [], []
    for step in range(400):
        op = int(rng.integers(5))
        if op <= 1:
            slot = win.try_reserve()
            log.append(("reserve", None if slot is None else slot.seq))
            if slot is not None:
                open_slots.append(slot)
        elif op == 2:
            log.append(("inline", win.reserve_immediate(b"+PONG").seq))
        elif op == 3 and open_slots:
            slot = open_slots.pop(int(rng.integers(len(open_slots))))
            win.complete(slot, f"r{slot.seq}".encode())
            win.complete(slot, b"again")  # a double completion is ignored
        else:
            log.append(("drain", win.drain()))
        log.append(("stats", win.stats(), win.pending(), win.inflight()))
    return log


@pytest.mark.parametrize("seed,cap", [(0, 4), (1, 16), (2, 128)])
def test_connection_window_matches_jax(seed, cap):
    """The same script through JAX's ConnectionWindow and the port's gives
    the same slots, drains, sheds and counters (bit-exact: pure Python)."""
    from redisson_tpu.serve.windows import ConnectionWindow as JWindow
    from redisson_tpu_torch.serve import ConnectionWindow

    assert _window_script(ConnectionWindow(cap), seed, cap) == \
        _window_script(JWindow(cap), seed, cap)


def test_connection_window_drains_the_completed_prefix_in_order():
    from redisson_tpu_torch.serve import ConnectionWindow

    win = ConnectionWindow(max_inflight=3)
    a, b, c = win.try_reserve(), win.try_reserve(), win.try_reserve()
    assert win.try_reserve() is None and win.stats()[2] == 1  # shed at the cap
    win.complete(c, b"c")
    win.complete(b, b"b")
    assert win.drain() == []  # a still in flight holds everything behind it
    win.complete(a, b"a")
    assert win.drain() == [b"a", b"b", b"c"]
    assert win.stats() == (0, 3, 1, 3)
    assert win.try_reserve().seq == 3  # the shed command consumed no slot
