"""fault/ of the port on the CPU: the counterpart of every test of
tests/test_fault.py that needs nothing outside this slice, plus the CUDA
message and exception tables of `classify`.

1. classify(): the raw-exception -> taxonomy mapping, seam sensitivity,
   semantic passthrough; the CUDA runtime's sticky, transient and fatal
   errors, and `torch.cuda.OutOfMemoryError` by type;
2. injection units;
3. seams through the real client (the serving layer's retry absorbs the
   retryable faults, as in the JAX tests);
4. the watchdog; 5. the rebuild; 6. the chaos properties; 7. satellites.

All clients run on `Config().use_cuda(device="cpu")`.
"""

import threading
import time
from concurrent.futures import CancelledError

import pytest
import torch

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config, FaultConfig, ServeConfig
from redisson_tpu_torch.executor import CommandExecutor
from redisson_tpu_torch.fault import inject, taxonomy
from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan, FaultRule
from redisson_tpu_torch.fault.rebuild import RebuildCoordinator
from redisson_tpu_torch.fault.taxonomy import (
    DeviceLostFault,
    FatalFault,
    RetryableFault,
    StateUncertainFault,
    TargetDegradedError,
    TargetQuarantinedError,
    classify,
)
from redisson_tpu_torch.fault.watchdog import RunWatchdog
from redisson_tpu_torch.observability import MetricsRegistry
from redisson_tpu_torch.serve import BreakerBoard, ServingLayer
from redisson_tpu_torch.serve.errors import RetryableError
from tests.test_torch_persist import digest

#: tests of tests/test_fault.py with no counterpart here, and why (none:
#: the serving layer, the registry and the dict round trip are ported)
EXCLUDED = {}


@pytest.fixture(autouse=True)
def _clean_fault_globals():
    """Every test starts with no injector and zeroed taxonomy counters."""
    inject.uninstall()
    taxonomy._reset_stats()
    yield
    inject.uninstall()


def make_client(tmp_path=None, serve=True, plan=None, seed=0, watchdog=False,
                rebuild=True, retry_interval_ms=5, **fault_kw):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    if tmp_path is not None:
        cfg.use_persist(str(tmp_path), fsync="always")
    if serve:
        cfg.use_serve(retry_interval_ms=retry_interval_ms)
    cfg.use_faults(plan=plan or [], seed=seed, watchdog=watchdog,
                   rebuild=rebuild, **fault_kw)
    return RedissonTorch.create(cfg)


# ---------------------------------------------------------------------------
# 1. classify()
# ---------------------------------------------------------------------------

class FakeXlaRuntimeError(Exception):
    """Stands in for jaxlib's XlaRuntimeError (matched by type NAME)."""


FakeXlaRuntimeError.__name__ = "XlaRuntimeError"


def cuda_error(message: str) -> RuntimeError:
    """What torch raises for a CUDA runtime error: a RuntimeError (an
    AcceleratorError in recent releases) whose text starts with the
    runtime's own message."""
    return RuntimeError(
        f"CUDA error: {message}\nCUDA kernel errors might be asynchronously "
        "reported at some other API call, so the stacktrace below might be "
        "incorrect.\nFor debugging consider passing CUDA_LAUNCH_BLOCKING=1\n"
        "Compile with `TORCH_USE_CUDA_DSA` to enable device-side assertions.")


STICKY = ["an illegal memory access was encountered", "unspecified launch failure",
          "device-side assert triggered", "uncorrectable ECC error encountered",
          "GPU has fallen off the bus", "the launch timed out and was terminated",
          "misaligned address", "an illegal instruction was encountered"]
FATAL = ["no kernel image is available for execution on the device",
         "CUDA driver version is insufficient for CUDA runtime version",
         "invalid device ordinal"]


class TestClassify:
    def test_semantic_errors_pass_through(self):
        for exc in (KeyError("k"), ValueError("bad payload"),
                    TypeError("no")):
            assert classify(exc, seam="kernel_launch") is exc
        assert taxonomy.stats()["passthrough"] == 3
        assert taxonomy.stats()["classified"] == 0

    def test_cancelled_and_faults_pass_through(self):
        c = CancelledError()
        assert classify(c, seam="d2h_complete") is c
        f = RetryableFault("x", seam="stage_h2d")
        assert classify(f, seam="d2h_complete") is f

    def test_transient_precommit_is_retryable(self):
        for seam in ("stage_h2d", "kernel_launch", "journal_fsync",
                     "snapshot_io"):
            out = classify(FakeXlaRuntimeError("RESOURCE_EXHAUSTED: oom"),
                           seam=seam)
            assert isinstance(out, RetryableFault), seam
            assert isinstance(out, RetryableError)
            assert out.seam == seam
            assert isinstance(out.cause, FakeXlaRuntimeError)

    def test_transient_postdispatch_is_uncertain(self):
        out = classify(FakeXlaRuntimeError("UNAVAILABLE: transfer failed"),
                       seam="d2h_complete")
        assert isinstance(out, StateUncertainFault)
        assert not isinstance(out, RetryableFault)
        out = classify(FakeXlaRuntimeError("ABORTED: preempted"),
                       seam="mesh_collective")
        assert isinstance(out, StateUncertainFault)

    def test_device_lost(self):
        out = classify(FakeXlaRuntimeError("DATA_LOSS: device lost"),
                       seam="d2h_complete")
        assert isinstance(out, DeviceLostFault)
        assert isinstance(out, StateUncertainFault)

    def test_fatal(self):
        out = classify(
            FakeXlaRuntimeError("INVALID_ARGUMENT: shape mismatch"),
            seam="kernel_launch")
        assert isinstance(out, FatalFault)

    def test_oserror_at_io_seam_is_retryable(self):
        out = classify(OSError(28, "No space left on device"),
                       seam="journal_fsync")
        assert isinstance(out, RetryableFault)

    def test_unmatched_runtimeerror_passes_through(self):
        exc = RuntimeError("shape invariant violated: 3 != 4")
        assert classify(exc, seam="kernel_launch") is exc

    def test_stats_accumulate(self):
        classify(FakeXlaRuntimeError("UNAVAILABLE: x"), seam="stage_h2d")
        classify(FakeXlaRuntimeError("UNAVAILABLE: x"), seam="d2h_complete")
        classify(FakeXlaRuntimeError("DATA_LOSS: device lost"), seam="")
        s = taxonomy.stats()
        assert s["classified"] == 3
        assert s["retryable"] == 1
        assert s["state_uncertain"] == 2
        assert s["device_lost"] == 1

    # -- the CUDA runtime's errors ------------------------------------------

    @pytest.mark.parametrize("message", STICKY)
    @pytest.mark.parametrize("seam", ["kernel_launch", "d2h_complete"])
    def test_cuda_sticky_errors_are_device_lost(self, message, seam):
        out = classify(cuda_error(message), seam=seam)
        assert isinstance(out, DeviceLostFault), message
        assert taxonomy.stats()["device_lost"] == 1

    @pytest.mark.parametrize("message", FATAL)
    def test_cuda_unusable_card_is_fatal(self, message):
        assert isinstance(classify(cuda_error(message), seam="kernel_launch"),
                          FatalFault)

    def test_kernel_build_failure_is_fatal(self):
        exc = RuntimeError("CUDA kernel build failed:\nseg_insert: nvcc exit 1")
        assert isinstance(classify(exc, seam="kernel_launch"), FatalFault)
        exc = RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        assert isinstance(classify(exc, seam="kernel_launch"), FatalFault)

    def test_cuda_oom_by_type_follows_the_seam(self):
        # The message alone would match nothing; the type decides.
        oom = torch.cuda.OutOfMemoryError("Tried to allocate 1.00 TiB")
        out = classify(oom, seam="kernel_launch")
        assert isinstance(out, RetryableFault) and out.cause is oom
        out = classify(oom, seam="d2h_complete")
        assert isinstance(out, StateUncertainFault)
        assert not isinstance(out, RetryableFault)

    def test_cuda_oom_message_is_transient(self):
        out = classify(RuntimeError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
            "total capacity of 79.10 GiB"), seam="kernel_launch")
        assert isinstance(out, RetryableFault)

    def test_non_sticky_cuda_message_passes_through(self):
        exc = cuda_error("invalid argument")
        assert classify(exc, seam="kernel_launch") is exc


# ---------------------------------------------------------------------------
# 2. injection
# ---------------------------------------------------------------------------

class TestInjection:
    def test_rule_validation(self):
        with pytest.raises(ValueError):
            FaultRule(seam="nope")
        with pytest.raises(ValueError):
            FaultRule(seam="stage_h2d", fault="weird")
        with pytest.raises(ValueError):
            FaultRule(seam="stage_h2d", nth=0)

    def test_nth_and_times(self):
        inj = FaultInjector(FaultPlan(rules=[
            FaultRule(seam="kernel_launch", nth=2, times=2)]))
        inj.fire("kernel_launch")
        with pytest.raises(RetryableFault):
            inj.fire("kernel_launch")
        with pytest.raises(RetryableFault):
            inj.fire("kernel_launch")
        inj.fire("kernel_launch")
        assert inj.injected == 2
        assert [f["hit"] for f in inj.fired] == [2, 3]

    def test_kind_target_matching(self):
        inj = FaultInjector(FaultPlan(rules=[
            FaultRule(seam="d2h_complete", kind="hll_add", target="h",
                      nth=1)]))
        inj.fire("d2h_complete", kind="bitset_set", target="h")
        inj.fire("d2h_complete", kind="hll_add", target="g")
        with pytest.raises(RetryableFault):
            inj.fire("d2h_complete", kind="hll_add", target="h")
        assert inj.snapshot()["hits"] == [1]

    def test_random_plan_is_deterministic(self):
        a, b = FaultPlan.random(seed=7), FaultPlan.random(seed=7)
        assert a == b
        assert FaultPlan.random(seed=8) != a
        for rule in a.rules:
            assert rule.seam in inject.SEAMS
            assert rule.fault in inject.FAULT_CLASSES

    def test_fire_disabled_is_noop(self):
        inject.uninstall()
        for _ in range(3):
            inject.fire("kernel_launch", kind="hll_add", target="t")

    def test_install_uninstall(self):
        inj = FaultInjector(FaultPlan())
        inject.install(inj)
        assert inject.installed() is inj
        inject.uninstall()
        assert inject.installed() is None


# ---------------------------------------------------------------------------
# 3. seams through the real client
# ---------------------------------------------------------------------------

class TestSeams:
    def test_kernel_launch_retryable_absorbed_by_a_retry(self):
        """The serving layer's retry absorbs the fault: the caller never
        sees it (the JAX package's test_kernel_launch_retryable_absorbed_by_serve)."""
        c = make_client(plan=[{"seam": "kernel_launch", "fault": "retryable",
                               "nth": 3, "times": 1}])
        try:
            h = c.get_hyper_log_log("h")
            for i in range(10):
                h.add(f"k{i}")  # one add trips the seam; retry absorbs it
            assert h.count() == 10
            assert c.fault.injector.injected == 1
            assert c.metrics.counter("serve.retries_total") == 1
        finally:
            c.shutdown()

    def test_journal_fsync_retryable_absorbed(self, tmp_path):
        c = make_client(tmp_path, plan=[
            {"seam": "journal_fsync", "fault": "retryable", "nth": 2,
             "times": 1}])
        try:
            bits = c.get_bit_set("bits")
            for i in range(8):
                bits.set(i, True)
            assert bits.cardinality() == 8
            assert c.fault.injector.injected == 1
        finally:
            c.shutdown()

    def test_stage_h2d_seam_in_pipeline(self):
        from redisson_tpu_torch.ingest.pipeline import StagingPipeline

        inject.install(FaultInjector(FaultPlan(rules=[
            FaultRule(seam="stage_h2d", nth=2)])))
        pipe = StagingPipeline(depth=2)
        with pytest.raises(RetryableFault):
            pipe.run([1, 2, 3], stage=lambda x: x, dispatch=lambda i, s: s)

    def test_snapshot_io_seam(self, tmp_path):
        c = make_client(tmp_path, plan=[
            {"seam": "snapshot_io", "fault": "retryable", "nth": 1,
             "times": 1}])
        try:
            c.get_hyper_log_log("h").add("a")
            with pytest.raises(RetryableFault):
                c.snapshot_now()
            c.snapshot_now()
        finally:
            c.shutdown()

    def test_d2h_uncertain_quarantines_and_rebuilds(self, tmp_path):
        c = make_client(tmp_path, plan=[
            {"seam": "d2h_complete", "fault": "state_uncertain", "nth": 3,
             "times": 1, "kind": "hll_add"}])
        try:
            h = c.get_hyper_log_log("h")
            outcomes = []
            for i in range(30):
                try:
                    h.add(f"k{i}")
                    outcomes.append("ok")
                except Exception as exc:  # noqa: BLE001 - audit the types
                    outcomes.append(type(exc).__name__)
            assert "StateUncertainFault" in outcomes
            assert c.fault.rebuild.wait_idle(timeout=30)
            snap = c.fault.rebuild.snapshot()
            assert snap["rebuilt_total"] >= 1
            assert snap["degraded"] == [] and snap["quarantined"] == []
            assert h.count() >= outcomes.count("ok")
            h.add("after-rebuild")
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# 4. watchdog
# ---------------------------------------------------------------------------

class WedgedBackend:
    """run() blocks until released — a hung device call. Late completion
    respects the executor contract (guards future.done())."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def run(self, kind, target, ops):
        self.entered.set()
        self.release.wait(timeout=30)
        for op in ops:
            if not op.future.done():
                op.future.set_result("late")


class TestWatchdog:
    def test_deadline_floor_and_margin(self):
        ex = CommandExecutor(WedgedBackend())
        try:
            wd = RunWatchdog(ex, estimate=None, margin=8.0, floor_s=2.0)
            assert wd.deadline_s("hll_add", 100) == 2.0
            wd2 = RunWatchdog(ex, estimate=lambda k, n: 1.0, margin=8.0,
                              floor_s=2.0)
            assert wd2.deadline_s("hll_add", 100) == 8.0
            wd3 = RunWatchdog(ex, estimate=lambda k, n: 1 / 0, margin=8.0,
                              floor_s=2.0)
            assert wd3.deadline_s("hll_add", 100) == 2.0
        finally:
            ex.shutdown(wait=False)

    def test_trip_completes_futures_and_releases_gates(self):
        backend = WedgedBackend()
        ex = CommandExecutor(backend)
        trips = []
        wd = RunWatchdog(ex, estimate=None, margin=1.0, floor_s=0.05,
                         on_trip=lambda k, t, f: trips.append((k, set(t), f)))
        try:
            f = ex.execute_async("t", "noop", "v", nkeys=1)
            assert backend.entered.wait(timeout=5)
            time.sleep(0.1)
            assert wd.check_once() == 1
            with pytest.raises(StateUncertainFault):
                f.result(timeout=5)
            assert wd.check_once() == 0
            assert wd.trips == 1
            assert taxonomy.stats()["watchdog_trips"] == 1
            assert trips and trips[0][0] == "noop" and trips[0][1] == {"t"}
            assert isinstance(trips[0][2], StateUncertainFault)
            backend.release.set()
            assert ex.execute_async("t", "noop", "w",
                                    nkeys=1).result(timeout=10) == "late"
        finally:
            backend.release.set()
            wd.stop()
            ex.shutdown()

    def test_trip_completes_futures_and_opens_breaker(self):
        backend = WedgedBackend()
        ex = CommandExecutor(backend)
        breakers = BreakerBoard(clock=time.monotonic)
        trips = []
        wd = RunWatchdog(ex, estimate=None, margin=1.0, floor_s=0.05,
                         breakers=breakers,
                         on_trip=lambda k, t, f: trips.append((k, set(t), f)))
        try:
            f = ex.execute_async("t", "noop", "v", nkeys=1)
            assert backend.entered.wait(timeout=5)
            time.sleep(0.1)  # age past the 0.05s floor
            assert wd.check_once() == 1
            with pytest.raises(StateUncertainFault):
                f.result(timeout=5)
            assert wd.check_once() == 0  # no double trip
            assert wd.trips == 1
            assert taxonomy.stats()["watchdog_trips"] == 1
            assert breakers.get("noop").state == "open"
            assert trips and trips[0][0] == "noop" and trips[0][1] == {"t"}
            assert isinstance(trips[0][2], StateUncertainFault)
            backend.release.set()
            assert ex.execute_async("t", "noop", "w",
                                    nkeys=1).result(timeout=10) == "late"
        finally:
            backend.release.set()
            wd.stop()
            ex.shutdown()

    def test_deadline_comes_from_the_serving_cost_model(self):
        """With a serving layer the client's watchdog prices a run from the
        cost model (JAX's wiring), and the breaker board is the layer's."""
        c = make_client(watchdog=True)
        try:
            wd, cm = c.fault.watchdog, c.serve.cost_model
            assert wd._breakers is c.serve._breakers
            assert c.fault.rebuild._breakers is c.serve._breakers
            cm.observe("hll_add", 10_000_000, 2.0)  # a slow learned rate
            assert wd.deadline_s("hll_add", 10_000_000) == pytest.approx(
                8.0 * cm.estimate("hll_add", 10_000_000))
            assert wd.deadline_s("hll_add", 1) == 2.0  # the floor
        finally:
            c.shutdown()

    def test_healthy_runs_never_trip(self):
        c = make_client(watchdog=True)
        try:
            h = c.get_hyper_log_log("h")
            for i in range(20):
                h.add(f"k{i}")
            assert h.count() == 20
            assert c.fault.watchdog.trips == 0
        finally:
            c.shutdown()


# ---------------------------------------------------------------------------
# 5. rebuild
# ---------------------------------------------------------------------------

class TestRebuild:
    def test_guard_rejects_writes_only(self):
        rc = RebuildCoordinator(client=None)
        rc._quarantined.add("q")
        rc._degraded.add("d")
        assert isinstance(rc.guard("hll_add", "q"), TargetQuarantinedError)
        assert isinstance(rc.guard("hll_add", "d"), TargetDegradedError)
        assert rc.guard("hll_count", "q") is None
        assert rc.guard("hll_add", "other") is None
        assert rc.guard("hll_add", "") is None
        assert isinstance(rc.guard("hll_add", "q"), RetryableError)
        assert not isinstance(rc.guard("hll_add", "d"), RetryableError)

    def test_rebuild_restores_snapshot_plus_suffix(self, tmp_path):
        c = make_client(tmp_path, plan=[
            {"seam": "d2h_complete", "fault": "device_lost", "nth": 6,
             "times": 1, "kind": "hll_add"}])
        try:
            h = c.get_hyper_log_log("h")
            for i in range(3):
                h.add(f"pre{i}")
            c.snapshot_now()
            for i in range(20):
                try:
                    h.add(f"post{i}")
                except Exception:  # noqa: BLE001 - chaos loop
                    pass
            assert c.fault.rebuild.wait_idle(timeout=30)
            snap = c.fault.rebuild.snapshot()
            assert snap["rebuilt_total"] >= 1 and snap["rebuild_failures"] == 0
            assert h.count() >= 3
            h.add("again")
        finally:
            c.shutdown()

    def test_no_persist_degrades_to_read_only(self):
        c = make_client(tmp_path=None, plan=[
            {"seam": "d2h_complete", "fault": "state_uncertain", "nth": 2,
             "times": 1, "kind": "bitset_set"}])
        try:
            bits = c.get_bit_set("bits")
            for i in range(10):
                try:
                    bits.set(i, True)
                except Exception:  # noqa: BLE001 - chaos loop
                    pass
            c.fault.rebuild.wait_idle(timeout=30)
            snap = c.fault.rebuild.snapshot()
            assert snap["degraded"] == ["bits"]
            assert snap["rebuild_failures"] == 1
            with pytest.raises(TargetDegradedError):
                c._executor.execute_async("bits", "bitset_set",
                                          {"idx": [99]},
                                          nkeys=1).result(timeout=5)
            assert bits.cardinality() >= 1
            assert c.fault.rebuild.guard("bitset_set", "healthy") is None
        finally:
            c.shutdown()

    def test_sweep_queued_rejects_with_factory(self):
        backend = WedgedBackend()
        ex = CommandExecutor(backend)
        try:
            blocker = ex.execute_async("t", "noop", 1, nkeys=1)
            assert backend.entered.wait(timeout=5)
            queued = [ex.execute_async("t", "noop", i, nkeys=1)
                      for i in range(3)]
            other = ex.execute_async("u", "noop", 9, nkeys=1)
            n = ex.sweep_queued({"t"}, lambda op: TargetQuarantinedError(
                f"{op.target} quarantined"))
            assert n == 3
            for f in queued:
                with pytest.raises(TargetQuarantinedError):
                    f.result(timeout=5)
            backend.release.set()
            assert blocker.result(timeout=5) == "late"
            assert other.result(timeout=5) == "late"
        finally:
            backend.release.set()
            ex.shutdown()


# ---------------------------------------------------------------------------
# 6. the chaos property
# ---------------------------------------------------------------------------

def _workload(client, rng_seed=0xC0FFEE, n=120):
    """Deterministic hll/bloom/bitset mix; returns per-op outcomes."""
    import random as _random

    rng = _random.Random(rng_seed)
    h = client.get_hyper_log_log("h")
    bits = client.get_bit_set("bits")
    bloom = client.get_bloom_filter("bloom")
    bloom.try_init(4096, 0.01)
    outcomes = []
    for i in range(n):
        op = rng.choice(("hll", "bits", "bloom"))
        try:
            if op == "hll":
                h.add(f"u{i}")
            elif op == "bits":
                bits.set(rng.randint(0, 512), True)
            else:
                bloom.add(f"b{i}")
            outcomes.append(("ok", op))
        except Exception as exc:  # noqa: BLE001 - the property audits types
            outcomes.append((type(exc).__name__, op))
    return outcomes


PRECOMMIT_SEAMS = ("stage_h2d", "kernel_launch", "journal_fsync")


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_chaos_retryable_plans_are_bit_identical_to_oracle(tmp_path, seed):
    """Pre-commit retryable faults + a caller retry: no op fails for good
    and the engine state is bit-identical to a fault-free run."""
    oracle = make_client()
    try:
        assert all(o == "ok" for o, _ in _workload(oracle))
        want = digest(oracle)
    finally:
        oracle.shutdown()

    plan = FaultPlan.random(seed=seed, seams=PRECOMMIT_SEAMS,
                            n_rules=4, max_nth=40, faults=("retryable",))
    c = make_client(tmp_path / "chaos", plan=[
        {"seam": r.seam, "fault": r.fault, "nth": r.nth, "times": r.times}
        for r in plan.rules])
    try:
        outcomes = _workload(c)
        assert all(o == "ok" for o, _ in outcomes), outcomes
        assert digest(c) == want
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_chaos_uncertain_plans_recover_committed_state(tmp_path, seed):
    """State-uncertain/device-lost faults at the post-dispatch seam: every
    future completes (a result or a typed fault, never a hang), rebuilds
    settle, and the surviving state equals a fresh client's recovery of
    the committed journal bit for bit."""
    import random as _random

    rng = _random.Random(seed)
    plan = [{"seam": "d2h_complete",
             "fault": rng.choice(("state_uncertain", "device_lost")),
             "nth": rng.randint(2, 25), "times": 1}
            for _ in range(2)]
    live_dir = tmp_path / "live"
    c = make_client(live_dir, plan=plan)
    try:
        outcomes = _workload(c, rng_seed=seed)
        allowed = {"ok", "StateUncertainFault", "DeviceLostFault",
                   "CircuitOpenError", "TargetQuarantinedError",
                   "DeadlineExceeded", "RetryableFault"}
        assert {o for o, _ in outcomes} <= allowed, outcomes
        assert c.fault.rebuild.wait_idle(timeout=60)
        assert c.fault.rebuild.snapshot()["rebuild_failures"] == 0
        c.persist.journal.sync()
        live = digest(c)
    finally:
        c.shutdown()

    cfg = Config()
    cfg.use_cuda(device="cpu")
    cfg.use_persist(str(live_dir), fsync="always")
    r = RedissonTorch.create(cfg)
    try:
        assert digest(r) == live
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# 7. satellites
# ---------------------------------------------------------------------------

class TestRoutingRenameRegression:
    def test_structures_branch_failure_resolves_future(self):
        c = make_client()
        try:
            c.get_bucket("src").set("v")

            def boom(kind, target, ops):
                raise RuntimeError("structures tier exploded")

            c._routing.structures.run = boom
            f = c._executor.execute_async(
                "src", "rename", {"newkey": "dst"}, nkeys=1)
            with pytest.raises(RuntimeError, match="exploded"):
                f.result(timeout=5)
        finally:
            del c._routing.structures.run
            c.shutdown()


class FailNTimesBackend:
    """Fails the first `n` runs with a RetryableError, then succeeds."""

    def __init__(self, n):
        self.n = n
        self.runs = 0

    def run(self, kind, target, ops):
        self.runs += 1
        for op in ops:
            if self.runs <= self.n:
                op.future.set_exception(RetryableError("transient"))
            else:
                op.future.set_result(op.payload)


class TestServeShutdownCancelsRetries:
    def test_pending_retry_outer_cancelled_at_shutdown(self):
        backend = FailNTimesBackend(n=10)
        ex = CommandExecutor(backend)
        serve = ServingLayer(
            ex, ServeConfig(retry_attempts=3, retry_interval_ms=60_000),
            registry=MetricsRegistry())
        # timeout_s=0 -> no deadline, so the 30-60s backoff IS scheduled
        outer = serve.execute_async("t", "noop", "v", nkeys=1, timeout_s=0)
        deadline = time.monotonic() + 5
        while not serve._timer._heap and time.monotonic() < deadline:
            time.sleep(0.005)
        assert serve._timer._heap, "retry was never scheduled"
        serve.shutdown()
        assert outer.cancelled()
        with pytest.raises(CancelledError):
            outer.result(timeout=0)

    def test_timer_closed_inline_fallback_cancels(self):
        backend = FailNTimesBackend(n=10)
        ex = CommandExecutor(backend)
        serve = ServingLayer(
            ex, ServeConfig(retry_attempts=3, retry_interval_ms=60_000),
            registry=MetricsRegistry())
        serve._timer.close()  # race shutdown ahead of the attempt
        outer = serve.execute_async("t", "noop", "v", nkeys=1, timeout_s=0)
        with pytest.raises(CancelledError):
            outer.result(timeout=5)
        ex.shutdown()

    def test_entries_without_cancel_still_fire_at_close(self):
        from redisson_tpu_torch.serve.scheduler import _Timer

        t = _Timer()
        fired = []
        t.call_later(60.0, lambda: fired.append("fn"))
        t.close()
        assert fired == ["fn"]  # no cancel hook -> fire


class TestShutdownSweep:
    def test_staged_but_undispatched_ops_cancel_at_shutdown(self):
        backend = WedgedBackend()
        ex = CommandExecutor(backend)
        inflight = ex.execute_async("t", "hll_add", {"values": ["a"]}, nkeys=1)
        assert backend.entered.wait(timeout=5)
        queued = [ex.execute_async("t", "hll_add", {"values": [f"v{i}"]},
                                   nkeys=1) for i in range(4)]
        ex.shutdown(wait=True, timeout=0.3)
        for f in queued:
            assert f.done()
            with pytest.raises(CancelledError):
                f.result(timeout=0)
        backend.release.set()
        assert inflight.result(timeout=10) == "late"


class TestPlumbing:
    def test_fault_config_section(self):
        cfg = Config()
        fc = cfg.use_faults(plan=[{"seam": "kernel_launch", "nth": 2}],
                            watchdog=True)
        assert isinstance(cfg.faults, FaultConfig) and fc is cfg.faults
        assert cfg.use_faults() is fc
        assert fc.plan == [{"seam": "kernel_launch", "nth": 2}]
        assert fc.watchdog is True and fc.rebuild is True
        with pytest.raises(TypeError):
            Config().use_faults(no_such_field=1)

    def test_config_roundtrip(self):
        cfg = Config()
        fc = cfg.use_faults()
        fc.plan = [{"seam": "kernel_launch", "nth": 2}]
        fc.watchdog = True
        d = cfg.to_dict()
        back = Config.from_dict(d)
        assert isinstance(back.faults, FaultConfig)
        assert back.faults.plan == fc.plan
        assert back.faults.watchdog is True

    def test_fault_gauges_registered(self):
        c = make_client(watchdog=True)
        try:
            gauges = c.metrics.snapshot()["gauges"]
            for name in ("fault.injected", "fault.classified",
                         "fault.retried", "fault.rebuilt",
                         "fault.quarantined", "fault.degraded",
                         "fault.rebuild_s", "fault.watchdog_trips"):
                assert name in gauges, name
        finally:
            c.shutdown()

    def test_manager_stop_uninstalls_injector(self):
        c = make_client(plan=[{"seam": "kernel_launch", "nth": 999}])
        assert inject.installed() is c.fault.injector
        c.shutdown()
        assert inject.installed() is None

    def test_journal_failure_fails_the_run_unapplied(self, tmp_path):
        c = make_client(tmp_path)
        try:
            bits = c.get_bit_set("bits")
            bits.set(1, True)
            c.persist.journal.close()  # appends now raise
            with pytest.raises(RuntimeError, match="journal is closed"):
                bits.set(2, True)
            assert not bits.get(2)  # never applied unjournaled
        finally:
            c.shutdown()
