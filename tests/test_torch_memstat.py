"""memstat/ of the port on the CPU: the counterpart of every test of
tests/test_memstat.py that needs nothing outside this slice (the byte
ledger, the store seam, the pressure gate, the MEMORY surface, the client
end to end), then the port held against the JAX package: one seeded op
sequence through both clients gives the same ledger, per-kind bytes,
MEMORY USAGE and dataset bytes after every step (the port's verify() clean
after each), and both shed at the same ops under the same watermarks.

All port clients run on `Config().use_cuda(device="cpu")`.
"""

import random

import numpy as np
import pytest
import torch

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.serve.errors import RejectedError as JRejectedError
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config, MemConfig
from redisson_tpu_torch.memstat import MemLedger, MemoryReport, PressureMonitor
from redisson_tpu_torch.memstat.accounting import BANK_ENTRY
from redisson_tpu_torch.observability import MetricsRegistry
from redisson_tpu_torch.serve.errors import RejectedError
from redisson_tpu_torch.store import SketchStore

#: tests of tests/test_memstat.py with no counterpart here, and why (none)
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


class FakeStore:
    """Just enough store for verify(): a name -> nbytes mapping."""

    def __init__(self, sizes):
        self.sizes = dict(sizes)

    def live_nbytes(self):
        return dict(self.sizes)


# ---------------------------------------------------------------------------
# 1. ledger unit tests
# ---------------------------------------------------------------------------

def test_ledger_lifecycle_and_totals():
    led = MemLedger()
    led.on_create("a", "bitset", 1024, slot=3, tenant="t1")
    led.on_create("b", "hll", 4096, slot=7)
    assert led.live_bytes() == 5120
    assert led.keys_count() == 2
    assert led.kind_bytes() == {"bitset": 1024, "hll": 4096}
    led.on_resize("a", 2048)
    assert led.live_bytes() == 6144
    led.on_delete("b")
    assert led.live_bytes() == 2048
    assert led.kind_bytes() == {"bitset": 2048}
    e = led.entry("a")
    assert e == {"kind": "bitset", "tenant": "t1", "slot": 3,
                 "nbytes": 2048}
    # events are counted; unknown-name resize/delete are no-ops
    n = led.events()
    led.on_resize("ghost", 512)
    led.on_delete("ghost")
    assert led.events() == n and led.live_bytes() == 2048


def test_ledger_recreate_is_idempotent():
    led = MemLedger()
    led.on_create("a", "bitset", 1024)
    led.on_create("a", "bloom", 4096)  # re-create: debit old, credit new
    assert led.live_bytes() == 4096
    assert led.kind_bytes() == {"bloom": 4096}
    assert led.keys_count() == 1


def test_ledger_rename_clobbers_destination():
    led = MemLedger()
    led.on_create("src", "bitset", 1000, slot=1)
    led.on_create("dst", "bitset", 2000, slot=2)
    led.on_rename("src", "dst", slot=2)
    # dest bytes debited (Redis RENAME overwrites), source entry moved
    assert led.live_bytes() == 1000
    assert led.keys_count() == 1
    assert led.entry("dst")["nbytes"] == 1000
    assert led.entry("dst")["slot"] == 2
    assert led.entry("src") is None


def test_ledger_flushall_and_peak_monotone():
    led = MemLedger()
    peaks = []
    led.on_create("a", "bitset", 10_000)
    peaks.append(led.peak_bytes())
    led.on_create("b", "hll", 50_000)
    peaks.append(led.peak_bytes())
    led.on_delete("b")
    peaks.append(led.peak_bytes())
    led.on_flushall()
    peaks.append(led.peak_bytes())
    assert led.live_bytes() == 0 and led.keys_count() == 0
    assert led.kind_bytes() == {}
    assert peaks == sorted(peaks)  # never decreases
    assert led.peak_bytes() == 60_000


def test_ledger_bank_entry_tracking():
    led = MemLedger()
    led.set_bank_bytes(1 << 20)
    assert led.bank_bytes() == 1 << 20
    assert led.live_bytes() == 1 << 20
    assert led.kind_bytes() == {"hll": 1 << 20}
    led.set_bank_bytes(1 << 21)  # grow
    assert led.live_bytes() == 1 << 21
    led.set_bank_bytes(0)  # dropped at flushall
    assert led.bank_bytes() == 0 and led.live_bytes() == 0
    assert led.keys_count() == 0


def test_ledger_attribution_rollups():
    led = MemLedger()
    led.on_create("a", "bitset", 100, slot=1, tenant="t1")
    led.on_create("b", "bitset", 200, slot=1, tenant="t2")
    led.on_create("c", "hll", 400, slot=2)  # empty tenant -> "-"
    attr = led.attribution()
    assert attr["by_kind"] == {"bitset": 300, "hll": 400}
    assert attr["by_tenant"] == {"t1": 100, "t2": 200, "-": 400}
    assert attr["by_slot"] == {"1": 300, "2": 400}


def test_ledger_meters_isolate_failures():
    led = MemLedger()
    led.register_meter("good", lambda: 4096, "cache")
    led.register_meter("boom", lambda: 1 // 0, "scratch")
    led.register_meter("disk", lambda: 1 << 30, "disk")
    with pytest.raises(ValueError):
        led.register_meter("bad", lambda: 0, "no-such-category")
    m = led.meters()
    assert m["good"] == {"bytes": 4096, "category": "cache"}
    assert m["boom"]["bytes"] == 0  # broken meter reads 0, never raises
    assert led.meter_errors >= 1
    totals = led.meter_totals()
    assert totals == {"cache": 4096, "scratch": 0, "staging": 0,
                      "disk": 1 << 30}
    # disk never counts toward device-adjacent overhead
    assert led.overhead_bytes() == 4096
    led.unregister_meter("disk")
    assert led.meter_totals()["disk"] == 0


def test_ledger_verify_detects_drift():
    led = MemLedger()
    led.on_create("a", "bitset", 100)
    led.on_create("stale", "bitset", 50)
    store = FakeStore({"a": 100, "missing": 70})
    v = led.verify(store)
    assert not v["ok"]
    assert v["missing"] == ["missing"]
    assert v["stale"] == ["stale"]
    assert v["drift_bytes"] == 170 - 150
    # mismatched byte count on a shared name
    led2 = MemLedger()
    led2.on_create("a", "bitset", 100)
    v2 = led2.verify(FakeStore({"a": 120}))
    assert v2["mismatched"] == {"a": {"ledger": 100, "actual": 120}}
    # and the healthy case
    v3 = led2.verify(FakeStore({"a": 100}))
    assert v3["ok"] and v3["drift_bytes"] == 0


# ---------------------------------------------------------------------------
# 2. store seam
# ---------------------------------------------------------------------------

def _mk(nbytes: int):
    return torch.zeros(nbytes // 4, dtype=torch.int32)


def test_store_seam_keeps_invariant():
    store = SketchStore("cpu")
    led = MemLedger()
    store.accounting = led
    store.get_or_create("s:a", "bitset", lambda: _mk(1024))
    store.get_or_create("s:b", "bitset", lambda: _mk(2048))
    assert led.live_bytes() == 3072
    # get_or_create on an existing name does NOT double-count
    store.get_or_create("s:a", "bitset", lambda: _mk(1024))
    assert led.live_bytes() == 3072
    # swap resizes
    obj = store.get("s:a")
    assert store.swap("s:a", _mk(4096), expected_version=obj.version)
    assert led.entry("s:a")["nbytes"] == 4096
    # delete debits
    assert store.delete("s:b")
    assert led.live_bytes() == 4096
    v = led.verify(store)
    assert v["ok"], v
    store.flushall()
    assert led.live_bytes() == 0
    assert led.verify(store)["ok"]


def test_store_rename_overwrites_dest_and_ledger_debits():
    """Redis RENAME semantics pinned at the store level: an existing
    destination is silently replaced, and the ledger debits its bytes."""
    store = SketchStore("cpu")
    led = MemLedger()
    store.accounting = led
    store.get_or_create("r:src", "bitset", lambda: _mk(1024))
    store.get_or_create("r:dst", "bitset", lambda: _mk(8192))
    assert store.rename("r:src", "r:dst") is True
    assert not store.exists("r:src")
    dst = store.get("r:dst")
    assert int(dst.state.nbytes) == 1024  # source value won
    assert led.live_bytes() == 1024
    assert led.verify(store)["ok"]
    # renaming a missing key is a no-op for both
    assert store.rename("r:ghost", "r:dst") is False
    assert led.live_bytes() == 1024


def test_store_keys_pattern_glob():
    store = SketchStore("cpu")
    for name in ("user:1", "user:2", "sess:1", "user:10"):
        store.get_or_create(name, "bitset", lambda: _mk(64))
    assert sorted(store.keys("user:*")) == ["user:1", "user:10", "user:2"]
    assert sorted(store.keys("user:?")) == ["user:1", "user:2"]
    assert store.keys("nope*") == []
    assert len(store.keys()) == 4


# ---------------------------------------------------------------------------
# 3. pressure
# ---------------------------------------------------------------------------

def _pressure(led, clk, high=0, low=0, **kw):
    cfg = MemConfig(high_watermark_bytes=high, low_watermark_bytes=low,
                    **kw)
    return PressureMonitor(led, cfg, clock=clk)


def test_pressure_no_watermark_never_sheds():
    led = MemLedger()
    led.on_create("a", "bitset", 1 << 30)
    p = _pressure(led, FakeClock())
    assert p.should_shed("bitset_set") is False
    p.check_write("bitset_set")  # no raise


def test_pressure_sheds_writes_not_reads_or_reclaims():
    led = MemLedger()
    led.on_create("a", "bitset", 2000)
    p = _pressure(led, FakeClock(), high=1000)
    with pytest.raises(RejectedError) as ei:
        p.check_write("bitset_set")
    assert ei.value.reason == "memory"
    assert ei.value.retry_after_s > 0
    assert p.shed_total == 1
    # reads and reclaiming writes always flow
    for kind in ("bitset_get", "hll_count", "exists",
                 "delete", "flushall", "rename"):
        p.check_write(kind)
    assert p.shed_total == 1


def test_pressure_hysteresis_band():
    led = MemLedger()
    clk = FakeClock()
    p = _pressure(led, clk, high=1000, low=500)
    led.on_create("a", "bitset", 1200)
    assert p.should_shed("bitset_set") is True
    # dipping below high but above low: still shedding (no flapping)
    led.on_resize("a", 800)
    assert p.should_shed("bitset_set") is True
    # below the low watermark: recovered
    led.on_resize("a", 400)
    assert p.should_shed("bitset_set") is False
    # and it re-arms at high again
    led.on_resize("a", 1500)
    assert p.should_shed("bitset_set") is True


def test_pressure_forecast_eta():
    led = MemLedger()
    clk = FakeClock()
    p = _pressure(led, clk, high=100_000, ewma_halflife_s=0.5)
    led.on_create("a", "bitset", 0)
    p.sample()
    # steady growth: 1000 bytes/second for 10 seconds
    for i in range(1, 11):
        clk.advance(1.0)
        led.on_resize("a", i * 1000)
        p.sample()
    fc = p.forecast()
    rate = fc["rate_bytes_s"]["total"]
    assert 500 < rate <= 1100  # EWMA converges toward 1000 B/s
    eta = fc["seconds_to_watermark"]
    assert eta is not None
    # ~90k headroom at ~1k/s
    assert 50 < eta < 200
    # flat usage: rate decays toward zero, eta eventually None or huge
    for _ in range(40):
        clk.advance(1.0)
        p.sample()
    fc2 = p.forecast()
    assert fc2["rate_bytes_s"]["total"] < rate / 4


# ---------------------------------------------------------------------------
# 4. report on a bare ledger
# ---------------------------------------------------------------------------

def test_report_stats_and_info_on_bare_ledger():
    led = MemLedger()
    led.on_create("a", "bitset", 1000, slot=1, tenant="t1")
    led.on_create("b", "hll", 3000, slot=2)
    led.register_meter("rc", lambda: 500, "cache")
    rep = MemoryReport(led)
    st = rep.memory_stats()
    assert st["dataset.bytes"] == 4000
    assert st["total.allocated"] == 4500
    assert st["peak.allocated"] >= st["dataset.bytes"]
    assert st["keys.count"] == 2
    assert st["keys.bytes-per-key"] == 2000
    assert st["bitset.bytes"] == 1000 and st["hll.bytes"] == 3000
    assert st["by_tenant"]["t1"] == 1000
    assert st["fragmentation"] == pytest.approx(4500 / 4000, rel=1e-3)
    info = rep.info_memory()
    assert info["used_memory"] == 4500
    assert info["used_memory_dataset"] == 4000
    assert info["used_memory_peak"] >= 4000
    assert info["maxmemory_policy"] == "noeviction"
    assert info["used_memory_human"].endswith("K")
    # usage falls back to the ledger entry when no store is wired
    assert rep.memory_usage("a") > 1000
    assert rep.memory_usage("ghost") is None


def test_report_doctor_rules():
    # empty instance
    led = MemLedger()
    rep = MemoryReport(led)
    doc = rep.memory_doctor()
    assert doc["findings"] == [] and "empty" in doc["message"]
    # orphaned scratch: meter bytes held with zero live state
    led.register_meter("leak", lambda: 4096, "scratch")
    doc = rep.memory_doctor()
    rules = [f["rule"] for f in doc["findings"]]
    assert "orphaned-scratch" in rules
    # cache dominating the dataset
    led2 = MemLedger()
    led2.on_create("a", "bitset", 100)
    led2.register_meter("rc", lambda: 10_000, "cache")
    rules2 = [f["rule"] for f in MemoryReport(led2).memory_doctor()["findings"]]
    assert "cache-dominates" in rules2
    # near-watermark via an attached pressure monitor
    led3 = MemLedger()
    led3.on_create("a", "bitset", 950)
    p = _pressure(led3, FakeClock(), high=1000)
    rules3 = [f["rule"] for f in
              MemoryReport(led3, pressure=p).memory_doctor()["findings"]]
    assert "near-watermark" in rules3


# ---------------------------------------------------------------------------
# 5. metrics registry (poisoned gauge regression)
# ---------------------------------------------------------------------------

def test_snapshot_drops_poisoned_gauge_and_counts_error():
    reg = MetricsRegistry()
    reg.gauge("good", lambda: 42)
    reg.gauge("poison", lambda: 1 // 0)
    snap = reg.snapshot()
    assert snap["gauges"]["good"] == 42
    # the raising gauge is DROPPED (no None poisoning downstream sums)
    assert "poison" not in snap["gauges"]
    # and the failure is visible in the SAME snapshot's counters
    assert snap["counters"]["metrics.callback_errors"] >= 1
    # subsequent snapshots keep counting
    reg.snapshot()
    assert reg.snapshot()["counters"]["metrics.callback_errors"] >= 3


# ---------------------------------------------------------------------------
# 6. client integration
# ---------------------------------------------------------------------------

def test_client_memory_parity_end_to_end():
    c = cpu_client(Config())
    try:
        h = c.get_hyper_log_log("mem:h")
        h.add_all([b"k%d" % i for i in range(100)])
        bs = c.get_bit_set("mem:b")
        bs.set(100)
        # MEMORY USAGE: one bank row per HLL name, exact bytes for bitset
        hu = c.memory_usage("mem:h")
        bu = c.memory_usage("mem:b")
        assert hu is not None and bu is not None
        obj = c._store.get("mem:b")
        assert bu > int(obj.state.nbytes)  # value + metadata overhead
        assert c.memory_usage("mem:ghost") is None
        st = c.memory_stats()
        assert st["dataset.bytes"] == c.memstat.live_bytes()
        assert st["bank.bytes"] > 0
        assert st["keys.count"] >= 2
        doc = c.memory_doctor()
        assert isinstance(doc["findings"], list)
        v = c.memory_verify()
        assert v["ok"], v
        assert v["drift_bytes"] == 0
        info = c.info("memory")["memory"]
        assert info["used_memory_dataset"] == c.memstat.live_bytes()
        full = c.info()
        assert {"server", "memory"} <= set(full)
        with pytest.raises(ValueError):
            c.info("replication")
        gauges = c.metrics.snapshot()["gauges"]
        assert gauges["memstat.live_bytes"] == c.memstat.live_bytes()
        assert gauges["memstat.keys"] == c.memstat.keys_count()
    finally:
        c.shutdown()


def test_client_memory_facade_requires_device_mode():
    c = cpu_client()
    try:
        c._memreport = None  # what the passthrough mode wires
        c.memstat = None
        with pytest.raises(RuntimeError, match="MEMORY USAGE"):
            c.memory_usage("x")
        with pytest.raises(RuntimeError):
            c.memory_verify()
    finally:
        c._memreport = None
        c.shutdown()


@pytest.mark.parametrize("hll_impl", ["scatter", "sort"])
def test_randomized_churn_zero_drift(hll_impl):
    """The tentpole invariant under randomized churn, on both HLL engine
    tiers: ledger == sum(live Array.nbytes) at every checkpoint, peak is
    monotone, and flushall returns the ledger to exactly zero."""
    cfg = Config()
    cfg.use_cuda(hll_impl=hll_impl)
    c = cpu_client(cfg)
    rng = random.Random(0xC0FFEE + hash(hll_impl) % 1000)
    try:
        live_bs = set()
        peak_seen = 0
        for step in range(60):
            roll = rng.random()
            if roll < 0.35:
                name = "churn:h%d" % rng.randrange(8)
                c.get_hyper_log_log(name).add(b"v%d" % step)
            elif roll < 0.65:
                name = "churn:b%d" % rng.randrange(8)
                c.get_bit_set(name).set(rng.randrange(4096))
                live_bs.add(name)
            elif roll < 0.8 and live_bs:
                name = live_bs.pop()
                c.delete(name)
            elif live_bs:
                src = rng.choice(sorted(live_bs))
                dst = "churn:rn%d" % rng.randrange(4)
                if c._store.exists(src):
                    c._store.rename(src, dst)
                    live_bs.discard(src)
                    live_bs.add(dst)
            if step % 15 == 14:
                v = c.memory_verify()
                assert v["ok"], (hll_impl, step, v)
                pk = c.memstat.peak_bytes()
                assert pk >= peak_seen
                assert pk >= c.memstat.live_bytes()
                peak_seen = pk
        v = c.memory_verify()
        assert v["ok"] and v["drift_bytes"] == 0, v
        c.flushall()
        assert c.memstat.live_bytes() == 0
        assert c.memory_verify()["ok"]
        # seeded leak: scratch bytes with zero live state -> doctor flags
        c.memstat.register_meter("seeded_leak", lambda: 8192, "scratch")
        rules = [f["rule"] for f in c.memory_doctor()["findings"]]
        assert "orphaned-scratch" in rules
    finally:
        c.shutdown()


def test_client_watermark_sheds_writes_reads_flow():
    cfg = Config()
    cfg.use_serve()
    mcfg = cfg.use_memstat()
    mcfg.high_watermark_bytes = 1  # anything live trips the gate
    mcfg.retry_after_s = 2.5
    c = cpu_client(cfg)
    try:
        bs = c.get_bit_set("wm:b")
        bs.set(7)  # admitted: ledger still empty at the gate
        with pytest.raises(RejectedError) as ei:
            bs.set(8)  # now live bytes >= 1 -> shed
        assert ei.value.reason == "memory"
        assert ei.value.retry_after_s == pytest.approx(2.5)
        # reads keep flowing while writes shed
        assert bs.get(7) is True
        assert bs.cardinality() == 1
        # and reclaiming writes are never shed
        assert c.delete("wm:b") is True
        snap = c.serve.snapshot()
        assert snap["memory"]["pressure"]["shed_total"] >= 1
        assert snap["memory"]["live_bytes"] == c.memstat.live_bytes()
    finally:
        c.shutdown()


def test_client_trace_exports_memstat_counters():
    cfg = Config()
    tc = cfg.use_trace()
    tc.sample_every = 1
    c = cpu_client(cfg)
    try:
        bs = c.get_bit_set("tr:mem")
        for i in range(8):
            bs.set(i)
        doc = c.trace.chrome_trace()
        counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
        assert counters, "no memstat counter events in the chrome trace"
        names = {e["name"] for e in counters}
        assert "memstat.live_bytes" in names
        live = [e for e in counters if e["name"] == "memstat.live_bytes"]
        # the closing sample reflects the current ledger
        assert live[-1]["args"]["bytes"] == c.memstat.live_bytes()
        assert all(e["cat"] == "memstat" for e in counters)
    finally:
        c.shutdown()


def test_executor_staging_accounting_drains():
    c = cpu_client(Config())
    try:
        bs = c.get_bit_set("stg:b")
        for i in range(32):
            bs.set(i)
        assert bs.cardinality() == 32
        # after the pipeline drains, no staged payload bytes remain held
        stats = c._executor.pipeline_stats()
        assert "staging_bytes" in stats
        assert c._executor.staging_bytes() == 0
    finally:
        c.shutdown()


def test_persist_disk_meter_reports_journal_bytes(tmp_path):
    cfg = Config()
    cfg.use_persist(str(tmp_path))
    c = cpu_client(cfg)
    try:
        bs = c.get_bit_set("pd:b")
        for i in range(16):
            bs.set(i)
        totals = c.memstat.meter_totals()
        assert totals["disk"] > 0  # journal segments on disk
        assert c.memory_stats()["disk.bytes"] == totals["disk"]
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 7. the port against the JAX package
# ---------------------------------------------------------------------------


def _pair(serve=False, high=0, low=0):
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "sort"
    tcfg = Config()
    tcfg.use_cuda(device="cpu", ingest="sort")
    if serve:
        # Renames of absent keys fail on purpose; no breaker opens on them.
        jcfg.use_serve().breaker_failure_threshold = 1 << 30
        tcfg.use_serve().breaker_failure_threshold = 1 << 30
    if high:
        jm = jcfg.use_memstat()
        jm.high_watermark_bytes, jm.low_watermark_bytes = high, low
        jm.include_overhead = False
        tcfg.use_memstat(high_watermark_bytes=high, low_watermark_bytes=low,
                         include_overhead=False)
    return RedissonTPU.create(jcfg), RedissonTorch.create(tcfg)


def _steps(seed):
    """A seeded op sequence: HLL, BitSet and Bloom creates, SETBIT growth,
    deletes, renames (some clobbering), a flushall midway."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(70):
        r = int(rng.integers(100))
        n = int(rng.integers(6))
        if step == 40:
            out.append(("flushall",))
        elif r < 25:
            out.append(("hll", f"h{n}", rng.integers(0, 2**63, 200, dtype=np.uint64)))
        elif r < 50:
            out.append(("setbit", f"b{n}", int(rng.integers(0, 1 << int(rng.integers(4, 20))))))
        elif r < 62:
            out.append(("bloom", f"f{n}", int(rng.integers(100, 50000))))
        elif r < 80:
            out.append(("delete", ("h", "b", "f")[int(rng.integers(3))] + str(n)))
        else:
            kind = ("h", "b", "f")[int(rng.integers(3))]
            out.append(("rename", kind + str(n), kind + str(int(rng.integers(6)))))
    return out


def _apply(c, step):
    op = step[0]
    if op == "hll":
        return c.get_hyper_log_log(step[1]).add_ints(step[2])
    if op == "setbit":
        return c.get_bit_set(step[1]).set(step[2])
    if op == "bloom":
        return c.get_bloom_filter(step[1]).try_init(step[2], 0.01)
    if op == "delete":
        return c.delete(step[1])
    if op == "rename":
        try:
            return c._dispatch.execute_sync(step[1], "rename", {"newkey": step[2]})
        except KeyError:
            return "nokey"
    c.flushall()
    return None


def _view(c, names):
    led = c.memstat
    return {
        "entries": {n: led.entry(n) for n in sorted(set(names) | {BANK_ENTRY})},
        "kind_bytes": led.kind_bytes(),
        "live": led.live_bytes(),
        "usage": {n: c.memory_usage(n) for n in sorted(names)},
        "dataset": c.memory_stats()["dataset.bytes"],
    }


def test_ledger_matches_jax_step_by_step():
    jc, tc = _pair()
    names = [f"{k}{i}" for k in "hbf" for i in range(6)]
    try:
        for i, step in enumerate(_steps(7)):
            assert _apply(tc, step) == _apply(jc, step), (i, step)
            v = tc.memory_verify()
            assert v["ok"] and v["drift_bytes"] == 0, (i, step, v)
            assert _view(tc, names) == _view(jc, names), (i, step)
    finally:
        jc.shutdown()
        tc.shutdown()


def test_ledger_after_from_jax_state_matches_jax():
    """The JAX state installed into the port: the same ledger and MEMORY
    USAGE, and no drift."""
    jc, tc = _pair()
    names = [f"{k}{i}" for k in "hbf" for i in range(6)]
    try:
        for step in _steps(11)[:40]:
            _apply(jc, step)
        tc.get_bit_set("stale").set(5)  # replaced by the install
        jb = jc._routing.sketch
        objects = {n: jc._executor.execute_sync(n, "bits_export", None)
                   for n in jc._store.keys()}
        tc.from_jax_state(np.asarray(jb.bank), dict(jb._rows), objects)
        v = tc.memory_verify()
        assert v["ok"] and v["drift_bytes"] == 0, v
        assert _view(tc, names + ["stale"]) == _view(jc, names + ["stale"])
    finally:
        jc.shutdown()
        tc.shutdown()


def _shed_run(c, rejected, steps):
    """Outcomes ("ok" or the reject reason) and live bytes before each step."""
    got, live = [], []
    for step in steps:
        live.append(c.memstat.live_bytes())
        try:
            _apply(c, step)
            got.append("ok")
        except rejected as exc:
            got.append(exc.reason)
    return got, live


def test_both_shed_at_the_same_op_under_one_watermark():
    """One watermark, one seeded sequence: the port sheds exactly the ops
    JAX sheds (on the ledger's total alone: the write that carries it
    across the high mark is admitted, the writes after it are shed until
    deletes bring it below the low mark), with the same ledger before
    every op and the same shed count."""
    high = 2 * 256 * 16384 * 4  # two banks' worth: crossed by bitmap growth
    steps = [("setbit", s[1], s[2] << 6) if s[0] == "setbit" else s  # bigger growth
             for s in _steps(3)[:60]]
    jc, tc = _pair(serve=True, high=high, low=high // 2)
    try:
        jgot, jlive = _shed_run(jc, JRejectedError, steps)
        tgot, tlive = _shed_run(tc, RejectedError, steps)
        assert tgot == jgot and tlive == jlive
        assert (tc.serve.snapshot()["memory"]["pressure"]["shed_total"]
                == jc.serve.snapshot()["memory"]["pressure"]["shed_total"] > 0)
        k = tgot.index("memory")
        assert tlive[k - 1] < high <= tlive[k]  # the crossing write was admitted
        assert "ok" in tgot[k:]
    finally:
        jc.shutdown()
        tc.shutdown()


@pytest.mark.parametrize("seed,high_banks,low_banks", [
    (5, 2, 1), (8, 2, 1), (13, 3, 2), (21, 2, 0), (34, 1, 0), (55, 3, 1), (89, 2, 2)])
def test_watermark_decisions_match_jax(seed, high_banks, low_banks):
    """Seeded sequences under several (high, low) marks, in banks' worth
    of bytes (low 0 = the high mark as in JAX): every op's outcome, the
    ledger before it and the shed total equal the JAX client's."""
    bank = 256 * 16384 * 4
    steps = [("setbit", s[1], s[2] << 6) if s[0] == "setbit" else s
             for s in _steps(seed)]
    jc, tc = _pair(serve=True, high=high_banks * bank, low=low_banks * bank)
    try:
        jgot, jlive = _shed_run(jc, JRejectedError, steps)
        tgot, tlive = _shed_run(tc, RejectedError, steps)
        assert tgot == jgot and tlive == jlive
        assert (tc.serve.snapshot()["memory"]["pressure"]["shed_total"]
                == jc.serve.snapshot()["memory"]["pressure"]["shed_total"])
        assert tc.memory_verify()["ok"]
    finally:
        jc.shutdown()
        tc.shutdown()


@pytest.mark.parametrize("grow", [False, True], ids=["new-key", "grow-key"])
def test_setbit_at_the_watermark_is_shed_before_it_allocates(grow):
    """At the high watermark a SETBIT, on a new key or a growing one, is
    shed before the backend allocates; reads flow; a delete that leaves
    the total between the marks keeps shedding; below the low mark the
    write is admitted."""
    cfg = Config()
    cfg.use_serve()
    cfg.use_memstat(high_watermark_bytes=5 << 20, low_watermark_bytes=2 << 20,
                    include_overhead=False)
    c = cpu_client(cfg)
    target = "g:a" if grow else "g:b"
    try:
        c.get_bit_set("g:a").set((1 << 20) - 1)  # 1 MiB of cells
        c.get_bit_set("g:f").set((2 << 20) - 1)  # 2 MiB
        c.get_bit_set("g:c").set((2 << 20) - 1)  # 2 MiB more: at the mark
        live = c.memstat.live_bytes()
        with pytest.raises(RejectedError) as ei:
            c.get_bit_set(target).set((3 << 20) - 1)
        assert ei.value.reason == "memory"
        assert c.memstat.live_bytes() == live  # nothing allocated
        assert c.get_bit_set("g:a").length() == 1 << 20
        assert c._store.get("g:b") is None
        assert c.get_bit_set("g:a").cardinality() == 1  # reads flow
        assert c.serve.snapshot()["memory"]["pressure"]["shedding"]
        c.delete("g:f")  # reclaim kinds pass: 3 MiB live, between the marks
        with pytest.raises(RejectedError):
            c.get_bit_set(target).set((3 << 20) - 1)
        c.delete("g:c")  # 1 MiB live: below the low mark
        c.get_bit_set(target).set((3 << 20) - 1)
        assert c.get_bit_set(target).get((3 << 20) - 1)
        assert not c.serve.snapshot()["memory"]["pressure"]["shedding"]
        assert c.memory_verify()["ok"]
    finally:
        c.shutdown()


def test_pressure_snapshot_reads_the_devices_memory():
    """A deliberate difference from JAX: the pressure snapshot says how much
    memory the device has (`device_memory`: torch.cuda on a card, the
    configured capacity on the CPU); the gate never reads it."""
    from redisson_tpu_torch.memstat.pressure import device_memory

    assert device_memory("cpu", 123) == {
        "source": "config", "total_bytes": 123, "free_bytes": None,
        "allocated_bytes": None, "reserved_bytes": None}
    cfg = Config()
    cfg.use_memstat(high_watermark_bytes=1 << 30)
    c = cpu_client(cfg)
    try:
        assert c._pressure.snapshot()["device"] == device_memory("cpu", 1 << 30)
        assert c.serve is None or "device" in c.serve.snapshot()["memory"]["pressure"]
    finally:
        c.shutdown()
