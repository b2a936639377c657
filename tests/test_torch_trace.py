"""trace/ of the port on the CPU: the counterpart of every test of
tests/test_trace.py (spans and the sampling tracer, the histograms,
SLOWLOG / MONITOR / LATENCY, the exports, the manager, and the client
end to end with the executor's and the journal's stamps), then the port
held against the JAX package: the same ops sampled for a seed and a
stride, equal histogram buckets over a sweep, and identical stage
breakdowns and Chrome traces from identical marks.

All port clients run on `Config().use_cuda(device="cpu")`.
"""

import json

import numpy as np
import pytest

from redisson_tpu.client import RedissonTPU
from redisson_tpu.config import Config as JConfig
from redisson_tpu.trace import export as jexport
from redisson_tpu.trace import hist as jhist
from redisson_tpu.trace import spans as jspans
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.fault import inject
from redisson_tpu_torch.trace import (HistogramSet, LatencyHistogram, Monitor,
                                      SlowLog, TraceManager, Tracer,
                                      chrome_trace, format_event,
                                      prometheus_exposition, stage_breakdown)
from redisson_tpu_torch.trace import export as texport
from redisson_tpu_torch.trace import spans as tspans
from redisson_tpu_torch.trace.hist import bucket_index, bucket_upper_ticks
from redisson_tpu_torch.trace.manager import LatencyEvents

#: tests of tests/test_trace.py with no counterpart here, and why (none:
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


@pytest.fixture(autouse=True)
def _clean_injector():
    inject.uninstall()
    yield
    inject.uninstall()


# ---------------------------------------------------------------------------
# 1. spans + tracer
# ---------------------------------------------------------------------------

def test_span_lifecycle_and_stage_breakdown():
    clk = FakeClock()
    tr = Tracer(clock=clk, sample_every=1)
    tr.annotate_next(admitted_at=clk.t)
    clk.advance(0.001)
    s = tr.maybe_begin("hll_add", "t:h", nkeys=4)
    assert s is not None
    clk.advance(0.002)
    s.event("dispatched")
    clk.advance(0.003)
    s.event("journaled")
    clk.advance(0.004)
    s.event("staged")
    clk.advance(0.005)
    s.event("completed")
    s.finish()
    st = s.stages()
    assert st["admission"] == pytest.approx(0.001)
    assert st["queue"] == pytest.approx(0.002)
    assert st["journal"] == pytest.approx(0.003)
    assert st["stage"] == pytest.approx(0.004)
    assert st["device"] == pytest.approx(0.005)
    assert st["total"] == pytest.approx(0.015)
    assert s.duration_s == pytest.approx(0.015)
    assert s.t1 == pytest.approx(0.015)
    d = s.to_dict()
    assert d["kind"] == "hll_add" and d["stages"]["journal"] == st["journal"]


def test_missing_marks_collapse_into_next_stage():
    # No journal configured: the dispatched->completed gap is all "device"
    # via the staged mark's absence collapsing into the next present one.
    clk = FakeClock()
    tr = Tracer(clock=clk, sample_every=1)
    s = tr.maybe_begin("get", "t")
    clk.advance(0.001)
    s.event("dispatched")
    clk.advance(0.010)
    s.event("completed")
    s.finish()
    st = s.stages()
    assert "journal" not in st and "stage" not in st
    assert st["device"] == pytest.approx(0.010)


def test_sampling_stride_is_deterministic():
    def run():
        tr = Tracer(clock=FakeClock(), sample_every=4, seed=2)
        hits = [i for i in range(16)
                if tr.maybe_begin("k", "t") is not None]
        return hits, tr.sampled, tr.skipped

    hits, sampled, skipped = run()
    assert hits == [2, 6, 10, 14]
    assert sampled == 4 and skipped == 12
    assert run() == (hits, sampled, skipped)  # reproducible under the seed


def test_ring_is_bounded_and_finish_idempotent():
    tr = Tracer(clock=FakeClock(), sample_every=1, ring=8)
    spans = []
    for _ in range(20):
        s = tr.maybe_begin("k", "t")
        s.finish()
        s.finish()  # double finish must not double-count
        spans.append(s)
    assert len(tr.ring()) == 8
    assert tr.finished == 20
    assert tr.ring()[-1] is spans[-1]


def test_pending_annotations_never_leak_across_ops():
    tr = Tracer(clock=FakeClock(), sample_every=2, seed=0)
    assert tr.maybe_begin("k", "t") is not None  # i=0 sampled
    tr.annotate_next(admitted_at=0.5, attempt=3)
    assert tr.maybe_begin("k", "t") is None  # i=1 unsampled, consumes pending
    s2 = tr.maybe_begin("k", "t")  # i=2 sampled
    assert "attempt" not in s2.annotations
    assert s2.first("admitted") is None


def test_admitted_at_extends_span_start():
    clk = FakeClock(t=10.0)
    tr = Tracer(clock=clk, sample_every=1)
    tr.annotate_next(admitted_at=9.5, attempt=1)
    s = tr.maybe_begin("k", "t")
    assert s.t0 == pytest.approx(9.5)
    assert s.first("admitted") == pytest.approx(9.5)
    assert s.annotations["attempt"] == 1


def test_sink_errors_never_propagate():
    tr = Tracer(clock=FakeClock(), sample_every=1)
    tr.add_sink(lambda span: 1 / 0)
    s = tr.maybe_begin("k", "t")
    s.finish()  # must not raise
    assert tr.finished == 1


# ---------------------------------------------------------------------------
# 1b. histograms
# ---------------------------------------------------------------------------

def test_bucket_index_roundtrip_and_monotone():
    prev = 0
    for ticks in list(range(0, 5000)) + [10 ** 5, 10 ** 6, 10 ** 8]:
        idx = bucket_index(ticks)
        assert idx >= prev
        assert bucket_upper_ticks(idx) >= ticks
        assert bucket_index(bucket_upper_ticks(idx)) == idx
        prev = idx


def test_quantile_error_bound():
    h = LatencyHistogram()
    vals = [i * 0.0001 for i in range(1, 1001)]  # 0.1ms .. 100ms
    for v in vals:
        h.record(v)
    for q in (0.50, 0.95, 0.99, 0.999):
        exact = vals[max(0, int(q * len(vals) + 0.999999) - 1)]
        est = h.quantile(q)
        assert est >= exact - 1e-6  # upper-bound estimator
        assert est <= exact * 1.04 + 1e-6  # 2^-5 sub-bucket error (~3.1%)


def test_histogram_merge_equals_combined():
    a, b, c = LatencyHistogram(), LatencyHistogram(), LatencyHistogram()
    va = [0.001 * i for i in range(1, 100)]
    vb = [0.01 * i for i in range(1, 50)]
    for v in va:
        a.record(v)
        c.record(v)
    for v in vb:
        b.record(v)
        c.record(v)
    a.merge(b)
    assert a.count == c.count
    assert a.sum_s == pytest.approx(c.sum_s)
    assert a.min_s == c.min_s and a.max_s == c.max_s
    for q in (0.5, 0.9, 0.99):
        assert a.quantile(q) == c.quantile(q)


def test_histogram_set_keying_and_merged_views():
    hs = HistogramSet()
    hs.record("get", "tenant_a", 0.001)
    hs.record("get", "tenant_b", 0.002)
    hs.record("put", "tenant_a", 0.003)
    assert hs.get("get", "tenant_a").count == 1
    assert hs.kinds() == ["get", "put"]
    assert hs.merged("get").count == 2  # across tenants
    assert hs.merged().count == 3  # global
    snap = hs.snapshot()
    assert snap["get|tenant_a"]["count"] == 1


# ---------------------------------------------------------------------------
# 1c. slowlog
# ---------------------------------------------------------------------------

def _finished_span(journal_s=0.0, device_s=0.001, kind="hll_add"):
    clk = FakeClock()
    tr = Tracer(clock=clk, sample_every=1)
    s = tr.maybe_begin(kind, "t")
    clk.advance(0.0005)
    s.event("dispatched")
    clk.advance(journal_s)
    s.event("journaled")
    clk.advance(device_s)
    s.event("completed")
    s.finish()
    return s


def test_slowlog_threshold_and_stage_attribution():
    slog = SlowLog(threshold_s=0.010, maxlen=4)
    assert slog.offer(_finished_span(0.0, 0.001)) is None  # fast: ignored
    e = slog.offer(_finished_span(journal_s=0.050, device_s=0.002))
    assert e is not None
    assert e.worst_stage == "journal"
    assert e.stages["journal"] >= 0.5 * e.duration_s
    assert e.to_dict()["worst_stage"] == "journal"


def test_slowlog_newest_first_bounded_reset():
    slog = SlowLog(threshold_s=0.001, maxlen=3)
    for _ in range(5):
        assert slog.offer(_finished_span(device_s=0.01)) is not None
    assert len(slog) == 3
    assert slog.total_logged == 5
    ids = [e.entry_id for e in slog.get()]
    assert ids == sorted(ids, reverse=True)  # newest first
    assert slog.get(2) == slog.get()[:2]
    slog.reset()
    assert len(slog) == 0
    assert slog.total_logged == 5  # lifetime counter survives reset


# ---------------------------------------------------------------------------
# 1d. monitor
# ---------------------------------------------------------------------------

def test_monitor_drop_and_count_never_blocks():
    m = Monitor(default_maxlen=4)
    m.publish({"i": -1})  # no subscribers: free no-op
    assert m.published == 0
    tap = m.subscribe()
    for i in range(6):
        m.publish({"i": i})
    assert len(tap) == 4
    assert tap.dropped == 2
    assert m.dropped() == 2
    assert [e["i"] for e in tap.poll()] == [0, 1, 2, 3]
    m.unsubscribe(tap)
    assert m.active() == 0
    assert m.dropped() == 2  # folded into the monitor's lifetime total
    assert not tap.offer({"i": 9})  # closed tap refuses events


def test_monitor_format_event():
    line = format_event({"ts": 1.5, "tenant": "", "kind": "hll_add",
                         "target": "t:h", "nkeys": 3, "event": "enqueue"})
    assert line == '1.500000 [-] "HLL_ADD" "t:h" 3 (enqueue)'


# ---------------------------------------------------------------------------
# 1e. LATENCY parity
# ---------------------------------------------------------------------------

def test_latency_events_threshold_history_reset_doctor():
    clk = FakeClock()
    lat = LatencyEvents(threshold_s=0.100, history_len=3, clock=clk)
    assert not lat.observe("device", 0.050)  # below threshold
    for d in (0.2, 0.3, 0.4, 0.5):
        clk.advance(1.0)
        assert lat.observe("journal_fsync", d)
    hist = lat.history("journal_fsync")
    assert len(hist) == 3  # bounded ring
    assert [d for _, d in hist] == [0.3, 0.4, 0.5]
    assert lat.latest()["journal_fsync"][2] == pytest.approx(0.5)
    report = lat.doctor()
    assert "journal_fsync" in report and "Worst offender" in report
    assert lat.reset("journal_fsync") == 1
    assert "no latency spikes" in lat.doctor()


# ---------------------------------------------------------------------------
# 2. exports
# ---------------------------------------------------------------------------

def test_chrome_trace_schema_and_window():
    clk = FakeClock()
    tr = Tracer(clock=clk, sample_every=1)
    s = tr.maybe_begin("hll_add", "t:h", nkeys=2)
    clk.advance(0.001)
    s.event("stolen")
    s.event("dispatched")
    clk.advance(0.002)
    s.event("completed")
    s.finish()
    doc = chrome_trace([s])
    json.dumps(doc)  # must be JSON-serializable as-is
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert all({"name", "ph", "ts", "pid", "tid"} <= set(e) for e in evs)
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    ops = [e for e in evs if e["ph"] == "X" and e["cat"] == "op"]
    assert len(ops) == 1 and ops[0]["name"] == "hll_add"
    assert ops[0]["dur"] == pytest.approx(3000.0)  # 3ms in us
    marks = [e for e in evs if e["ph"] == "i"]
    assert [m["name"] for m in marks] == ["stolen"]
    stages = [e for e in evs if e["cat"] == "stage"]
    assert {e["name"] for e in stages} == {"hll_add:queue", "hll_add:device"}
    # window clipping: a window entirely before the span excludes it
    assert chrome_trace([s], t0=10.0)["traceEvents"] == []
    # unfinished spans are skipped
    open_span = tr.maybe_begin("get", "t")
    assert open_span is not None
    assert len(chrome_trace([open_span])["traceEvents"]) == 0


def test_prometheus_exposition_shape():
    hs = HistogramSet()
    hs.record("get", "", 0.0005)
    hs.record("get", "", 0.05)
    text = prometheus_exposition(hs, bounds_s=(0.001, 0.1))
    assert "# TYPE trace_op_latency_seconds histogram" in text
    assert ('trace_op_latency_seconds_bucket{kind="get",tenant="",'
            'le="0.001"} 1') in text
    assert ('trace_op_latency_seconds_bucket{kind="get",tenant="",'
            'le="0.1"} 2') in text
    assert ('trace_op_latency_seconds_bucket{kind="get",tenant="",'
            'le="+Inf"} 2') in text
    assert 'trace_op_latency_seconds_count{kind="get",tenant=""} 2' in text
    assert 'le="inf"' not in text


# ---------------------------------------------------------------------------
# 2b. manager fan-out (fake clock)
# ---------------------------------------------------------------------------

def test_manager_fanout_hist_slowlog_monitor():
    from types import SimpleNamespace

    clk = FakeClock()
    cfg = SimpleNamespace(sample_every=1, slowlog_threshold_ms=1.0)
    mgr = TraceManager(cfg, clock=clk)
    tap = mgr.monitor.subscribe()
    s = mgr.begin_op("hll_add", "t:h", nkeys=2)
    assert s is not None
    clk.advance(0.002)
    s.event("completed")
    s.finish()
    assert mgr.hist.get("hll_add", "").count == 1
    assert len(mgr.slowlog) == 1  # 2ms > 1ms threshold
    assert [e["event"] for e in tap.poll()] == ["enqueue", "complete"]
    cs = mgr.commandstats()
    assert cs["cmdstat_hll_add"]["calls"] == 1
    assert cs["cmdstat_hll_add"]["usec"] == pytest.approx(2000.0, rel=0.05)
    snap = mgr.snapshot()
    assert snap["tracer"]["sampled"] == 1
    assert snap["slowlog"]["len"] == 1


def test_manager_retry_and_fsync_hooks():
    from types import SimpleNamespace

    clk = FakeClock()
    mgr = TraceManager(SimpleNamespace(sample_every=1), clock=clk)
    tap = mgr.monitor.subscribe()
    mgr.retry_event("hll_add", "t", "", attempt=1, delay_s=0.005)
    assert mgr.retries == 1
    assert [e["event"] for e in tap.poll()] == ["retry"]
    mgr.record_fsync(0.150)  # above the 100ms LATENCY threshold
    assert mgr.fsync_hist.get("journal_fsync", "").count == 1
    assert len(mgr.latency.history("journal_fsync")) == 1
    assert "journal_fsync" in mgr.render_prometheus()


# ---------------------------------------------------------------------------
# 3. integration: real client
# ---------------------------------------------------------------------------

def test_client_trace_end_to_end():
    cfg = Config()
    tc = cfg.use_trace()
    tc.sample_every = 1
    c = cpu_client(cfg)
    try:
        h = c.get_hyper_log_log("tr:e2e")
        h.add_all([b"k%d" % i for i in range(64)])
        assert h.count() > 0
        assert h.count() > 0  # second count rides the read cache
        snap = c.trace.snapshot()
        assert snap["tracer"]["sampled"] >= 3
        ops = [s for s in c.trace.tracer.ring() if s.span_type == "op"]
        assert ops and all(s.t1 is not None for s in ops)
        names = {n for s in ops for n, _ in s.events}
        assert {"queued", "dispatched", "completed"} <= names
        assert any(s.annotations.get("read_cache") == "hit" for s in ops)
        doc = c.trace.chrome_trace()
        json.dumps(doc)
        assert doc["traceEvents"]
        assert 'le="+Inf"' in c.trace.render_prometheus()
        assert "cmdstat_hll_add" in c.trace.commandstats()
        gauges = c.metrics.snapshot()["gauges"]
        assert gauges["trace.sampled"] >= 3
        assert gauges["trace.spans_finished"] >= 3
    finally:
        c.shutdown()


def test_client_trace_export_chrome(tmp_path):
    cfg = Config()
    cfg.use_trace().sample_every = 1
    c = cpu_client(cfg)
    try:
        c.get_hyper_log_log("tr:x").add_all([b"a", b"b"])
        path = str(tmp_path / "trace.json")
        n = c.trace.export_chrome(path)
        assert n > 0
        with open(path) as f:
            doc = json.load(f)
        assert len(doc["traceEvents"]) == n
    finally:
        c.shutdown()


def test_journal_stall_attributed_to_journal_stage(tmp_path):
    cfg = Config()
    cfg.use_cuda(device="cpu")
    pc = cfg.use_persist(str(tmp_path))
    pc.fsync = "always"
    pc.group_commit_runs = 1
    tc = cfg.use_trace()
    tc.sample_every = 1
    tc.slowlog_threshold_ms = 5.0
    fc = cfg.use_faults()
    # Stall (not fail) the SECOND fsync: the first add warms the kernel
    # cache so compile time can't drown out the journal stage.
    fc.plan = [{"seam": "journal_fsync", "fault": "stall", "nth": 2,
                "times": 2, "delay_s": 0.08}]
    c = cpu_client(cfg)
    try:
        h = c.get_hyper_log_log("tr:stall")
        h.add_all([b"warm%d" % i for i in range(8)])  # fsync #1, no stall
        c.trace.slowlog.reset()
        h.add_all([b"hot%d" % i for i in range(8)])  # fsync #2: stalled
        h.count()
        entries = c.trace.slowlog.get()
        assert entries, "stalled op never crossed the slowlog threshold"
        worst = max(entries, key=lambda e: e.duration_s)
        assert worst.worst_stage == "journal"
        assert worst.stages["journal"] >= 0.5 * worst.duration_s
        assert worst.duration_s >= 0.08
        # the fsync histogram saw the stall too (unsampled-path hook)
        fh = c.trace.fsync_hist.get("journal_fsync", "")
        assert fh is not None and fh.max_s >= 0.08
    finally:
        c.shutdown()


def test_trace_disabled_costs_nothing():
    c = cpu_client()
    try:
        assert c.trace is None
        assert getattr(c._executor, "trace", "missing") is None
        c.get_hyper_log_log("tr:off").add_all([b"a"])
        assert "trace.sampled" not in c.metrics.snapshot()["gauges"]
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# 4. the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,seed", [(1, 0), (3, 1), (128, 0), (128, 77), (7, 12)])
def test_same_ops_sampled_as_jax(stride, seed):
    jt = jspans.Tracer(clock=FakeClock(), sample_every=stride, seed=seed)
    tt = Tracer(clock=FakeClock(), sample_every=stride, seed=seed)
    kinds = ["hll_add", "hll_count", "bitset_set", "bloom_add"]
    js, ts = [], []
    for i in range(1000):
        if i % 5 == 0:  # the serve layer's handoff, on some ops only
            jt.annotate_next(admitted_at=0.0, attempt=1)
            tt.annotate_next(admitted_at=0.0, attempt=1)
        a = jt.maybe_begin(kinds[i % 4], f"t{i % 9}", "", i)
        b = tt.maybe_begin(kinds[i % 4], f"t{i % 9}", "", i)
        js.append(None if a is None else (a.span_id, a.kind, a.target,
                                          dict(a.annotations), list(a.events)))
        ts.append(None if b is None else (b.span_id, b.kind, b.target,
                                          dict(b.annotations), list(b.events)))
    assert ts == js
    assert tt.snapshot() == jt.snapshot()


def test_bucket_ladder_matches_jax():
    ticks = sorted({0, 1, 2, 31, 32, 33, 63, 64, 65, 1000, 4095, 4096, 10**6,
                    10**9, 2**40 - 1, 2**40}
                   | set(np.random.default_rng(0).integers(0, 2**36, 2000).tolist()))
    assert [bucket_index(t) for t in ticks] == [jhist.bucket_index(t) for t in ticks]
    idx = list(range(0, 2000))
    assert ([bucket_upper_ticks(i) for i in idx]
            == [jhist.bucket_upper_ticks(i) for i in idx])
    rng = np.random.default_rng(1)
    jh, th = jhist.LatencyHistogram(), LatencyHistogram()
    for v in rng.exponential(0.003, 5000).tolist():
        jh.record(v)
        th.record(v)
    assert th.snapshot() == jh.snapshot()
    bounds = texport.DEFAULT_BOUNDS_S
    assert th.cumulative(bounds) == jh.cumulative(bounds)


def _replay_marks(mod, clock, rng_seed):
    """Identical marks through one package's Tracer: op spans (some with an
    admission stamp, some failing, some without a journal mark) under run
    spans, and the Chrome trace of the lot."""
    rng = np.random.default_rng(rng_seed)
    tr = mod.Tracer(clock=clock, sample_every=1)
    spans = []
    for r in range(6):
        run = tr.begin_run("hll_add", f"t{r}", nops=3, nkeys=30)
        for j in range(3):
            if j != 1:
                tr.annotate_next(admitted_at=clock.t)
                clock.advance(float(rng.uniform(1e-5, 1e-4)))
            s = tr.maybe_begin("hll_add", f"t{r}", "tenant-%d" % j, 10)
            s.run_id = run.span_id
            for mark in ("dispatched", "journaled", "staged", "completed"):
                if mark == "journaled" and r % 2:
                    continue
                clock.advance(float(rng.uniform(1e-5, 5e-3)))
                s.event(mark)
            if j == 2 and r == 3:
                s.annotate(fault="RetryableFault", seam="kernel_launch")
                s.finish(error="RetryableFault")
            else:
                s.finish()
            spans.append(s)
        run.event("completed")
        run.finish()
    return spans, tr


def test_stage_breakdown_and_chrome_trace_match_jax():
    jspans_, jtr = _replay_marks(jspans, FakeClock(10.0), 5)
    tspans_, ttr = _replay_marks(tspans, FakeClock(10.0), 5)
    assert ([tspans.stage_breakdown(s) for s in tspans_]
            == [jspans.stage_breakdown(s) for s in jspans_])
    assert [s.to_dict() for s in tspans_] == [s.to_dict() for s in jspans_]
    counters = [("memstat.live_bytes", 10.5, 1234), ("memstat.cache_bytes", 10.6, 7)]
    for window in ((None, None), (10.01, 10.05)):
        assert (chrome_trace(ttr.ring(), *window, counters=counters)
                == jexport.chrome_trace(jtr.ring(), *window, counters=counters))


def test_prometheus_exposition_matches_jax():
    rng = np.random.default_rng(3)
    js, ts = jhist.HistogramSet(), HistogramSet()
    for i, v in enumerate(rng.exponential(0.01, 3000).tolist()):
        key = (("hll_add", "hll_count")[i % 2], ("", "t1", "t2")[i % 3])
        js.record(*key, v)
        ts.record(*key, v)
    assert prometheus_exposition(ts) == jexport.prometheus_exposition(js)


def test_client_samples_the_same_ops_as_jax():
    """The same op stream through both clients at stride 3: the executor
    samples the same (kind, target) sequence, and the spans carry the same
    pipeline marks."""
    jcfg = JConfig()
    jcfg.use_tpu().ingest = "sort"
    jcfg.use_trace().sample_every = 3
    tcfg = Config()
    tcfg.use_cuda(device="cpu", ingest="sort")
    tcfg.use_trace(sample_every=3)
    jc, tc = RedissonTPU.create(jcfg), RedissonTorch.create(tcfg)
    try:
        for c in (jc, tc):
            for i in range(20):
                h = c.get_hyper_log_log(f"s:{i % 4}")
                h.add_ints(np.arange(i * 100, i * 100 + 100, dtype=np.uint64))
                if i % 3 == 0:
                    h.count()
            c.get_bit_set("s:b").set_bits([1, 5, 9])
        spans = []
        for c in (jc, tc):
            ops = sorted((s for s in c.trace.tracer.ring() if s.span_type == "op"),
                         key=lambda s: s.span_id)
            spans.append([(s.span_id, s.kind, s.target, s.nkeys,
                           [n for n, _ in s.events]) for s in ops])
        assert spans[1] == spans[0] and spans[0]
    finally:
        jc.shutdown()
        tc.shutdown()
