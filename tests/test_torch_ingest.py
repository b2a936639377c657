"""The ingest subsystem of the port on the CPU: the JAX package's corpus
tests/test_ingest.py runs against the port's planner
(`redisson_tpu_torch/ingest/planner.py`), staging pipeline
(`ingest/pipeline.py`) and BITCOUNT partial combines past 2^31.

The corpus runs through `port_corpus` (tests/test_torch_interop.py) with
`CPU_ALIASES` (its client and config on `use_cuda(device="cpu")`) and its
`IngestPlanner` on the CPU (`CpuPlanner`): the port's planner takes the
device it times on, with no default, and its `measure` seam takes that
device as a third argument. Its `StagingPipeline` is `TracedPipeline`,
which records the corpus's stage / dispatch trace around the port's
pipeline (the port's takes no `trace` argument). The tests that run a
Pallas kernel in interpret mode, or call jax, are in `EXCLUDED` with the
port test that holds the same kernel against its plain version; so is
the test of JAX's `plan(forced=...)` argument, which the port's planner
does not take (the backend decides a forced ingest before it asks the
planner).
"""

import dataclasses
import time

import numpy as np

from redisson_tpu_torch.ingest.pipeline import StagingPipeline
from redisson_tpu_torch.ingest.planner import IngestPlan, IngestPlanner
from tests import test_ingest
from tests.test_torch_interop import CPU_ALIASES, corpus_tests, port_corpus


@dataclasses.dataclass(frozen=True)
class CpuPlan(IngestPlan):
    """JAX's plan also says whether its costs were measured (False only
    under `forced`): here, whether the port's plan carries costs."""

    measured: bool = True


class CpuPlanner(IngestPlanner):
    """The corpus's `IngestPlanner(platform=..., measure=...)`: the port's
    planner on the CPU, calling the corpus's `measure(structure, n)`."""

    def __init__(self, platform=None, measure=None):
        super().__init__("cpu", None if measure is None
                         else lambda structure, n, _device: measure(structure, n))

    def plan(self, *args, **kwargs) -> CpuPlan:
        plan = super().plan(*args, **kwargs)
        return CpuPlan(plan.path, plan.costs, measured=bool(plan.costs))


class TracedPipeline(StagingPipeline):
    """The corpus's `StagingPipeline(depth, trace=...)`: the port's
    pipeline, with (event, index, perf_counter) marks around each chunk's
    stage (on the worker) and dispatch (on the caller)."""

    def __init__(self, depth: int = 2, trace=None):
        super().__init__(depth)
        self.trace = trace

    def run(self, chunks, stage, dispatch):
        if self.trace is None:
            return super().run(chunks, stage, dispatch)
        mark = lambda ev, i: self.trace.append((ev, i, time.perf_counter()))

        def traced_stage(item):
            i, chunk = item
            mark("stage_start", i)
            staged = stage(chunk)
            mark("stage_end", i)
            return staged

        def traced_dispatch(i, staged):
            mark("dispatch_start", i)
            out = dispatch(i, staged)
            mark("dispatch_end", i)
            return out

        return super().run(enumerate(chunks), traced_stage, traced_dispatch)


_KERNELS = "tests/test_torch_kernels.py::"

#: tests of tests/test_ingest.py with no counterpart run unchanged, and why
EXCLUDED = {
    "test_hll_segmented_matches_golden_oracle":
        "runs the Pallas insert in interpret mode; see "
        + _KERNELS + "test_segmented_insert_plain_matches_pallas",
    "test_hll_segmented_matches_lax_fallback":
        "runs the Pallas insert in interpret mode; see "
        + _KERNELS + "test_segmented_insert_plain_matches_pallas and "
        "test_seg_insert_kernel_algorithm",
    "test_hll_segmented_empty_batch":
        "runs the Pallas insert in interpret mode; see "
        + _KERNELS + "test_segmented_insert_plain_matches_pallas",
    "test_bits_segmented_matches_lax_and_numpy":
        "runs the Pallas bit insert in interpret mode; see "
        + _KERNELS + "test_bits_segmented_plain_matches_pallas",
    "test_engine_segment_impl_matches_scatter":
        "builds its bank with jax.numpy; see "
        "test_port_engine_segment_impl_matches_scatter",
    "test_planner_forced_short_circuits_measurement":
        "JAX's planner takes `forced`; the port's backend decides a forced "
        "ingest itself; see test_port_forced_ingest_skips_measurement",
    "test_pallas_popcount_partials_combine":
        "runs the Pallas popcount; see "
        + _KERNELS + "test_popcount_plain_matches_pallas",
    "test_bench_quick_smoke":
        "runs the JAX package's bench.py, which the port does not have",
}

_CORPUS = port_corpus(
    test_ingest, EXCLUDED, "ingest",
    ("redisson_tpu.client", "redisson_tpu.config", "redisson_tpu.ingest",
     "redisson_tpu.parallel"),
    {**CPU_ALIASES,
     "redisson_tpu.ingest.planner": {"IngestPlanner": CpuPlanner},
     "redisson_tpu.ingest.pipeline": {"StagingPipeline": TracedPipeline}})
globals().update(_CORPUS)


def test_corpus_was_imported():
    names = corpus_tests(test_ingest)
    assert len(names) == 24
    assert set(EXCLUDED) <= names
    assert ({f"test_ingest__{k[5:]}" for k in names - set(EXCLUDED)}
            <= set(_CORPUS))
    fn = _CORPUS["test_ingest__planner_real_measurement_on_cpu"]
    assert fn.__globals__["IngestPlanner"] is CpuPlanner
    assert fn.__globals__["StagingPipeline"] is TracedPipeline


# -- counterparts of the excluded corpus tests ---------------------------------


def test_port_engine_segment_impl_matches_scatter():
    # The engine-level wiring: forcing impl="segment" through the public
    # batch entrypoint lands the same registers as the scatter path.
    import torch

    from redisson_tpu_torch import engine

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**63, 5000, np.uint64)
    packed = torch.from_numpy(keys.view(np.int64).copy())
    out = {}
    for impl in ("scatter", "segment"):
        bank = torch.zeros((4, 16384), dtype=torch.int32)
        new, changed = engine.hll_bank_add_packed(
            bank, packed, keys.size, 1, impl=impl)
        out[impl] = new.numpy().copy()
        assert bool(changed[1])
    np.testing.assert_array_equal(out["scatter"], out["segment"])
    assert out["scatter"][1].any() and not out["scatter"][0].any()


def test_port_forced_ingest_skips_measurement():
    """A forced ingest never asks the planner to measure; `auto` does."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    keys = np.arange(1 << 16, dtype=np.uint64)
    for ingest, measures in (("sort", 0), ("segment", 0), ("auto", 1)):
        calls = []

        def measure(structure, n, _device):
            calls.append((structure, n))
            return {"scatter": 1.0, "sort": 2.0}

        cfg = Config()
        cfg.use_cuda(device="cpu", ingest=ingest)
        c = RedissonTorch.create(cfg)
        try:
            c.sketch.planner = IngestPlanner("cpu", measure=measure)
            h = c.get_hyper_log_log("h")
            h.add_ints(keys)
            assert h.count() > 0
        finally:
            c.shutdown()
        assert len(calls) == measures, ingest
