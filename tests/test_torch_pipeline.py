"""The executor's contract in the port on the CPU: the JAX package's
corpus tests/test_pipeline.py runs against the port's executor
(`redisson_tpu_torch/executor.py`), cost model and epoch read cache.

The corpus runs through `port_corpus` (tests/test_torch_interop.py). Its
fake backends implement `run(kind, target, ops)` and drive the port's
`CommandExecutor` as they drive JAX's: per-target FIFO, read-your-writes,
a randomized schedule against the serial one, shutdown, deadlines and
the cost model's EWMA. The read-cache tests take the `client` fixture,
redefined here as a port client on `use_cuda(device="cpu")` (the port's
default is the card; the corpus's fixture asks for `TpuConfig`).
"""

import pytest

from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.observability import ExecutorMetrics, MetricsRegistry
from tests import test_pipeline
from tests.test_torch_interop import CLIENT_ALIASES, corpus_tests, port_corpus

#: tests of tests/test_pipeline.py with no counterpart run unchanged, and
#: why (none)
EXCLUDED = {}

_CORPUS = port_corpus(
    test_pipeline, EXCLUDED, "pipeline",
    ("redisson_tpu.client", "redisson_tpu.config", "redisson_tpu.executor",
     "redisson_tpu.observability", "redisson_tpu.serve"),
    CLIENT_ALIASES)
globals().update(_CORPUS)


@pytest.fixture()
def client():
    """test_pipeline.py's `client` fixture on the CPU."""
    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    yield c
    c.shutdown()


def test_corpus_was_imported():
    names = corpus_tests(test_pipeline)
    assert len(names) == 16
    assert set(EXCLUDED) <= names
    assert ({f"test_pipeline__{k[5:]}" for k in names - set(EXCLUDED)}
            <= set(_CORPUS))
    ex = _CORPUS["test_pipeline__read_your_writes_window_gt1"].__globals__
    assert ex["CommandExecutor"].__module__ == "redisson_tpu_torch.executor"


# -- the port's own rules -------------------------------------------------------


def test_histogram_read_folds_buffered_runs():
    """`MetricsRegistry.histogram(name)` is a read: the runs the executor's
    metrics hold in their buffer are folded in before it returns, as
    `counter` and `snapshot` fold them (the corpus's window-bound test
    reads `executor.inflight_depth` this way)."""
    reg = MetricsRegistry()
    em = ExecutorMetrics(reg)
    for depth in (1, 2, 2):
        em.record_run(depth, overlapped=depth > 1)
    snap = reg.histogram("executor.inflight_depth").snapshot()
    assert snap["count"] == 3 and snap["max"] == 2 and snap["min"] == 1
    assert reg.counter("executor.runs_overlapped_total") == 2.0
