"""The port's event-loop stall witness (`redisson_tpu_torch/loopwitness.py`)
on the CPU: the JAX package's corpus tests/test_loopwitness.py runs
against it through `port_corpus` (tests/test_torch_interop.py), its `lw`
the port's module and its `io_loop` fixture redefined on that module;
then one snapshot merged by both packages.
"""

import asyncio
import copy
import threading

import pytest

from redisson_tpu import loopwitness as jlw
from redisson_tpu_torch import loopwitness
from tests import test_loopwitness
from tests.test_torch_interop import corpus_tests, port_corpus

#: tests of tests/test_loopwitness.py with no counterpart run unchanged,
#: and why (none)
EXCLUDED = {}

_CORPUS = port_corpus(test_loopwitness, EXCLUDED, "loopwitness",
                      ("redisson_tpu.loopwitness",))
globals().update(_CORPUS)


@pytest.fixture
def io_loop():
    """test_loopwitness.py's `io_loop`, cleaning up the port's witness."""
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    yield loop
    loopwitness.uninstall()
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=5)
    loop.close()
    loopwitness.loop_witness_reset()


def test_corpus_was_imported():
    names = corpus_tests(test_loopwitness)
    assert len(names) == 7
    assert set(EXCLUDED) <= names
    assert ({f"test_loopwitness__{k[5:]}" for k in names - set(EXCLUDED)}
            <= set(_CORPUS))
    fn = _CORPUS["test_loopwitness__merge_loop_snapshots"]
    assert fn.__globals__["lw"] is loopwitness


def test_merge_matches_jax():
    snap = {"version": 1, "loops": {"x": {
        "callbacks": {"cb:f (m.py)": {"runs": 3, "total_s": 0.123456789,
                                      "max_s": 0.1, "p99_s": 0.09}},
        "lag": {"beats": 7, "max_s": 0.02, "p99_s": 0.01},
        "stalls": [{"site": "cb:f (m.py)", "ms": 30.0}] * 200,
        "stall_threshold_ms": 20.0,
    }}}
    other = copy.deepcopy(snap)
    other["loops"]["z"] = copy.deepcopy(snap["loops"]["x"])
    snaps = [snap, other, snap]
    assert (loopwitness.merge_loop_snapshots(snaps)
            == jlw.merge_loop_snapshots(snaps))
