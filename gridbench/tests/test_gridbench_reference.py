"""The references against the port's CPU path at tiny sizes, and the
judgement of a run: sound runs come out correct; the control and every
fault a cell can have come out not correct.

The runs here skip the harness's look for a card and drive the rest of a
run on the CPU at shrunk sizes (`conftest.small`)."""

import time

import numpy as np
import pytest
import torch

from gridbench.harness import loop, runner, spec
from gridbench.reference import bitmaps
from gridbench.tests.conftest import small

BENCH = spec.load_benchmark()
#: every driver's cells, whether or not BENCHMARK.json holds them yet
CELLS = {"bitset_dau.monthly_rollup": ("bitset_dau", "monthly_rollup"),
         "bitset_pod4.monthly_rollup_2c": ("bitset_pod4", "monthly_rollup_2c")}


def _bench_with(workload):
    """BENCHMARK.json with the cell in it (a cell left out of the file is
    still judged the same way)."""
    bench = dict(BENCH, workloads=list(BENCH["workloads"]))
    if workload not in [w["name"] for w in bench["workloads"]]:
        config, traffic = CELLS[workload]
        bench["workloads"].append({"name": workload, "config": config,
                                   "traffic": traffic, "chips": 1, "why": "-"})
    return bench


def _run(workload, seed=5):
    cfg, mix = small(*CELLS[workload])
    line, checks = runner.run_cell(_bench_with(workload), workload, seed, 0.3,
                                   False, time.time(), ["cpu"], "", cfg, mix)
    return line, checks


def test_bitmap_reference_equals_the_port():
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import CudaConfig

    rng = np.random.default_rng(3)
    days = [rng.integers(0, 1 << 13, 700) for _ in range(4)]
    c = RedissonTorch(CudaConfig(device="cpu"))
    try:
        for d, ids in enumerate(days):
            c.get_bit_set(f"d{d}").set_bits(ids)
        dest = c.get_bit_set("dest")
        dest.or_("d0", "d1", "d2", "d3")
        cells = bitmaps.union_cells(days, 1 << 13, torch.device("cpu"))
        assert dest.cardinality() == bitmaps.count(cells)
        got = c._executor.execute_sync("dest", "bits_export", None)[1]
        assert bitmaps.cells_differing(cells, got) == 0
    finally:
        c.shutdown()


def test_prefix_counts_follow_the_batches():
    cells = bitmaps.union_cells([np.array([1, 2, 3])], 16, torch.device("cpu"))
    counts = bitmaps.prefix_counts(cells, [np.array([3, 4, 4]), np.array([1]),
                                           np.array([9, 15])])
    assert counts.tolist() == [3, 4, 4, 6]
    assert bitmaps.count(cells) == 6


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    line, checks = _run(workload)
    assert line["correct"] is True, checks
    assert all(v == 0 for v, _ in checks.values())


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    """The reference in the program's place with one guarantee broken (a
    stale count that misses the newest acknowledged login batch) fails a
    number."""
    cfg, mix = small(*CELLS[workload])
    drv = spec.driver(mix["driver"]).Driver(cfg, mix, 9, ["cpu"], 0.2)
    drv.setup()
    lr = loop.run(drv.clients, drv.depth, drv.start, 0.05, 0.2, side=drv.side)
    outputs = drv.outputs(lr.calls)
    drv.release()
    assert all(v <= lim for v, lim in drv.check(lr.calls, outputs).values())
    control = drv.check(lr.calls, outputs, control=True)
    assert any(v > lim for v, lim in control.values()), control


def _rollup_faults():
    from redisson_tpu_torch import backend_torch
    from redisson_tpu_torch.ops import bitset as bitset_ops
    from redisson_tpu_torch.parallel import backend_pod, sharded_bits

    def unchanged(self, target, ops):  # the OR leaves its destination as it was
        for op in ops:
            op.future.set_result(None)

    def half(orig):
        def run(self, target, ops):
            for op in ops:
                names = op.payload["names"]
                op.payload = dict(op.payload, names=names[: len(names) // 2])
            return orig(self, target, ops)
        return run

    def altered(orig):
        return lambda parts: orig(parts) + 1

    combine = sharded_bits.combine_partials

    def home_only(parts):  # the partials of the other cards never arrive
        return combine(parts[:1])

    return {
        "unchanged": [(backend_torch.TorchBackend, "_op_bitset_op", unchanged),
                      (backend_pod.PodBackend, "_op_bitset_op", unchanged)],
        "half_the_batch": [
            (backend_torch.TorchBackend, "_op_bitset_op",
             half(backend_torch.TorchBackend._op_bitset_op)),
            (backend_pod.PodBackend, "_op_bitset_op",
             half(backend_pod.PodBackend._op_bitset_op))],
        "answer_altered": [
            (bitset_ops, "combine_partials", altered(bitset_ops.combine_partials)),
            (sharded_bits, "combine_partials",
             altered(sharded_bits.combine_partials))],
        "exchange_left_out": [(sharded_bits, "combine_partials", home_only)],
    }


ROLLUP_FAULTS = ["unchanged", "half_the_batch", "answer_altered"]


@pytest.mark.parametrize("fault", ROLLUP_FAULTS + ["exchange_left_out"])
@pytest.mark.parametrize("workload", ["bitset_dau.monthly_rollup",
                                      "bitset_pod4.monthly_rollup_2c"])
def test_rollup_fault_is_not_correct(workload, fault, monkeypatch):
    if fault == "exchange_left_out" and "pod" not in workload:
        pytest.skip("one card: no exchange between cards")
    for owner, name, fn in _rollup_faults()[fault]:
        monkeypatch.setattr(owner, name, fn)
    line, checks = _run(workload)
    assert line["correct"] is False, checks


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_or_unchanged_in_the_window_is_not_correct(workload, monkeypatch):
    """An OR that leaves its destination as it was once set-up is over (a
    BITOP skipped or answered from a cache while logins come in) fails."""
    cfg, mix = small(*CELLS[workload])
    drv = spec.driver(mix["driver"]).Driver(cfg, mix, 11, ["cpu"], 0.3)
    drv.setup()
    for owner, name, fn in _rollup_faults()["unchanged"]:
        monkeypatch.setattr(owner, name, fn)
    lr = loop.run(drv.clients, drv.depth, drv.start, 0.05, 0.3, side=drv.side)
    outputs = drv.outputs(lr.calls)
    drv.release()
    checks = drv.check(lr.calls, outputs)
    assert checks["counts_wrong"][0] > 0, checks


@pytest.mark.cuda
def test_rollup_on_the_card_is_correct(card):
    """A shrunk monthly rollup through the card's kernels, judged as a run
    is (the card's own look is the fixture's)."""
    cfg, mix = small("bitset_dau", "monthly_rollup")
    cfg["engine_settings"]["device"] = card
    line, checks = runner.run_cell(BENCH, "bitset_dau.monthly_rollup", 21, 0.5,
                                   True, time.time(), [card],
                                   torch.cuda.get_device_name(0), cfg, mix)
    assert line["correct"] is True, checks
    assert line["device"]["busy_s"] > 0
