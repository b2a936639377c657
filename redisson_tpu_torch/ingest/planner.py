"""Adaptive ingest path planner: a cost table measured at first use
(counterpart of `redisson_tpu.ingest.planner`, device candidates only).

The first batch of a given size class on a device times every device
insert path of the structure (HLL: `scatter`, `sort`, `segment`; bit
cells: `scatter`, `segment`) on a synthetic batch, records
ns/key, and every later batch in that class takes the measured winner. On a
card the timing uses CUDA events around the launches; on the CPU, the host
clock. Size classes follow the engine's batch buckets (powers of two,
2^10..2^21); measurement batches are capped at 2^18 keys.

Candidates the planner cannot time itself, the host fold and the delta /
tape windows (priced by the backend from its measured link profile), come
in per call as `extra_costs`; `device_overhead` (ns/key, the link cost of
shipping the raw keys) is added to every measured device path first.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import torch

from redisson_tpu_torch.ingest import kernels
from redisson_tpu_torch.ops import hll

_MIN_CLASS = 10
_MAX_CLASS = 21
_MEASURE_CAP = 1 << 18
_REPS = 3


@dataclasses.dataclass(frozen=True)
class IngestPlan:
    """One planning decision: the chosen path + the costs behind it."""

    path: str
    costs: Dict[str, float]  # ns per key, per candidate


def _bits_scatter(cells, idx):
    # The engine's scatter path: an in-place max of 1 at each index.
    return cells.scatter_reduce_(0, idx, torch.ones_like(idx, dtype=cells.dtype),
                                 reduce="amax")


#: structure -> device path -> insert function
_PATHS = {
    "hll": {
        "scatter": hll.insert_scatter,
        "sort": hll.insert_sorted,
        "segment": kernels.segmented_hll_add,
    },
    "bits": {
        "scatter": _bits_scatter,
        "segment": kernels.segmented_bits_set,
    },
}


def _knuth(n: int, mod: int, device: torch.device) -> torch.Tensor:
    # Deterministic, well-spread index streams (Knuth multiplicative hash
    # of the index), as in the JAX planner: repeated measurements agree.
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (i * 2654435761) % (1 << 32) % mod


def _synthetic_hll(n: int, device: torch.device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    rank = (i % 50 + 1).to(torch.int32)
    return hll.make(device=device), _knuth(n, hll.M, device).to(torch.int32), rank


def _synthetic_bits(n: int, device: torch.device):
    cells_n = 1 << 20
    return (torch.zeros((cells_n,), dtype=torch.uint8, device=device),
            _knuth(n, cells_n, device))


_SYNTHETIC = {"hll": _synthetic_hll, "bits": _synthetic_bits}


def _time_s(fn, args, device: torch.device) -> float:
    """Best of _REPS timed calls, after one untimed warm-up call."""
    fn(*args)
    best = float("inf")
    for _ in range(_REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


def measure_device_paths(structure: str, n: int,
                         device: torch.device) -> Dict[str, float]:
    """Time every device path for one synthetic batch; ns/key each."""
    if structure not in _PATHS:
        raise ValueError(f"unknown ingest structure {structure!r}")
    n = max(1, min(n, _MEASURE_CAP))
    args = _SYNTHETIC[structure](n, device)
    return {name: _time_s(fn, args, device) * 1e9 / n
            for name, fn in _PATHS[structure].items()}


class IngestPlanner:
    """Per-device path planner with a lazily measured cost table.

    `measure` is a test seam: `(structure, n, device) -> {path: ns_per_key}`.
    """

    def __init__(self, device="cpu",
                 measure: Optional[Callable[..., Dict[str, float]]] = None):
        self.device = torch.device(device)
        self._measure = measure or measure_device_paths
        self._table: Dict[tuple, Dict[str, float]] = {}
        # Advisory costs (say, an earlier process's table): they only fill
        # paths the first-use measurement cannot time, never replace it.
        self._priors: Dict[tuple, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def set_prior(self, structure: str, nkeys: int,
                  costs: Dict[str, float]) -> None:
        """Seed advisory ns/key costs for one (structure, size class) row."""
        key = (structure, self.size_class(nkeys))
        with self._lock:
            self._priors.setdefault(key, {}).update(costs)

    @staticmethod
    def size_class(nkeys: int) -> int:
        """log2 of the engine batch bucket `nkeys` pads into."""
        c = max(1, int(nkeys) - 1).bit_length()
        return min(max(c, _MIN_CLASS), _MAX_CLASS)

    def plan(self, structure: str, nkeys: int, exclude=(),
             extra_costs: Optional[Dict[str, float]] = None,
             device_overhead: float = 0.0) -> IngestPlan:
        """Pick the insert path for one batch: the (structure, size class)
        row is measured on first use; every measured path pays
        `device_overhead` ns/key, `extra_costs` join as they are, and the
        cheapest candidate not in `exclude` wins."""
        key = (structure, self.size_class(nkeys))
        with self._lock:
            costs = self._table.get(key)
        if costs is None:
            fresh = self._measure(structure, 1 << key[1], self.device)
            with self._lock:
                row = dict(self._priors.get(key, {}))
                row.update(fresh)
                costs = self._table.setdefault(key, row)
        all_costs = {p: c + device_overhead for p, c in costs.items()}
        all_costs.update(extra_costs or {})
        best = min((p for p in all_costs if p not in exclude), key=all_costs.get)
        return IngestPlan(path=best, costs=all_costs)

    def table(self) -> Dict[str, Dict[str, float]]:
        """Snapshot for reporting: {'hll@16': {...}, ...}."""
        with self._lock:
            return {f"{s}@{c}": dict(costs)
                    for (s, c), costs in sorted(self._table.items())}


_PLANNERS: Dict[str, IngestPlanner] = {}
_PLANNERS_LOCK = threading.Lock()


def default_planner(device="cpu") -> IngestPlanner:
    """Process-wide planner per device (backends share its table)."""
    key = str(torch.device(device))
    with _PLANNERS_LOCK:
        planner = _PLANNERS.get(key)
        if planner is None:
            planner = _PLANNERS[key] = IngestPlanner(device)
        return planner
