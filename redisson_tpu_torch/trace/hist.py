"""Mergeable log2-sub-bucketed latency histograms, HDR-style (counterpart
of `redisson_tpu.trace.hist`).

Values are recorded as integer microsecond ticks into a log-linear
bucket ladder: ticks below ``2**SUB_BITS`` land in exact unit buckets,
above that each power-of-two octave is split into ``2**SUB_BITS``
sub-buckets, bounding relative quantile error at ``2**-SUB_BITS``
(~3.1%).  ``record`` is O(1) — a bit_length, a shift, a list index —
and takes no lock on the hot path; only growing the bucket array does.
Histograms merge bucket-wise, so per-(kind, tenant) histograms can be
collapsed into per-kind or global views without re-recording.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

SUB_BITS = 5
SUB = 1 << SUB_BITS  # 32 sub-buckets per octave

_TICKS_PER_SECOND = 1_000_000  # microsecond resolution


def bucket_index(ticks: int) -> int:
    """Map integer ticks -> bucket index (monotone, O(1))."""
    if ticks < SUB:
        return ticks if ticks >= 0 else 0
    shift = ticks.bit_length() - 1 - SUB_BITS
    # mantissa in [SUB, 2*SUB); index continues the linear region exactly.
    return (shift << SUB_BITS) + (ticks >> shift)


def bucket_upper_ticks(index: int) -> int:
    """Inclusive upper bound (in ticks) of values mapping to ``index``."""
    if index < 2 * SUB:
        return index
    shift = (index >> SUB_BITS) - 1
    mantissa = SUB + (index & (SUB - 1))
    return ((mantissa + 1) << shift) - 1


class LatencyHistogram:
    """One latency distribution with O(1) record and mergeable buckets."""

    __slots__ = ("_counts", "_grow_lock", "count", "sum_s", "min_s", "max_s")

    def __init__(self) -> None:
        self._counts: List[int] = [0] * (2 * SUB)
        self._grow_lock = threading.Lock()
        self.count = 0
        self.sum_s = 0.0
        self.min_s: Optional[float] = None
        self.max_s: Optional[float] = None

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        idx = bucket_index(int(seconds * _TICKS_PER_SECOND))
        counts = self._counts
        if idx >= len(counts):
            with self._grow_lock:
                counts = self._counts
                if idx >= len(counts):
                    counts.extend([0] * (idx + 1 - len(counts)))
        counts[idx] += 1
        self.count += 1
        self.sum_s += seconds
        if self.min_s is None or seconds < self.min_s:
            self.min_s = seconds
        if self.max_s is None or seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        theirs = list(other._counts)
        with self._grow_lock:
            if len(theirs) > len(self._counts):
                self._counts.extend([0] * (len(theirs) - len(self._counts)))
        for i, c in enumerate(theirs):
            if c:
                self._counts[i] += c
        self.count += other.count
        self.sum_s += other.sum_s
        for bound, pick in ((other.min_s, min), (other.max_s, max)):
            if bound is not None:
                mine = self.min_s if pick is min else self.max_s
                val = bound if mine is None else pick(mine, bound)
                if pick is min:
                    self.min_s = val
                else:
                    self.max_s = val

    # -- quantiles --------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Upper-bound estimate (seconds) of the q-quantile, q in [0, 1]."""
        total = self.count
        if total <= 0:
            return 0.0
        rank = max(1, int(q * total + 0.999999))  # ceil, floor at 1
        seen = 0
        for idx, c in enumerate(self._counts):
            if not c:
                continue
            seen += c
            if seen >= rank:
                return bucket_upper_ticks(idx) / _TICKS_PER_SECOND
        return (self.max_s or 0.0)

    def percentiles(self) -> Dict[str, float]:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def cumulative(self, bounds_s: Iterable[float]) -> List[Tuple[float, int]]:
        """Cumulative counts at the given ``le`` boundaries (seconds).

        Returns ``[(bound, count_le_bound), ...]`` in ascending bound
        order — the shape a Prometheus histogram exposition needs.  A
        bucket whose range straddles a boundary counts toward the first
        boundary at or above its upper edge (consistent overestimate).
        """
        bounds = sorted(set(float(b) for b in bounds_s))
        out = [0] * len(bounds)
        for idx, c in enumerate(self._counts):
            if not c:
                continue
            upper = bucket_upper_ticks(idx) / _TICKS_PER_SECOND
            for j, b in enumerate(bounds):
                if upper <= b:
                    out[j] += c
                    break
        cum = 0
        result: List[Tuple[float, int]] = []
        for b, c in zip(bounds, out):
            cum += c
            result.append((b, cum))
        return result

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "count": self.count,
            "sum_s": self.sum_s,
            "mean_s": (self.sum_s / self.count) if self.count else 0.0,
            "min_s": self.min_s,
            "max_s": self.max_s,
        }
        out.update(self.percentiles())
        return out


class HistogramSet:
    """(kind, tenant)-keyed histograms; get-or-create under a small lock."""

    def __init__(self) -> None:
        self._hists: Dict[Tuple[str, str], LatencyHistogram] = {}
        self._lock = threading.Lock()

    def record(self, kind: str, tenant: str, seconds: float) -> None:
        key = (kind, tenant)
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key, LatencyHistogram())
        h.record(seconds)

    def get(self, kind: str, tenant: str = "") -> Optional[LatencyHistogram]:
        return self._hists.get((kind, tenant))

    def items(self) -> Iterator[Tuple[Tuple[str, str], LatencyHistogram]]:
        with self._lock:
            pairs = list(self._hists.items())
        return iter(pairs)

    def merged(self, kind: Optional[str] = None) -> LatencyHistogram:
        """Collapse across tenants (and kinds, when ``kind`` is None)."""
        out = LatencyHistogram()
        for (k, _tenant), h in self.items():
            if kind is None or k == kind:
                out.merge(h)
        return out

    def kinds(self) -> List[str]:
        return sorted({k for (k, _t) in self._hists.keys()})

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {
            "%s|%s" % (kind, tenant): h.snapshot()
            for (kind, tenant), h in self.items()
        }
