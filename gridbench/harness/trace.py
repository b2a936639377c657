"""One traced window: `torch.profiler` over the loop, reduced to what the
per-layer readers and the result's `breakdown` need.

The reduction reads the profiler's raw events (no tree of function
events is built): the device's kernels, copies and fills by card, each
launch's host call by correlation id, and the host operations around it.
Device time is the union of the device operations' intervals on a card, so
overlapping operations count once.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel"}
NAME_LEN = 64

# -- readable kernel names ----------------------------------------------------

_WRAPPERS = {"BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor",
             "CUnaryFunctor", "OpaqueType"}


def _strip_params(s: str) -> str:
    """Drop a trailing parameter list: the first '(' outside '<>'."""
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return s[:i]
    return s


def short_name(name: str) -> str:
    """A kernel's name without `void`, namespaces, parameter lists and
    template noise: the kernel and the functors or functions that tell two
    instances apart, in at most 64 characters. `void at::native::
    vectorized_elementwise_kernel<4, at::native::BinaryFunctor<long, long,
    long, at::native::BitwiseXorFunctor<long>>, ...>(...)` becomes
    `vectorized_elementwise_kernel[BitwiseXorFunctor]`."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.replace("(anonymous namespace)::", "")
    s = _strip_params(s)
    s = re.sub(r"\b[A-Za-z_]\w*::", "", s)
    if "<" not in s:
        return s[:NAME_LEN].strip()
    base, args = s.split("<", 1)
    words = re.findall(r"[A-Za-z_]\w*", args)
    tags = [w for w in words if w.endswith(("Functor", "functor", "Op", "_op"))
            and w not in _WRAPPERS]
    if not tags:
        # lambdas name the function that holds them: `f(...)::{lambda...}`
        tags = re.findall(r"([A-Za-z_]\w*)\s*\(", args)
    if not tags:
        compact = re.sub(r"\s+", "", args.rsplit(">", 1)[0])
        tags = [compact] if len(compact) <= 24 else words[:1]
    seen: List[str] = []
    for t in tags:
        if t not in seen:
            seen.append(t)
    out = base.strip() + ("[" + ",".join(seen) + "]" if seen else "")
    return out[:NAME_LEN]


# -- raw events ---------------------------------------------------------------


def _t(evt) -> Tuple[float, float]:
    """(start, end) in seconds on the profiler's clock."""
    if hasattr(evt, "start_ns"):
        s = evt.start_ns() * 1e-9
        return s, s + evt.duration_ns() * 1e-9
    s = evt.start_us() * 1e-6
    return s, s + evt.duration_us() * 1e-6


def _activity(evt) -> str:
    fn = getattr(evt, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _is_device(evt, cuda_type) -> bool:
    if evt.device_type() != cuda_type:
        return False
    act = _activity(evt)
    if act:
        return act in DEVICE_ACTIVITIES
    return "Sync" not in evt.name()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _top(totals: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


class Window:
    """`start()` and `stop()` bound the profiled window; `reduce()` then
    gives its figures."""

    def __init__(self, ndev: int):
        self.ndev = ndev
        self.prof = None
        self.wall = (0.0, 0.0)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.wall = (time.perf_counter(), 0.0)

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            for d in range(self.ndev):
                torch.cuda.synchronize(d)
        self.wall = (self.wall[0], time.perf_counter())
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """window_s, busy_s (mean over cards), busy_s_by_card, device_ops
        (count), and the breakdown's two lists."""
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        dev_ops = []  # (card, start, end, name, correlation)
        launches: Dict[int, tuple] = {}  # correlation -> (thread, t, name)
        cpu_ops: Dict[int, List[tuple]] = defaultdict(list)
        for evt in events:
            if _is_device(evt, DeviceType.CUDA):
                s, e = _t(evt)
                dev_ops.append((evt.device_index(), s, e, evt.name(),
                                evt.correlation_id()))
            elif evt.device_type() == DeviceType.CPU:
                act = _activity(evt)
                s, e = _t(evt)
                if act in ("cuda_runtime", "cuda_driver") or (
                        not act and evt.name().startswith("cuda")):
                    launches[evt.correlation_id()] = (
                        evt.start_thread_id(), s, evt.name())
                elif act in ("cpu_op", "user_annotation", "python_function", ""):
                    cpu_ops[evt.start_thread_id()].append((s, e, evt.name()))
        for ops in cpu_ops.values():
            ops.sort()
        busy: Dict[int, float] = {d: 0.0 for d in range(self.ndev)}
        by_card: Dict[int, list] = defaultdict(list)
        op_time: Dict[str, float] = defaultdict(float)
        for card, s, e, name, corr in dev_ops:
            by_card[card].append((s, e, name, corr))
            op_time[short_name(name)] += e - s
        gaps: Dict[str, float] = defaultdict(float)
        for card, ops in by_card.items():
            merged = _union([(s, e) for s, e, _, _ in ops])
            busy[card] = busy.get(card, 0.0) + sum(e - s for s, e in merged)
            ops.sort()
            starts = [o[0] for o in ops]
            for (_, end_a), (start_b, _) in zip(merged, merged[1:]):
                nxt = ops[bisect.bisect_left(starts, start_b)]
                gaps[self._host_of(nxt, launches, cpu_ops)] += start_b - end_a
        cards = max(self.ndev, 1)
        return {
            "window_s": self.wall[1] - self.wall[0],
            "busy_s": sum(busy.values()) / cards,
            "busy_s_by_card": [busy.get(d, 0.0) for d in range(cards)],
            "device_ops": len(dev_ops),
            "breakdown": {"device_ops": _top(op_time), "idle_gaps": _top(gaps)},
        }

    @staticmethod
    def _host_of(op: tuple, launches: dict, cpu_ops: dict) -> str:
        """What the host was doing when it issued `op`: the innermost host
        operation around the launching call, then the call, then the op."""
        _, _, name, corr = op
        tail = ">" + short_name(name)
        launch = launches.get(corr)
        if launch is None:
            return ("unlaunched" + tail)[:NAME_LEN]
        thread, t, call = launch
        inner = None
        ops = cpu_ops.get(thread, [])
        i = bisect.bisect_right(ops, (t, float("inf"), ""))
        for s, e, n in reversed(ops[max(0, i - 64):i]):
            if s <= t <= e:
                inner = n
                break
        host = f"{inner}/{call}" if inner else call
        return (host[:max(NAME_LEN - len(tail), 8)] + tail)[:NAME_LEN]

