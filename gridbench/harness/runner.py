"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the judgement against the reference, and the result's line.

    python3 gridbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the line's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer ones, read from a profiled window of at most the
traffic's `trace_seconds`. Either way every answer of the run is judged,
and the numbers compared close standard error and the line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from gridbench.harness import env, loop, program, spec, trace


def _peak_bytes_per_s(kind: str) -> Optional[float]:
    with open(spec.BENCH_DIR / "harness" / "peaks.json") as f:
        peaks = json.load(f)
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, cards: List[str],
             device_kind: str = "", cfg: Optional[dict] = None,
             mix: Optional[dict] = None) -> Tuple[dict, Dict[str, tuple]]:
    """Run the cell on `cards` and return (the result's line without its
    checks, the checks {name: (value, limit)}). `cfg` and `mix` stand in
    for the cell's files (the CPU tests shrink them)."""
    w = spec.cell(bench, workload)
    cfg = cfg or spec.config(w["config"])
    mix = mix or spec.traffic(w["traffic"])
    window = min(seconds, float(mix["trace_seconds"])) if traced else seconds
    drv = spec.driver(mix["driver"]).Driver(cfg, mix, seed, cards, window)
    drv.setup()
    tw = trace.Window(len(cards)) if traced else None
    marks: dict = {}

    def at_start() -> None:
        marks["wall0"] = time.time()
        marks["stage0"] = drv.stage_totals()
        if tw is not None:
            tw.start()

    def after_drain() -> None:
        if tw is not None:
            tw.stop()
        marks["stage1"] = drv.stage_totals()

    lr = loop.run(drv.clients, drv.depth, drv.start, float(mix["warm_seconds"]),
                  window, at_start, after_drain, getattr(drv, "side", None))
    peak = program.memory_peak(cards)
    submitted = lr.submitted_in(lr.t0, lr.t1)
    rec: dict = {"setup_s": marks["wall0"] - t_start}
    if tw is None:
        done = lr.in_window()
        rec.update(seconds=lr.t1 - lr.t0,
                   latencies_s=[c.t_done - c.t_submit for c in done
                                if c.error is None])
        rec[drv.unit] = sum(c.units for c in done if c.error is None)
    else:
        rec.update(tw.reduce())
        (s0, r0), (s1, r1) = marks["stage0"], marks["stage1"]
        rec.update(unit=drv.unit, calls=len(submitted),
                   stage_s=s1 - s0, runs=r1 - r0,
                   work_bytes=drv.work_bytes(submitted),
                   peak_bytes_per_s=_peak_bytes_per_s(device_kind),
                   cards=len(cards))
    metrics = {}
    for m in spec.metrics_of(bench, workload, traced):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    outputs = drv.outputs(lr.calls)
    left = drv.release()
    print(f"gridbench: {left} bytes of the program left on the cards for the "
          f"reference", file=sys.stderr)
    checks = drv.check(lr.calls, outputs)
    device = {"platform": "gpu", "kind": device_kind, "count": len(cards),
              "memory_peak_bytes": peak}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": len(submitted),
            "failed": sum(c.error is not None for c in submitted),
            "metrics": metrics, "device": device}
    if tw is not None:
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = rec["breakdown"]
    return line, checks


def emit(line: dict, checks: Dict[str, tuple]) -> None:
    """The checks as the last lines of standard error, then the line, with
    the checks under the last key, as the last line of standard output."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(line)
    line["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    t_start = env.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.pin_caches()
    bench = spec.load_benchmark()
    w = spec.cell(bench, args.workload)
    import torch

    chips = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gridbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"visible", file=sys.stderr)
        return 2
    cards = env.cards(chips)
    line, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start, cards, env.device_name())
    found = env.forbidden_loaded()
    if found:
        print(f"gridbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(line, checks)
    return 0
