"""Readings of a cell's numbers compared, for its limits: the program's on
each seed, and the control's (the reference put in the program's place
with one guarantee broken, as the driver's `check(control=True)` says).

    python3 gridbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed: the cell's set-up and a short window of its own traffic
at its own load, then both readings. One JSON line per seed. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gridbench.harness import env, loop, spec  # noqa: E402


def readings(workload: str, seed: int, seconds: float) -> dict:
    bench = spec.load_benchmark()
    w = spec.cell(bench, workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    drv = spec.driver(mix["driver"]).Driver(cfg, mix, seed,
                                            env.cards(int(w["chips"])), seconds)
    drv.setup()
    lr = loop.run(drv.clients, drv.depth, drv.start, float(mix["warm_seconds"]),
                  seconds, side=getattr(drv, "side", None))
    outputs = drv.outputs(lr.calls)
    left = drv.release()
    program = drv.check(lr.calls, outputs)
    control = drv.check(lr.calls, outputs, control=True)
    return {"seed": seed, "calls": len(lr.calls), "left_bytes": left,
            "program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    env.pin_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = readings(args.workload, seed, args.seconds)
        out["wall_s"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
