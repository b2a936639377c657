#!/usr/bin/env python3
"""Paired host cost of the PyTorch port's unserved per-op paths, for two
checkouts of the repo (a parent commit and a change).

    python3 tools/torch_host_pair.py PARENT CHANGE [--pairs 4] [--device cpu]
        [--sketches 1024] [--ops 10000]

Each pass runs in a fresh process with one checkout's `redisson_tpu_torch`
first on sys.path, in the order parent, change, change, parent, ... On a
plain client (no serving layer, no tracer): RMapCache put with a TTL and
RQueue offer + poll, one executor run per op (the structure tier's per-op
path), and PFADD of `--sketches` sketches x 40,000 keys through the client.
Prints one JSON line per pass, then the medians and the change's rates as a
share of the parent's. Unpack the parent with `git archive` into a
git-ignored directory first.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

KEYS = 40_000
REPS = 3


def one_pass(tree: str, device: str, sketches: int, ops: int) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import numpy as np

    import redisson_tpu_torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    if not os.path.abspath(redisson_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {redisson_tpu_torch.__file__}, not {root}'s package")
    c = RedissonTorch.create(Config().use_cuda(device=device, ingest="segment"))
    rates = {"mapcache_put_per_s": [], "queue_items_per_s": [], "pfadd_keys_per_s": []}
    try:
        m = c.get_map_cache("pair:mc")
        q = c.get_queue("pair:q")
        names = [f"pair:h{i}" for i in range(sketches)]
        rng = np.random.default_rng(0)
        for rep in range(REPS + 1):  # rep 0 warms
            t = time.perf_counter()
            for i in range(ops):
                m.put(f"k{rep}:{i}", i, 1000)
            put = ops / (time.perf_counter() - t)
            t = time.perf_counter()
            for i in range(ops):
                q.offer(i)
            for i in range(ops):
                q.poll()
            queue = ops / (time.perf_counter() - t)
            batches = [rng.integers(0, 2**63, KEYS, dtype=np.uint64) for _ in names]
            t = time.perf_counter()
            futs = [c.get_hyper_log_log(n).add_ints_async(b) for n, b in zip(names, batches)]
            [f.result() for f in futs]
            c.get_hyper_log_log(names[-1]).count()  # the card has finished
            pfadd = sketches * KEYS / (time.perf_counter() - t)
            if rep:
                rates["mapcache_put_per_s"].append(put)
                rates["queue_items_per_s"].append(queue)
                rates["pfadd_keys_per_s"].append(pfadd)
    finally:
        c.shutdown()
    return {k: statistics.median(v) for k, v in rates.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--sketches", type=int, default=1024)
    ap.add_argument("--ops", type=int, default=10_000)
    ap.add_argument("--child", action="store_true", help="run one pass of PARENT only")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one_pass(args.parent, args.device, args.sketches, args.ops)))
        return 0
    order = []
    for i in range(args.pairs):
        order += [("parent", "change"), ("change", "parent")][i % 2]
    got = {"parent": [], "change": []}
    for which in order:
        tree = args.parent if which == "parent" else args.change
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--child",
             "--device", args.device, "--sketches", str(args.sketches),
             "--ops", str(args.ops)],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        rates = json.loads(out)
        got[which].append(rates)
        print(json.dumps({"tree": which, **rates}), flush=True)
    med = {w: {k: statistics.median(r[k] for r in runs) for k in runs[0]}
           for w, runs in got.items()}
    share = {k: med["change"][k] / med["parent"][k] for k in med["parent"]}
    print(json.dumps({"median": med, "change_over_parent": share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
