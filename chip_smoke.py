#!/usr/bin/env python3
"""On-card smoke run of redisson_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]
    python3 chip_smoke.py --merge-pair TREE   # the client's merge call only, of TREE's package

Needs one CUDA card (Hopper: the kernels build for sm_90a) and `nvcc`.
Phases, each of which fails the run on error:

  1. print the card's name and power limit; build the CUDA kernels of
     `redisson_tpu_torch/csrc/` (one nvcc per source, in parallel) and the
     host fold library (`csrc/host_fold.cpp`, g++);
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes (bit-identical), and time kernel, plain version,
     the kernel's bound and one PyTorch library call with CUDA events
     (the in-place HLL insert, registers and changed flag, for uniform,
     hot-bucket, empty, all-invalid, no-raise and client batches, timed at
     2^21 pairs and at the client's 40,000 keys in 2^16 lanes, and its
     direct and shared kernels from 2^16 to 2^21 lanes; its multi-target
     form, a row per pair, at a config 3 chunk (2^21 lanes over 256
     sketches) and a window of 4096 x 8-key PFADDs to distinct sketches,
     beside the flat scatter it replaces; merge_stack at S = 1024, 1000,
     256 and 0, and over listed rows of a bank (2 to 8001, each by-value
     capacity +-1, repeats, rows out of range) from numpy, a CPU tensor
     and the card, one launch per call, its grid probe (strip widths and
     cluster sizes), its times in turns with torch.amax at S = 256 and
     1000 and over 2 to 1001 host-listed rows, and the host-cost
     breakdown of one call; delta_merge at [256, 16384], [1, 2^28],
     [64, 2^20], [3, 1024] and [2, 16], timed at the first two; the
     in-place segment-OR at m = 257,296,945 with 2^21 x 7 codes;
     window_merge on a mixed [64, 2^20] tape, an HLL [256, 16384] tape and
     a [2, 16] tape, timed at the first two (the HLL tape beside
     torch.maximum(old, wire, out=old)); each in-place call merging
     into a fresh copy of its input; the timed shapes also as device-only
     time from torch.profiler, taken last, and as host microseconds per
     call);
  3. drive the HLL path through the client at full width: 1024 named HLLs
     (a 64 MiB bank), 40,000 distinct keys each, one 8M-key PFADD, PFCOUNT,
     PFMERGE and PFMERGE+PFCOUNT over 1000 sketches, and
     engine.hll_count_merged over the bank's stack, with ingest="segment";
     check estimates against exact counts and the final bank against the
     same ops under ingest="sort" (no hand kernel), and read the kernels'
     launch counters;
  4. HLL end-to-end rates, warm: one untimed pass at each shape, then
     TIMING_REPS timed passes of fresh keys into the same sketches
     (median, min and max of PFADD inserts/s and client PFMERGE ms);
  5. one run with ingest="auto" (the planner's HLL and Bloom choices and
     its cost table);
  6. a small run on the card against the same ops on the CPU path;
  7. the Bloom path at BASELINE config 2's width: try_init(2^28 // 10,
     0.01) (m = 257,296,945, k = 7), 10M add_ints in 2M-key batches under
     ingest="segment" and again under "scatter" (identical cells),
     contains of the first 1M keys, an FPR probe of 2^30 fresh keys drawn
     on the card (within 5% of (BITCOUNT/m)^k) and count();
  8. the BitSet path: 7 daily bitmaps of 2^27 bits, 8M SETBITs each
     (old-value vectors checked), BITCOUNT, BITOP OR / AND / XOR across the
     week, NOT, length and size, all equal to numpy's;
  9. Bloom and BitSet rates, warm (median, min and max of 5 passes);
 10. the delta / tape / hostfold ingest at full width: the HLL path of 3
     under ingest="delta", "tape" and "hostfold" (banks and PFADD flags
     equal to "sort"); the Bloom path's 10M adds under "delta" (cells equal
     to "scatter"; each newly flag implies scatter's `added`), then under
     "hostfold" from the host mirror with contains of 1M keys and a
     bloom_sync (cells equal); the BitSet days under "delta" (old bits and
     cells equal to numpy's);
 11. one mixed window (32 HLLs, 16 Blooms of m = 958,505, 16 BitSets of
     2^20 bits) under "tape" in ONE window_merge launch, then a window past
     the cell budget through chunked delta_merge, both equal to "delta" and
     in state to "scatter";
 12. delta / tape / hostfold rates, warm, the link profile and what
     ingest="auto" picks at 2^21 keys;
 13. BASELINE config 3 (benchmarks/suite.py config3) on the default card
     client (`RedissonTorch.create()`): 256 sketches x 40,000 seeded 8-byte
     keys staged into one RBatch and executed, then PFMERGE + PFCOUNT over
     the 256 (blocking, and 8 pipelined cycles); the bank equal to the
     same keys added unbatched under ingest="sort", the merged row to the
     host's max over those rows, the union within 2% of 10,240,000,
     seg_insert and merge_stack launched; batched insert keys/s,
     merge+count ms and the executor's run count for the batch; then the
     same batch under ingest="scatter", and 8 batches of 4096 x 8-key
     PFADDs into 4096 sketches alternating between a "scatter" and a
     "segment" client (the multi-target kernel against the flat scatter,
     end to end; replies and rows equal);
 14. the structures tier on the same client, each answer held against a
     plain-Python model: a 1M-entry RMap (put_all in 10,000-entry chunks,
     get_all of 100,000 keys), a 1M-member RScoredSortedSet (rank,
     value_range, value_range_by_score), an RBlockingQueue between 4
     producers and 4 consumers of 25,000 items each, 8 threads x 2,000
     RLock-guarded RAtomicLong increments, a 100,000-entry RMapCache with a
     1 s TTL swept empty by mc_evict_expired, 10,000 RTopic messages to 2
     listeners, and a mixed RBatch (10,000 map puts, 8 PFADDs, a Bloom add)
     equal to the same ops unbatched; host-tier ops/s of each;
 15. torch.profiler over 10 client PFMERGEs of config 3's sketches: one
     merge_stack kernel each, no memset, no host-to-device copy;
 16. with --profile, torch.profiler traces of short HLL and Bloom windows
     (device busy share, device time by kernel).

Each path (3, 7, 8, 10, 11, 13) resets the launch counters just before it
and reads them just after. The last lines are the card's name and power limit, a
JSON object with one entry per kernel, and `{"ok": true, "device": {...}}`.
Exits non-zero, with no result, when no card is visible or the package is
missing.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

RUN_LIMIT_S = 1100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # non-tensor 32-bit rate (the fp32 figure)
GOLDEN = 0x9E3779B97F4A7C15

# The main path's full width: BASELINE config 3's per-sketch load (40,000
# keys) over 1024 named sketches (a 64 MiB bank), one 8M-key PFADD (four
# MAX_BUCKET chunks through the staging pipeline), PFMERGE over 1000.
SKETCHES = 1024
KEYS = 40_000
BIG_KEYS = 1 << 23
MERGE_N = 1000
STRIDE = KEYS * 3 // 4  # neighbouring sketches share a quarter of their keys
EXACT_UNION = (MERGE_N - 1) * STRIDE + KEYS
TIMING_REPS = 5
# The Bloom path: BASELINE config 2 (benchmarks/suite.py: try_init(2^28 //
# 10, 0.01)), 10M inserts in 2M-key batches, contains of the first 1M,
# an FPR probe of 2^30 fresh keys.
BLOOM_N = 2**28 // 10
BLOOM_P = 0.01
BLOOM_M = 257_296_945
BLOOM_K = 7
BLOOM_KEYS = 10_000_000
BLOOM_BATCH = 2_000_000
BLOOM_CONTAINS = 1_000_000
FPR_PROBES = 1 << 30
FPR_CHUNK = 1 << 28
FPR_TOLERANCE = 0.05
# The BitSet path: one bitmap per day over a 2^27 user-id space (Redis's
# daily-active-users bitmap pattern), a week of them.
DAYS = 7
DAY_BITS = 1 << 27
DAY_SETS = 8_000_000
CHUNK = 1 << 21  # engine.MAX_BUCKET: SETBIT batches run in chunks this big
MASK63 = (1 << 63) - 1
# The mixed tape window: 2 * MIX_N HLLs, MIX_N Blooms of try_init(100_000,
# 0.01) (m = 958,505, 2^20 lanes) and MIX_N BitSets of 2^20 bits, 64 rows of
# 2^20 lanes: exactly the delta stack's cell budget.
MIX_N = 16
MIX_BLOOM_M = 958_505
MIX_BITS = 1 << 20
# BASELINE config 3 (benchmarks/suite.py config3): RBatch PFADD of 40,000
# seeded 8-byte keys into each of 256 sketches, then PFMERGE + PFCOUNT over
# the 256, blocking once and as 8 pipelined merge/count cycles.
B3_SKETCHES = 256
B3_KEYS = 40_000
B3_SEED = 3  # suite.py's key seed
B3_CYCLES = 8
# merge_stack's grid probe: (threads per strip, blocks per cluster)
MERGE_GRIDS = ((128, 8), (128, 4), (128, 16), (64, 8), (256, 8))
# The structures tier at sizes users run (host-side engine, no device work):
# a 1M-entry map written in 10,000-entry put_all chunks and read with one
# 100,000-key get_all; a 1M-member leaderboard; a blocking queue between 4
# producers and 4 consumers of 25,000 items each; 8 threads x 2,000 locked
# increments; a 100,000-entry map cache with a 1 s TTL swept empty; 10,000
# topic messages to 2 listeners; one mixed RBatch of 10,000 map puts, 8
# PFADDs and a Bloom add.
ST_MAP = 1_000_000
ST_MAP_CHUNK = 10_000
ST_MAP_GET = 100_000
ST_ZSET = 1_000_000
ST_ZSET_PROBES = 3
ST_QUEUE_THREADS = 4
ST_QUEUE_ITEMS = 25_000
ST_LOCK_THREADS = 8
ST_LOCK_ITERS = 2_000
ST_CACHE = 100_000
ST_CACHE_TTL_S = 1.0
ST_TOPIC = 10_000
ST_BATCH_PUTS = 10_000
ST_BATCH_HLLS = 8
# Per-sketch estimates: the RMS error must stay below 2%, and at most this
# share of sketches may exceed 2%. A single sketch is not held to 2%: the
# standard error at p = 14 is 0.81%, so 2% is a 2.5-sigma draw, and among
# 1024 sketches a few exceed it by chance.
MAX_SHARE_ABOVE_2PCT = 0.01


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call over `reps` calls, after a warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keys_for(lo: int, n: int, seed: int) -> np.ndarray:
    """n distinct uint64 keys: a bijection of the indices [lo, lo+n)."""
    idx = np.arange(lo, lo + n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return idx * np.uint64(GOLDEN) + np.uint64(seed)


# -- phase 2: kernels against their plain versions ---------------------------


def hashed_pairs(n: int, valid: int, g):
    """(bucket, rank) of n random 64-bit hashes at p = 14, as the engine
    passes them: lanes at or past `valid` are padding with rank 0."""
    import torch
    from redisson_tpu_torch.ops import hll

    h = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64, device=g.device,
                      generator=g)
    bucket, rank = hll.bucket_rank(h, hll.P)
    rank[valid:] = 0
    return bucket, rank


def check_kernels(seed: int, deferred: list):
    """seg_insert and merge_stack against their plain versions and their
    times (device-only times appended to `deferred`)."""
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import hll
    from redisson_tpu_torch.ops import kernels as ok

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = hll.M
    n = 1 << 21
    regs = torch.randint(0, 20, (m,), dtype=torch.int32, device=dev, generator=g)
    uniform = torch.randint(0, m, (n,), dtype=torch.int32, device=dev, generator=g)
    rank = torch.randint(0, 52, (n,), dtype=torch.int32, device=dev, generator=g)
    rank[: n // 8] = 0  # invalid lanes
    raised = regs.clone().scatter_reduce_(0, uniform.long(), rank, reduce="amax")
    client = hashed_pairs(1 << 16, KEYS, g)
    # name -> (start registers, bucket, rank, whether a register must rise)
    cases = {
        "uniform": (regs, uniform, rank, True),
        "hot_bucket": (regs, torch.full((n,), 12345, dtype=torch.int32, device=dev),
                       rank, True),
        "empty": (regs, uniform[:0], rank[:0], False),
        "all_invalid": (regs, uniform, torch.zeros_like(rank), False),
        "no_raise": (raised, uniform, rank, False),
        f"client batch ({KEYS} keys in 2^16 lanes)": (regs, *client, True),
    }
    seg_err = 0
    for name, (start, bucket, rk, rises) in cases.items():
        got, want = start.clone(), start.clone()
        got_flag = torch.zeros((1,), dtype=torch.bool, device=dev)  # set where one rose
        want_flag = got_flag.clone()
        if ik.hll_insert_segmented(got, bucket, rk, got_flag) is not got:
            raise AssertionError("seg_insert did not return the registers it was given")
        ik.hll_insert_segmented_plain(want, bucket, rk, want_flag)
        seg_err = max(seg_err, _same(f"seg_insert {name} n={bucket.numel()}", got, want),
                      _same(f"seg_insert {name} changed", got_flag, want_flag))
        if bool(got_flag) != rises:
            raise AssertionError(f"seg_insert {name}: changed is {bool(got_flag)}")

    # Timed as the engine calls it: in place into fresh copies of a sketch
    # holding one client batch, with the row's flag.
    sketch = torch.zeros((m,), dtype=torch.int32, device=dev)
    ik.hll_insert_segmented_plain(sketch, *hashed_pairs(KEYS, KEYS, g))
    flag = torch.zeros((1,), dtype=torch.bool, device=dev)
    seg = {}
    for shape, (bucket, rk) in ((f"[{n}] pairs", hashed_pairs(n, n, g)),
                                ("client batch", client)):
        idx = bucket.long()
        reps = 20 if shape == "client batch" else 10
        times = timed_merge(
            lambda c, b=bucket, r=rk: ik.hll_insert_segmented(c, b, r, flag),
            lambda c, b=bucket, r=rk: ik.hll_insert_segmented_plain(c, b, r, flag),
            lambda c, i=idx, r=rk: c.scatter_reduce_(0, i, r, reduce="amax"), sketch,
            reps=reps)
        # bucket and rank read once, the registers read and written once
        times["bound_ms"], times["bound_by"] = bound_ms(bucket.numel() * 8 + 2 * m * 4,
                                                        bucket.numel())
        scratch = sketch.clone()
        times["host_us"] = host_us(lambda: ik.hll_insert_segmented(scratch, bucket, rk, flag))
        times["library_host_us"] = host_us(
            lambda: scratch.scatter_reduce_(0, idx, rk, reduce="amax"))
        times["shape"] = shape
        times["grid"] = list(ik.seg_plan(bucket.numel(), m))  # [0, 0]: direct
        del scratch
        log(f"seg_insert {shape}: " + json.dumps(times))
        deferred.append((f"seg_insert {shape}", times, "device_ms",
                         lambda c, b=bucket, r=rk: ik.hll_insert_segmented(c, b, r, flag),
                         sketch, reps))
        deferred.append((f"scatter_reduce_ amax {shape}", times, "library_device_ms",
                         lambda c, i=idx, r=rk: c.scatter_reduce_(0, i, r, reduce="amax"),
                         sketch, reps))
        seg[shape] = times
    # The row is the timed dict itself: its device-only time is filled in last.
    row = seg[f"[{n}] pairs"]
    row.update(client_batch=seg["client batch"], max_abs_err=seg_err)
    # The basis of `seg_plan`: device-only times of the direct kernel beside
    # the shared one at batch sizes around the switch, and of other grids of
    # the shared kernel at 2^21 pairs.
    shared = ik._kernel("seg_insert_shared_i32")
    direct = ik._kernel("seg_insert_direct_i32")
    for lanes, grids in ((1 << 16, ((0, 0), (8, 8))), (1 << 18, ((0, 0), (32, 8))),
                         (1 << 19, ((0, 0), (64, 8))),
                         (n, ((0, 0), (64, 8), (128, 8), (64, 4), (32, 8)))):
        bucket, rk = client if lanes == 1 << 16 else hashed_pairs(lanes, lanes, g)
        for blocks, cluster in grids:
            def raw(c, blocks=blocks, cluster=cluster, b=bucket, r=rk):
                stream = torch.cuda.current_stream().cuda_stream
                rc = (shared(c.data_ptr(), m, b.data_ptr(), r.data_ptr(), b.numel(), blocks,
                             cluster, flag.data_ptr(), 0, stream) if blocks else
                      direct(c.data_ptr(), m, b.data_ptr(), r.data_ptr(), b.numel(),
                             flag.data_ptr(), 0, stream))
                if rc:
                    raise RuntimeError(f"seg_insert launch failed: CUDA error {rc}")
            what = f"{blocks} x {cluster} shared" if blocks else "direct"
            deferred.append((f"seg_insert {what} kernel at [{lanes}] lanes", {}, "device_ms",
                             raw, sketch, 10))

    row["multi_target"] = check_seg_rows(g, deferred)

    return row, check_merge(g, deferred)


def merge_forms(rows):
    """One row list in the forms merge_stack takes: by value from numpy (the
    client's) and from a CPU tensor, and as a device tensor."""
    return {"numpy": rows.cpu().numpy(), "cpu tensor": rows.cpu(), "device": rows}


def check_merge(g, deferred: list) -> dict:
    """merge_stack against its plain version (bit-identical) over stacks and
    listed bank rows in every form, its grid probe, its times in turns with
    torch.amax, and the host-cost breakdown of one call (device-only times
    appended to `deferred`)."""
    import torch
    from redisson_tpu_torch.ops import hll
    from redisson_tpu_torch.ops import kernels as ok

    dev, m = g.device, hll.M
    err = 0

    def same(name, got, want):
        nonlocal err
        err = max(err, _same(name, got, want))

    def once(name, fn, launched=True):
        # exactly one launch per call with rows, none without
        before = ok.launches["merge_stack"]
        out = fn()
        if ok.launches["merge_stack"] - before != int(launched):
            raise AssertionError(f"merge_stack {name}: {ok.launches['merge_stack'] - before} "
                                 "launches in one call")
        return out

    for s in (SKETCHES, MERGE_N, B3_SKETCHES, 0):
        stack = torch.randint(0, 52, (s, m), dtype=torch.int32, device=dev, generator=g)
        same(f"merge_stack S={s}", once(f"S={s}", lambda: ok.merge_stack(stack), s > 0),
             ok.merge_stack_plain(stack))
    # Listed rows of a bank: the paths' heights (config 3's 256 sketches and
    # the target, the HLL path's 1000 and the target), small lists, and each
    # by-value capacity +-1, in every form; random lists repeat rows. Then
    # rows out of range (skipped), a list of one row repeated, and a list
    # with no row in range.
    height = SKETCHES + 4
    bank = torch.randint(0, 52, (height, m), dtype=torch.int32, device=dev, generator=g)
    heights = sorted({2, 16, 64, B3_SKETCHES + 1, MERGE_N + 1}
                     | {c + d for c in ok.ROW_CAPACITIES for d in (-1, 0, 1)})
    for r in heights:
        rows = torch.randint(0, height, (r,), dtype=torch.int32, device=dev, generator=g)
        want = ok.merge_stack_plain(bank, rows)
        for form, given in merge_forms(rows).items():
            same(f"merge_stack over {r} bank rows ({form})",
                 once(form, lambda: ok.merge_stack(bank, given)), want)
        wild = rows.clone()
        wild[::3] = height
        wild[1::5] = -1
        wild[2::7] = 1 << 30
        want = ok.merge_stack_plain(bank, wild[(wild >= 0) & (wild < height)])
        for form, given in merge_forms(wild).items():
            same(f"merge_stack over {r} rows, some out of range ({form})",
                 once(form, lambda: ok.merge_stack(bank, given)), want)
    for name, rows in (("one row 257 times", torch.full((257,), 7, dtype=torch.int32)),
                       ("no row in range", torch.tensor([-1, height, 1 << 30] * 3,
                                                        dtype=torch.int32))):
        rows = rows.to(dev)
        want = ok.merge_stack_plain(bank, rows[(rows >= 0) & (rows < height)])
        for form, given in merge_forms(rows).items():
            same(f"merge_stack over {name} ({form})",
                 once(form, lambda: ok.merge_stack(bank, given)), want)

    # The grid probe behind MERGE_THREADS and MERGE_CLUSTER: device-only
    # times of other strip widths and cluster sizes (above 8: non-portable)
    # at the client's heights, each call on a stack of its own.
    entry = ok._kernel("merge_stack_i32")
    for s in (B3_SKETCHES, B3_SKETCHES + 1, MERGE_N + 1, SKETCHES):
        src = torch.randint(0, 52, (s, m), dtype=torch.int32, device=dev, generator=g)
        for threads, cluster in MERGE_GRIDS:
            plan = ok.merge_plan(s, m, threads, cluster)
            out = torch.empty((m,), dtype=torch.int32, device=dev)
            rc = entry(src.data_ptr(), None, out.data_ptr(), s, s, m, *plan, 0, 0,
                       ok._stream(src))
            if rc:
                raise RuntimeError(f"merge_stack grid {plan}: CUDA error {rc}")
            same(f"merge_stack grid {plan} S={s}", out, ok.merge_stack_plain(src))

            def raw(b, plan=plan, s=s, out=out):
                rc = entry(b.data_ptr(), None, out.data_ptr(), s, s, m, *plan, 0, 0,
                           ok._stream(b))
                if rc:
                    raise RuntimeError(f"merge_stack launch failed: CUDA error {rc}")
            deferred.append((f"merge_stack grid {threads} threads x {cluster} at S={s}",
                             {}, "device_ms", raw, src, 10))
        if s not in (B3_SKETCHES + 1, MERGE_N + 1):
            continue
        # The same stack through the plan's grid as a whole stack and through
        # a row list from the host and on the card, in order and shuffled:
        # what the list's form and the order of the rows cost.
        order = torch.arange(s, dtype=torch.int32, device=dev)
        shuffled = torch.randperm(s, device=dev, generator=g).to(torch.int32)
        for what, rows in (("whole stack", None), ("host list", order.cpu().numpy()),
                           ("device list", order), ("device list shuffled", shuffled),
                           ("host list shuffled", shuffled.cpu().numpy())):
            deferred.append((f"merge_stack S={s} {what}, plan {ok.merge_plan(s, m)}", {},
                             "device_ms", lambda b, rows=rows: ok.merge_stack(b, rows),
                             src, 10))

    # Times, in turns (kernel, torch.amax, torch.amax, kernel, three times):
    # stacks of config 3's and the HLL path's heights, and R listed bank rows
    # from the host (the client's form) against amax over the rows gathered
    # beforehand. Device-only times: "device_ms" with each call on a copy of
    # its own (the 16-64 MiB read from HBM, as the bound counts it),
    # "device_ms_warm" on one buffer (rows in L2 where they fit, as earlier
    # versions of this script took it).
    mrg = {}
    stack = torch.randint(0, 52, (MERGE_N, m), dtype=torch.int32, device=dev, generator=g)
    cases = [(f"S={s}", stack[:s].contiguous(), None) for s in (B3_SKETCHES, MERGE_N)]
    for r in (2, 16, 64, B3_SKETCHES + 1, MERGE_N + 1):
        rows = torch.randperm(height, device=dev, generator=g)[:r].to(torch.int32)
        cases.append((f"rows R={r}", bank, rows.cpu().numpy()))
    for key, src, rows in cases:
        r = src.shape[0] if rows is None else rows.shape[0]
        lib_src = src if rows is None else bank[torch.from_numpy(rows).to(dev).long()]
        kernel = (lambda b=src: ok.merge_stack(b)) if rows is None else (
            lambda rows=rows: ok.merge_stack(bank, rows))
        amax = lambda b=lib_src: torch.amax(b, 0)  # noqa: E731
        part = {"ms": [], "library_ms": []}
        for _ in range(3):
            part["ms"].append(cuda_ms(kernel))
            part["library_ms"] += [cuda_ms(amax), cuda_ms(amax)]
            part["ms"].append(cuda_ms(kernel))
        plain_rows = None if rows is None else torch.from_numpy(rows).to(dev)
        part["plain_ms"] = cuda_ms(lambda: ok.merge_stack_plain(src, plain_rows))
        part["host_us"] = host_us(kernel)
        part["library_host_us"] = host_us(amax)
        # the merged rows read once, the list read and the output written once
        part["bound_ms"], part["bound_by"] = bound_ms(
            r * m * 4 + (0 if rows is None else r * 4) + m * 4, r * m)
        mrg[key] = part
        log(f"merge_stack {key}: " + json.dumps(part))
        if r != 16:
            cold = ((lambda b: ok.merge_stack(b)) if rows is None else
                    (lambda b, rows=rows: ok.merge_stack(b, rows)))
            deferred += [
                (f"merge_stack {key}", part, "device_ms", cold, src, 10),
                (f"merge_stack {key}, one buffer", part, "device_ms_warm",
                 lambda _b, k=kernel: k(), src[:1], 10),
                (f"torch.amax {key}", part, "library_device_ms",
                 lambda b: torch.amax(b, 0), lib_src, 10),
                (f"torch.amax {key}, one buffer", part, "library_device_ms_warm",
                 lambda _b, a=amax: a(), src[:1], 10)]
    mrg["host_breakdown"] = merge_host_breakdown(bank, stack[:B3_SKETCHES].contiguous(), g)
    # The kernel's line: the client's form at config 3's height.
    top = mrg[f"rows R={B3_SKETCHES + 1}"]
    mrg.update(ms=sorted(top["ms"])[len(top["ms"]) // 2], plain_ms=top["plain_ms"],
               library_ms=sorted(top["library_ms"])[len(top["library_ms"]) // 2],
               bound_ms=top["bound_ms"], bound_by=top["bound_by"], max_abs_err=err)
    return mrg


def merge_host_breakdown(bank, stack, g) -> dict:
    """Host microseconds per call (host clock, no sync) of each step of a
    client merge of 257 listed bank rows (and of a stack of 256): a foreign
    call of a no-op C entry with merge_stack's argument types, the output's
    allocation, the wrapper's checks and plan, the stream handle, the launch
    alone (the C entry: row list copied into the parameters, the launch),
    the whole wrapper, torch.amax; what the engine paid per merge before
    (a device copy of the list); the launch at each by-value capacity."""
    import torch
    from redisson_tpu_torch.ops import kernels as ok

    dev, (height, m) = g.device, bank.shape
    entry, noop = ok._kernel("merge_stack_i32"), ok._kernel("merge_stack_noop")
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    stream = ok._stream(bank)
    rows = torch.randperm(height, device=dev, generator=g)[:B3_SKETCHES + 1].to(
        torch.int32).cpu().numpy()
    gathered = bank[torch.from_numpy(rows).to(dev).long()]

    def args(r, cap, rows_arg, src=bank, h=height):
        return (src.data_ptr(), rows_arg, out.data_ptr(), r, h, m, *ok.merge_plan(r, m), cap,
                0, stream)

    client = args(len(rows), ok.rows_capacity(len(rows)), rows.tobytes())
    whole = args(stack.shape[0], 0, None, stack, stack.shape[0])
    parts = {
        "ctypes_noop": host_us(lambda: noop(*client)),
        "torch_empty": host_us(lambda: torch.empty((m,), dtype=torch.int32, device=dev)),
        "new_empty": host_us(lambda: bank.new_empty((m,))),
        "checks": host_us(lambda: ok._merge_args(bank, rows)),
        "plan": host_us(lambda: ok.merge_plan(len(rows), m)),
        "stream": host_us(lambda: ok._stream(bank)),
        "launch": host_us(lambda: entry(*client)),
        "merge_stack": host_us(lambda: ok.merge_stack(bank, rows)),
        "torch_amax": host_us(lambda: torch.amax(gathered, 0)),
        "rows_to_device": host_us(lambda: torch.as_tensor(rows, device=dev)),
        "merge_stack_device_rows": host_us(
            lambda: ok.merge_stack(bank, torch.as_tensor(rows, device=dev))),
        "stack_launch": host_us(lambda: entry(*whole)),
        "stack_merge_stack": host_us(lambda: ok.merge_stack(stack)),
        "stack_torch_amax": host_us(lambda: torch.amax(stack, 0)),
    }
    # What the size of the parameter block costs: 2 rows at each capacity,
    # and as a device pointer.
    two = rows[:2].copy()
    dev_two = torch.from_numpy(two).to(dev)
    for cap in ok.ROW_CAPACITIES:
        parts[f"launch_2_rows_cap_{cap}"] = host_us(lambda cap=cap: entry(*args(2, cap,
                                                                              two.tobytes())))
    parts["launch_2_rows_device"] = host_us(lambda: entry(*args(2, 0, dev_two.data_ptr())))
    torch.cuda.synchronize()
    if not torch.equal(out, ok.merge_stack_plain(bank, dev_two)):
        raise AssertionError("merge_stack's last breakdown launch disagrees")
    log("merge_stack host us per call (R = 257 listed rows, S = 256 stack): "
        + json.dumps(parts))
    return parts


def check_seg_rows(g, deferred: list) -> dict:
    """seg_insert's multi-target form against its plain version (the flat
    scatter) and the engine's flat scatter with its flags, at a config 3
    chunk (2^21 lanes over 256 sketches of a bank) and a window of 4096
    small PFADDs of 8 keys to distinct sketches."""
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import hll

    dev, m = g.device, hll.M

    def flat_scatter(b, bucket, rank, rows):
        # engine._bank_add's scatter branch, flags included
        s = b.shape[0]
        idx = rows.long() * m + bucket
        flat = b.view(-1)
        raised = (rank > flat[idx]).to(torch.int32)
        changed = torch.zeros(s, dtype=torch.int32, device=b.device)
        changed.scatter_reduce_(0, rows.long(), raised, reduce="amax")
        flat.scatter_reduce_(0, idx, rank, reduce="amax")
        return changed > 0

    out, err = {}, 0
    for shape, height, n, targets in (("config 3 chunk", B3_SKETCHES + 4, CHUNK, B3_SKETCHES),
                                      ("4096 x 8-key window", 4096, 4096 * 8, 4096)):
        bucket, rank = hashed_pairs(n, n, g)
        rows = (torch.arange(n, device=dev, dtype=torch.int32) * targets // n
                if targets == 4096 else
                torch.randint(0, targets, (n,), dtype=torch.int32, device=dev, generator=g))
        start = torch.randint(0, 12, (height, m), dtype=torch.int32, device=dev, generator=g)
        held = start.clone().view(-1).scatter_reduce_(
            0, rows.long() * m + bucket.long(), rank, reduce="amax").view(height, m)
        for case, src in (("fresh", start), ("no_raise", held)):
            got, want = src.clone(), src.clone()
            gflag = torch.zeros(height, dtype=torch.bool, device=dev)
            wflag = gflag.clone()
            ik.hll_insert_segmented_rows(got, bucket, rank, rows, gflag)
            ik.hll_insert_segmented_rows_plain(want, bucket, rank, rows, wflag)
            err = max(err, _same(f"seg_insert rows {shape} {case}", got, want),
                      _same(f"seg_insert rows {shape} {case} changed", gflag, wflag))
            if bool(gflag.any()) != (case == "fresh"):
                raise AssertionError(f"seg_insert rows {shape} {case}: flags {gflag.sum()}")
        flags = torch.zeros(height, dtype=torch.bool, device=dev)
        idx = rows.long() * m + bucket.long()
        times = timed_merge(
            lambda b, bk=bucket, r=rank, w=rows, f=flags: ik.hll_insert_segmented_rows(
                b, bk, r, w, f),
            lambda b, bk=bucket.long(), r=rank, w=rows: flat_scatter(b, bk, r, w),
            lambda b, i=idx, r=rank: b.view(-1).scatter_reduce_(0, i, r, reduce="amax"),
            start, reps=10)
        # bucket, rank and row read once; each 32-byte sector of registers
        # the pairs land on read and written once
        sectors = int(torch.unique(idx >> 3).numel())
        times["bound_ms"], times["bound_by"] = bound_ms(n * 12 + 2 * sectors * 32, n)
        times["sectors"] = sectors
        scratch = start.clone()
        times["host_us"] = host_us(
            lambda: ik.hll_insert_segmented_rows(scratch, bucket, rank, rows, flags))
        times["plain_host_us"] = host_us(
            lambda: flat_scatter(scratch, bucket.long(), rank, rows))
        del scratch
        log(f"seg_insert rows {shape}: " + json.dumps(times))
        deferred.append((f"seg_insert rows {shape}", times, "device_ms",
                         lambda b, bk=bucket, r=rank, w=rows, f=flags:
                         ik.hll_insert_segmented_rows(b, bk, r, w, f), start, 10))
        deferred.append((f"flat scatter + flags {shape}", times, "plain_device_ms",
                         lambda b, bk=bucket.long(), r=rank, w=rows: flat_scatter(b, bk, r, w),
                         start, 10))
        out[shape] = times
    out["max_abs_err"] = err
    return out


def _same(name: str, got, want) -> int:
    """Raise unless `got` equals `want`; return their max abs difference."""
    import torch

    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    log(f"{name}: max_abs_err={err}")
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_bits_kernels(seed: int, deferred: list):
    """The BitSet / Bloom kernels against their plain versions at the Bloom
    and BitSet paths' shapes, and their times (device-only times appended
    to `deferred`)."""
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def cells_of(n, density):
        return (torch.rand(n, device=dev, generator=g) < density).to(torch.uint8)

    pop_err = 0
    for n in (DAY_BITS, BLOOM_M, 1_000_003, 0):
        cells = cells_of(n, 0.3)
        pop_err = max(pop_err, _same(f"popcount_partials n={n}",
                                     ok.popcount_partials(cells),
                                     ok.popcount_partials_plain(cells)))
    cells = cells_of(BLOOM_M, 0.3)
    groups = -(-BLOOM_M // ok.POPCOUNT_BLOCK)
    pop = {"ms": cuda_ms(lambda: ok.popcount_partials(cells)),
           "plain_ms": cuda_ms(lambda: ok.popcount_partials_plain(cells)),
           "library_ms": cuda_ms(lambda: cells.sum(dtype=torch.int64)),
           "max_abs_err": pop_err}
    pop["bound_ms"], pop["bound_by"] = bound_ms(BLOOM_M + 4 * groups, BLOOM_M)
    day = cells_of(DAY_BITS, 0.06)
    log(f"popcount_partials over 2^27 cells: "
        f"{cuda_ms(lambda: ok.popcount_partials(day)):.4f} ms")

    stack = torch.stack([cells_of(DAY_BITS, 0.06) for _ in range(DAYS + 1)])
    bit_err = 0
    for op in ("and", "or", "xor"):
        bit_err = max(bit_err, _same(f"bitop_cells {op} [{DAYS + 1}, 2^27]",
                                     ok.bitop_cells(stack, op),
                                     ok.bitop_cells_plain(stack, op)))
    ragged = stack[:3, :1_000_003].contiguous()
    bit_err = max(bit_err, _same("bitop_cells xor [3, 1000003]",
                                 ok.bitop_cells(ragged, "xor"),
                                 ok.bitop_cells_plain(ragged, "xor")))
    bop = {"ms": cuda_ms(lambda: ok.bitop_cells(stack, "or")),
           "plain_ms": cuda_ms(lambda: ok.bitop_cells_plain(stack, "or")),
           "library_ms": cuda_ms(lambda: stack.amax(0)),
           "max_abs_err": bit_err}
    bop["bound_ms"], bop["bound_by"] = bound_ms((DAYS + 2) * DAY_BITS,
                                                DAYS * DAY_BITS)
    for op, lib in (("and", lambda: stack.amin(0)), ("xor", None)):
        log(f"bitop_cells {op}: {cuda_ms(lambda: ok.bitop_cells(stack, op)):.4f} ms, "
            f"library "
            + (f"{cuda_ms(lib):.4f} ms" if lib else "none (no single call)"))

    cells = cells_of(BLOOM_M, 0.01)
    n = CHUNK * BLOOM_K
    idx = torch.randint(0, BLOOM_M, (n,), device=dev, generator=g)
    idx[: n // 10] = idx[n // 10: 2 * (n // 10)]  # duplicates
    idx[torch.rand(n, device=dev, generator=g) < 0.05] = BLOOM_M  # sentinels
    seg_err = _same(f"bits_insert_segmented m={BLOOM_M} n={n}",
                    ik.bits_insert_segmented(cells.clone(), idx),
                    ik.bits_insert_segmented_plain(cells.clone(), idx))
    small = cells_of(3 * (1 << 16) + 7, 0.01)
    sidx = torch.randint(-5, small.numel() + 3, (50_000,), device=dev, generator=g)
    for name, lo in (("m=196615 (ragged slab)", 0), ("odd-offset view", 1)):
        got, want = small.clone(), small.clone()
        ik.bits_insert_segmented(got[lo:], sidx)
        ik.bits_insert_segmented_plain(want[lo:], sidx)
        seg_err = max(seg_err, _same(f"bits_insert_segmented {name}", got, want))
    # In place: each timed call merges into a fresh copy of the same cells.
    vidx = idx[idx < BLOOM_M]  # the library call takes no sentinel
    seg = timed_merge(lambda c: ik.bits_insert_segmented(c, idx),
                      lambda c: ik.bits_insert_segmented_plain(c, idx),
                      lambda c: c.scatter_(0, vidx, 1), cells)
    deferred.append(("bits_insert_segmented", seg, "device_ms",
                     lambda c: ik.bits_insert_segmented(c, idx), cells, 5))
    # Each code read once, each 32-byte sector it touches read and written once.
    sectors = int(torch.unique(vidx >> 5).numel())
    seg["bound_ms"], seg["bound_by"] = bound_ms(n * idx.element_size() + 64 * sectors, n)
    seg["max_abs_err"] = seg_err
    log(f"bits_insert_segmented m={BLOOM_M}, {n} int64 codes touching {sectors} "
        f"sectors: " + json.dumps(seg))
    return pop, bop, seg


# -- phase 3: the main path --------------------------------------------------


def median_spread(samples):
    """(median, min, max) of a list of numbers."""
    return float(np.median(samples)), float(min(samples)), float(max(samples))


def drive(client, seed: int):
    """The main-path ops; returns what the checks read."""
    names = [f"hll:{i}" for i in range(SKETCHES)]
    batches = [keys_for(i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
    big = keys_for(1 << 40, BIG_KEYS, seed)

    out = {}
    futs = [client.get_hyper_log_log(n).add_ints_async(b)
            for n, b in zip(names, batches)]
    out["added"] = [f.result() for f in futs]
    out["big_added"] = client.get_hyper_log_log("hll:big").add_ints(big)
    out["counts"] = [client.get_hyper_log_log(n).count() for n in names]
    out["big_count"] = client.get_hyper_log_log("hll:big").count()
    client.get_hyper_log_log("union:merge").merge_with(*names[:MERGE_N])
    out["merge_count"] = client.get_hyper_log_log("union:merge").count()
    out["merge_and_count"] = client.get_hyper_log_log(
        "union:mc").merge_with_and_count(*names[:MERGE_N])
    out["count_with"] = client.get_hyper_log_log(names[0]).count_with(*names[1:])
    return out


def count_merged(client, names):
    import torch
    from redisson_tpu_torch import engine

    rows = torch.tensor([client.sketch._rows[n] for n in names],
                        device=client.device)
    stack = client._executor.execute_barrier(
        lambda: client.sketch.bank[rows].contiguous()).result()
    return int(round(float(engine.hll_count_merged(stack)))), stack


def main_path(seed: int):
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok

    ik.reset_launches()
    ok.reset_launches()
    client = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    res = drive(client, seed)
    cm, stack = count_merged(client, [f"hll:{i}" for i in range(SKETCHES)])
    torch.cuda.synchronize()
    launches = {"seg_insert": ik.launches["seg_insert"],
                "merge_stack": ok.launches["merge_stack"]}
    log(f"main path launches: {launches}")
    if not all(res["added"]) or not res["big_added"]:
        raise AssertionError("a first PFADD into an empty sketch reported no change")
    errs = np.array([abs(c - KEYS) / KEYS for c in res["counts"]])
    rms = float(np.sqrt(np.mean(errs ** 2)))
    share = float(np.mean(errs > 0.02))
    log(f"per-sketch count error: rms {rms:.5f}, max {errs.max():.5f}, "
        f"{int((errs > 0.02).sum())}/{len(errs)} above 0.02 (limit "
        f"{MAX_SHARE_ABOVE_2PCT:.0%} of sketches; std err at p=14 is 0.0081)")
    big_err = abs(res["big_count"] - BIG_KEYS) / BIG_KEYS
    merge_err = abs(res["merge_count"] - EXACT_UNION) / EXACT_UNION
    mc_err = abs(res["merge_and_count"] - EXACT_UNION) / EXACT_UNION
    log(f"big sketch error {big_err:.5f}; union of {MERGE_N}: exact {EXACT_UNION}, "
        f"merge_with {res['merge_count']} ({merge_err:.5f}), "
        f"merge_with_and_count {res['merge_and_count']} ({mc_err:.5f})")
    log(f"hll_count_merged over [{stack.shape[0]}, {stack.shape[1]}]: {cm}; "
        f"count_with: {res['count_with']}")
    if rms >= 0.02 or big_err >= 0.02 or merge_err >= 0.02 or mc_err >= 0.02:
        raise AssertionError("estimate error at or above 2%")
    if share > MAX_SHARE_ABOVE_2PCT:
        raise AssertionError(f"{share:.2%} of sketches above 2% error")
    if cm != res["count_with"]:
        raise AssertionError("hll_count_merged disagrees with count_with")
    if not launches["seg_insert"] or not launches["merge_stack"]:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    bank, rows = client.to_numpy_state()
    client.shutdown()

    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    ref_res = drive(ref, seed)
    ref_bank, ref_rows = ref.to_numpy_state()
    ref.shutdown()
    same_bank(bank, rows, ref_bank, ref_rows, "ingest=segment")
    return launches, (ref_res, ref_bank, ref_rows)


def same_bank(bank, rows, ref_bank, ref_rows, what: str) -> None:
    if set(rows) != set(ref_rows) or any(
            not np.array_equal(bank[r], ref_bank[ref_rows[n]]) for n, r in rows.items()):
        raise AssertionError(f"{what} registers differ from ingest=sort")
    log(f"final bank under {what}: all {len(rows)} sketches bit-identical to "
        "ingest=sort")


def rates(seed: int, card: str):
    """Warm end-to-end rates through the client, ingest="segment".

    One untimed pass at each shape first takes the first-use costs (bank
    growth, sort scratch, pinned staging buffers, the copy stream) out of
    the window. Each timed pass then adds fresh keys into the same
    sketches, so every PFADD raises registers and the bank keeps its size.
    """
    import torch
    from redisson_tpu_torch import engine
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    client = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    names = [f"t:{i}" for i in range(SKETCHES)]
    hlls = [client.get_hyper_log_log(n) for n in names]
    big = client.get_hyper_log_log("t:big")
    union = client.get_hyper_log_log("t:union")
    many, one, merge = [], [], []
    for rep in range(TIMING_REPS + 1):
        lo = rep * (1 << 36)
        batches = [keys_for(lo + i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
        big_keys = keys_for(lo + (1 << 35), BIG_KEYS, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [h.add_ints_async(b) for h, b in zip(hlls, batches)]
        [f.result() for f in futs]
        t1 = time.perf_counter()
        big.add_ints(big_keys)
        t2 = time.perf_counter()
        union.merge_with(*names[:MERGE_N])
        t3 = time.perf_counter()
        if rep:  # rep 0 is the warm-up pass
            many.append(SKETCHES * KEYS / (t1 - t0))
            one.append(BIG_KEYS / (t2 - t1))
            merge.append((t3 - t2) * 1e3)
    _, stack = count_merged(client, names[:MERGE_N])
    client.shutdown()
    pfmerge = [cuda_ms(lambda: engine.hll_count_merged(stack), 10)
               for _ in range(TIMING_REPS)]
    report(card, [
        (f"PFADD through the client, {SKETCHES} sketches x {KEYS} keys",
         [r / 1e6 for r in many], "M inserts/s"),
        (f"PFADD through the client, one {BIG_KEYS}-key batch",
         [r / 1e6 for r in one], "M inserts/s"),
        (f"client merge_with over {MERGE_N} sketches", merge, "ms"),
        (f"PFMERGE+count over {MERGE_N} sketches (engine.hll_count_merged)",
         pfmerge, "ms")], ", ingest=segment")


def auto_path(seed: int):
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    client = RedissonTorch.create(Config().use_cuda(ingest="auto"))
    for i in range(8):
        client.get_hyper_log_log(f"auto:{i}").add_ints(
            keys_for(i * KEYS, KEYS, seed))
    client.get_hyper_log_log("auto:big").add_ints(keys_for(1 << 41, 1 << 21, seed))
    bloom = client.get_bloom_filter("auto:bloom")
    bloom.try_init(BLOOM_N, BLOOM_P)
    bloom.add_ints(bloom_keys(0, BLOOM_BATCH, seed))
    sketch = client.sketch
    log("ingest=auto choices: "
        + json.dumps({f"hll@{n}": sketch.planner.plan("hll", n).path
                      for n in (KEYS, 1 << 21)}
                     | {f"bits@{BLOOM_BATCH}": sketch.planner.plan("bits", BLOOM_BATCH).path}))
    log("ingest=auto cost table (ns/key): " + json.dumps(sketch.planner.table()))
    client.shutdown()


def small_vs_cpu(seed: int):
    """The same small op script on the card and on the CPU path."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    states = []
    for device in ("cuda:0", "cpu"):
        c = RedissonTorch.create(Config().use_cuda(device=device, ingest="segment"))
        for i in range(4):
            h = c.get_hyper_log_log(f"s:{i}")
            h.add_ints(keys_for(i * 1500, 3000, seed))
            h.add_all([f"member-{i}-{j}".encode() * (1 + j % 5) for j in range(500)])
        c.get_hyper_log_log("s:0").merge_with("s:1", "s:2", "s:3")
        states.append(c.to_numpy_state())
        c.shutdown()
    (gb, gr), (cb, cr) = states
    if set(gr) != set(cr) or any(
            not np.array_equal(gb[r], cb[cr[n]]) for n, r in gr.items()):
        raise AssertionError("card and CPU paths disagree on a small input")
    log("small input: card bank bit-identical to the CPU path")


# -- phases 7-9: the Bloom and BitSet paths ----------------------------------


def bloom_keys(lo: int, n: int, seed: int) -> np.ndarray:
    """n distinct uint64 keys in [0, 2^63): a bijection of [lo, lo+n) mod 2^63."""
    return keys_for(lo, n, seed) & np.uint64(MASK63)


def fpr_probes(seed: int):
    """FPR_PROBES fresh keys on the card, in FPR_CHUNK tensors: top bit set,
    so none was inserted (inserts lie in [0, 2^63))."""
    import torch

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    top = torch.tensor(-(1 << 63), dtype=torch.int64, device=dev)
    return [torch.randint(0, 1 << 62, (FPR_CHUNK,), dtype=torch.int64, device=dev,
                          generator=g) | top
            for _ in range(FPR_PROBES // FPR_CHUNK)]


def probe_hits(bloom, probes) -> int:
    futs = [bloom.contains_count_device_async(p) for p in probes]
    return sum(f.result() for f in futs)


def bloom_fill(client, name: str, seed: int):
    """try_init at BASELINE config 2's width and add BLOOM_KEYS keys in
    BLOOM_BATCH-key batches -> (filter, added flags)."""
    f = client.get_bloom_filter(name)
    if not f.try_init(BLOOM_N, BLOOM_P):
        raise AssertionError(f"try_init of a fresh filter {name!r} returned False")
    added = [f.add_ints(bloom_keys(lo, BLOOM_BATCH, seed))
             for lo in range(0, BLOOM_KEYS, BLOOM_BATCH)]
    return f, np.concatenate(added)


def export_cells(client, name: str) -> np.ndarray:
    return client._executor.execute_sync(name, "bits_export", None)[1]


def bloom_path(seed: int, probes):
    """The Bloom path under ingest="segment" (counted), then the same adds
    under ingest="scatter" for the cell comparison."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import bloom_math
    from redisson_tpu_torch.ops import kernels as ok

    ik.reset_launches()
    ok.reset_launches()
    client = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    f, added = bloom_fill(client, "bloom", seed)
    m, k = f.get_size(), f.get_hash_iterations()
    first = f.contains_ints(bloom_keys(0, BLOOM_CONTAINS, seed))
    hits = probe_hits(f, probes)
    count = f.count()
    torch.cuda.synchronize()
    launches = {"bits_insert_segmented": ik.launches["bits_insert_segmented"],
                "popcount_partials": ok.launches["popcount_partials"]}
    log(f"bloom path launches: {launches}")
    cells = export_cells(client, "bloom")
    client.shutdown()

    log(f"bloom geometry: m={m}, k={k}")
    if (m, k) != (BLOOM_M, BLOOM_K):
        raise AssertionError(f"try_init({BLOOM_N}, {BLOOM_P}) gave m={m}, k={k}")
    if not first.all():
        raise AssertionError(f"{int((~first).sum())} false negatives among the "
                             f"first {BLOOM_CONTAINS} inserted keys")
    bitcount = int(np.count_nonzero(cells))
    fpr = hits / FPR_PROBES
    expected = (bitcount / m) ** k
    closed = (1 - np.exp(-k * BLOOM_KEYS / m)) ** k
    log(f"bloom: {BLOOM_KEYS} inserts ({int(added.sum())} reported new), "
        f"BITCOUNT {bitcount}; FPR over {FPR_PROBES} fresh probes {hits} hits = "
        f"{fpr:.6e}; (BITCOUNT/m)^k = {expected:.6e} (ratio {fpr / expected:.4f}, "
        f"limit +-{FPR_TOLERANCE:.0%}); closed form (1-e^(-kn/m))^k = {closed:.6e}")
    if abs(fpr / expected - 1) > FPR_TOLERANCE:
        raise AssertionError("FPR outside the tolerance of (BITCOUNT/m)^k")
    want_count = int(round(bloom_math.count_estimate(bitcount, m, k)))
    log(f"bloom count(): {count}; count_estimate(BITCOUNT) {want_count}")
    if count != want_count:
        raise AssertionError("bloom count() disagrees with the exact BITCOUNT")
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"kernel {name} never launched on the bloom path")

    ref = RedissonTorch.create(Config().use_cuda(ingest="scatter"))
    _, ref_added = bloom_fill(ref, "bloom", seed)
    ref_cells = export_cells(ref, "bloom")
    ref.shutdown()
    if not np.array_equal(cells, ref_cells) or not np.array_equal(added, ref_added):
        raise AssertionError("ingest=segment bloom cells or flags differ from scatter")
    log("bloom: cells and added flags under ingest=segment bit-identical to scatter")
    return launches, (ref_cells, ref_added)


def day_ids(seed: int):
    rng = np.random.default_rng(seed + 3)
    return [rng.integers(0, DAY_BITS, DAY_SETS) for _ in range(DAYS)]


def bitset_path(seed: int, card: str):
    """The BitSet path, every result against numpy; then its rates."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok

    ids = day_ids(seed)
    ref = np.zeros((DAYS, DAY_BITS), np.uint8)
    want_old = []
    for d in range(DAYS):
        old = np.empty(DAY_SETS, bool)
        for lo in range(0, DAY_SETS, CHUNK):  # chunks see earlier chunks' bits
            chunk = ids[d][lo: lo + CHUNK]
            old[lo: lo + chunk.shape[0]] = ref[d, chunk] != 0
            ref[d, chunk] = 1
        want_old.append(old)
    names = [f"day:{d}" for d in range(DAYS)]

    ik.reset_launches()
    ok.reset_launches()
    client = RedissonTorch.create(Config().use_cuda())
    days = [client.get_bit_set(n) for n in names]
    olds = [b.set_bits(i) for b, i in zip(days, ids)]
    counts = [b.cardinality() for b in days]
    week = client.get_bit_set("week")
    week.or_(*names)
    both = client.get_bit_set("every-day")
    both.or_(names[0])
    both.and_(*names[1:])
    odd = client.get_bit_set("odd-days")
    odd.xor(*names)
    aggregates = {b.name: (b.cardinality(), b.length(), b.size())
                  for b in (week, both, odd)}
    days[0].not_()
    not_agg = (days[0].cardinality(), days[0].length(), days[0].size())
    torch.cuda.synchronize()
    launches = {"popcount_partials": ok.launches["popcount_partials"],
                "bitop_cells": ok.launches["bitop_cells"]}
    log(f"bitset path launches: {launches}")

    for d in range(DAYS):
        if not np.array_equal(olds[d], want_old[d]):
            raise AssertionError(f"SETBIT old values of day {d} differ from numpy")
        if counts[d] != int(ref[d].sum()):
            raise AssertionError(f"BITCOUNT of day {d} differs from numpy")
    ext = ((int(max(i.max() for i in ids[:1])) // 8) + 1) * 8
    wants = {"week": np.bitwise_or.reduce(ref), "every-day": np.bitwise_and.reduce(ref),
             "odd-days": np.bitwise_xor.reduce(ref)}
    for name, want in wants.items():
        got = export_cells(client, name)
        nz = np.flatnonzero(want)
        w_agg = (int(want.sum()), int(nz[-1]) + 1 if nz.size else 0,
                 ((int(max(i.max() for i in ids)) // 8) + 1) * 8)
        if not np.array_equal(got, want) or aggregates[name] != w_agg:
            raise AssertionError(f"BITOP result {name} differs from numpy: "
                                 f"{aggregates[name]} vs {w_agg}")
    notted = ref[0].copy()
    notted[:ext] ^= 1
    nz = np.flatnonzero(notted)
    if (not np.array_equal(export_cells(client, names[0]), notted)
            or not_agg != (int(notted.sum()), int(nz[-1]) + 1, ext)):
        raise AssertionError("NOT of day 0 differs from numpy")
    log(f"bitset: {DAYS} days x {DAY_SETS} SETBITs over 2^27 bits; BITCOUNT "
        f"{counts}; week OR/AND/XOR (count, length, size) {aggregates}; "
        f"NOT day 0 {not_agg}: all equal to numpy")
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"kernel {name} never launched on the bitset path")

    count_ms, bitop_ms = [], []
    for rep in range(TIMING_REPS + 1):
        days[1].set_bits([rep])  # a write, so the count is not served from cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        days[1].cardinality()
        t1 = time.perf_counter()
        week.or_(*names)  # acknowledged at dispatch: wait for the device too
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if rep:
            count_ms.append((t1 - t0) * 1e3)
            bitop_ms.append((t2 - t1) * 1e3)
    client.shutdown()
    report(card, [(f"client BITCOUNT over 2^27 bits", count_ms, "ms"),
                  (f"client BITOP OR over {DAYS} days of 2^27 bits", bitop_ms, "ms")])
    return launches


def report(card: str, rows, what_ingest: str = ""):
    for what, samples, unit in rows:
        med, lo_, hi = median_spread(samples)
        log(f"[{card}] {what}{what_ingest}, warm, {len(samples)} reps: "
            f"median {med:.4f} {unit} (min {lo_:.4f}, max {hi:.4f})")


def bloom_rates(seed: int, card: str, probes):
    """Warm Bloom rates under ingest="segment": each pass fills a fresh
    filter of the same geometry, then probes it."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    client = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    adds, contains, probe = [], [], []
    batches = [bloom_keys(lo, BLOOM_BATCH, seed) for lo in range(0, BLOOM_KEYS, BLOOM_BATCH)]
    first = batches[0][:BLOOM_CONTAINS]
    for rep in range(TIMING_REPS + 1):
        f = client.get_bloom_filter(f"rate:{rep}")
        f.try_init(BLOOM_N, BLOOM_P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            f.add_ints(b)
        t1 = time.perf_counter()
        f.contains_ints(first)
        t2 = time.perf_counter()
        probe_hits(f, probes)
        t3 = time.perf_counter()
        f.delete()
        if rep:
            adds.append(BLOOM_KEYS / (t1 - t0) / 1e6)
            contains.append(BLOOM_CONTAINS / (t2 - t1) / 1e6)
            probe.append(FPR_PROBES / (t3 - t2) / 1e6)
    client.shutdown()
    report(card, [
        (f"Bloom add_ints, {BLOOM_KEYS} keys in {BLOOM_BATCH}-key batches into a "
         f"fresh m={BLOOM_M} filter", adds, "M inserts/s"),
        (f"Bloom contains_ints, {BLOOM_CONTAINS} keys", contains, "M keys/s"),
        (f"Bloom FPR probe, {FPR_PROBES} device keys", probe, "M keys/s")],
        ", ingest=segment")


# -- phase 2: the delta kernels ----------------------------------------------


def ring_ms(fn, bufs) -> float:
    """Mean device ms of `fn(buf)` over distinct buffers, after a warm-up on
    the first: an in-place merge into the same buffer twice would find
    nothing left to change."""
    import torch

    fn(bufs[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in bufs[1:]:
        fn(b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(bufs) - 1)


def device_ms(fn, bufs):
    """Device time per call of `fn(buf)` over distinct buffers, from
    torch.profiler's kernel and memset events (host issue excluded), after a
    warm-up on the first -> (total ms per call, {event: ms per call}). Each
    event of a call runs once per call; its time is the mean over the
    occurrences the profiler recorded, which may be fewer than the calls
    (it can drop events), so a dropped event does not thin the mean."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(bufs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in bufs[1:]:
            fn(b)
        torch.cuda.synchronize()
    calls = len(bufs) - 1
    parts, seen = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us:
            parts[e.key[:60]] = us / 1e3 / e.count
            seen[e.key[:60]] = e.count
    if not parts:
        raise AssertionError("torch.profiler recorded no device time")
    if any(n != calls for n in seen.values()):
        log(f"torch.profiler recorded {json.dumps(seen)} events of {calls} calls")
    return sum(parts.values()), parts


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of `fn()`: the host clock around `reps`
    calls with no synchronisation, so the time to issue them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def timed_merge(kernel, plain, library, src, reps: int = 10):
    """ms of the kernel, its plain version and a library call, each merging
    into fresh copies of `src`."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        if fn is None:
            out[key] = None
            continue
        bufs = [src.clone() for _ in range(reps + 1)]
        out[key] = ring_ms(fn, bufs)
        del bufs
    return out


def mixed_planes(seed: int, n_hll: int, n_bloom: int, n_bits: int):
    """Random folded planes of one mixed window: HLL register images, Bloom
    planes of m = 958,505 (try_init(100_000, 0.01)) and 2^20-bit BitSets."""
    from redisson_tpu_torch.ingest import delta

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_hll):
        plane = np.zeros(delta.HLL_M, np.uint8)
        plane[rng.integers(0, delta.HLL_M, 9000)] = rng.integers(1, 30, 9000)
        out.append(delta.encode("hll_add", f"h{i}", plane, cells=delta.HLL_M,
                                packed=False, nkeys=0, raw_bytes=0))
    for kind, n, cells in (("bloom_add", n_bloom, MIX_BLOOM_M),
                           ("bitset_set", n_bits, MIX_BITS)):
        for i in range(n):
            plane = (rng.random((cells + 7) // 8) < 0.3).astype(np.uint8) * \
                rng.integers(0, 256, (cells + 7) // 8).astype(np.uint8)
            out.append(delta.encode(kind, f"{kind}{i}", plane, cells=cells,
                                    packed=True, nkeys=0, raw_bytes=0))
    return out


def tape_bound(table: np.ndarray, lanes: int, width: int) -> int:
    """Bytes the window merge must move for this tape: each row's cells
    below its length read and written once, and the wire bytes they need."""
    from redisson_tpu_torch.ops import window_kernel as wk

    valid = np.clip(table[:, 3].astype(np.int64), 0, lanes)
    wire = np.where(table[:, 0] == wk.OP_HLL, np.minimum(valid, width),
                    np.minimum((valid + 7) // 8, width))
    return int(2 * valid.sum() + wire.sum() + table.nbytes + table.shape[0] * 4)


def check_delta_kernels(seed: int, deferred: list):
    """delta_merge and window_merge against their plain versions at the
    delta paths' shapes, and their times (device-only times appended to
    `deferred`)."""
    import torch
    from redisson_tpu_torch.ingest import tape
    from redisson_tpu_torch.ops import kernels as ok
    from redisson_tpu_torch.ops import window_kernel as wk

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    dm_err, dm = 0, {}
    for t, l, high in ((256, 16384, 60), (1, 1 << 28, 2), (64, 1 << 20, 2), (3, 1024, 60),
                       (2, 16, 60)):
        old = torch.randint(0, high, (t, l), dtype=torch.uint8, device=dev, generator=g)
        delta = torch.randint(0, high, (t, l), dtype=torch.uint8, device=dev, generator=g)
        delta[torch.rand((t, l), device=dev, generator=g) < 0.6] = 0
        if t >= 2:
            delta[1] = 0  # a row that cannot rise
        if t >= 3:  # a row in which only the last cell rises
            old[2].fill_(1)
            delta[2] = 0
            old[2, -1], delta[2, -1] = 0, 1
        want_m, want_c = ok.delta_merge_plain(old.clone(), delta)
        got_m, got_c = ok.delta_merge(old.clone(), delta)
        if got_c.dtype != torch.bool:
            raise AssertionError(f"delta_merge returned {got_c.dtype} flags")
        dm_err = max(dm_err, _same(f"delta_merge [{t}, {l}]", got_m, want_m),
                     _same(f"delta_merge [{t}, {l}] changed", got_c, want_c))
        if (t, l) not in ((256, 16384), (1, 1 << 28)):
            continue
        reps = 10 if l > 16384 else 20
        times = timed_merge(lambda o, delta=delta: ok.delta_merge(o, delta),
                            lambda o, delta=delta: ok.delta_merge_plain(o, delta),
                            lambda o, delta=delta: torch.maximum(o, delta, out=o), old,
                            reps=reps)
        times["bound_ms"], times["bound_by"] = bound_ms(3 * t * l, t * l)
        scratch = old.clone()
        times["host_us"] = host_us(lambda: ok.delta_merge(scratch, delta))
        times["library_host_us"] = host_us(lambda: torch.maximum(scratch, delta, out=scratch))
        times["shape"] = f"[{t}, {l}]"
        del scratch
        log(f"delta_merge [{t}, {l}]: " + json.dumps(times))
        deferred.append((f"delta_merge [{t}, {l}]", times, "device_ms",
                         lambda o, delta=delta: ok.delta_merge(o, delta), old, reps))
        deferred.append((f"torch.maximum(out=old) [{t}, {l}]", times, "library_device_ms",
                         lambda o, delta=delta: torch.maximum(o, delta, out=o), old, reps))
        dm[(t, l)] = times
    dmerge = dm[(1, 1 << 28)]
    dmerge.update(max_abs_err=dm_err, hll_window=dm[(256, 16384)])
    log("delta_merge library call torch.maximum(out=old) has no changed flag")

    wm_err, wm = 0, {}
    for name, planes in (("mixed", mixed_planes(seed, 32, 15, 14)),
                         ("hll", mixed_planes(seed + 1, 250, 0, 0))):
        tp = tape.encode_window(planes, lambda n: 0)
        table = tp.table.copy()
        table[:, 2] = np.random.default_rng(seed).integers(-2**31, 2**31 - 1,
                                                           table.shape[0])
        t2 = table.shape[0]
        old = torch.randint(0, 2, (t2, tp.lanes), dtype=torch.uint8, device=dev,
                            generator=g)
        hll_rows = table[:, 0] == wk.OP_HLL
        old[torch.from_numpy(hll_rows).to(dev)] *= 20  # registers 0 / 20
        wire = torch.from_numpy(tp.wire).to(dev)
        tab = torch.from_numpy(table).to(dev)
        shape = f"[{t2}, {tp.lanes}]"
        wm_err = max(wm_err, check_window_merge(f"{name} {shape}", old, wire, tab))
        reps = 10 if name == "mixed" else 20
        # The dense HLL tape has a library yardstick, as delta_merge's
        # [256, 16384] does: torch.maximum(old, wire, out=old), no flag.
        library = (None if wire.shape != old.shape else
                   lambda o, wire=wire: torch.maximum(o, wire, out=o))
        times = timed_merge(lambda o, wire=wire, tab=tab: wk.window_merge(o, wire, tab),
                            lambda o, wire=wire, tab=tab: wk.window_merge_plain(o, wire, tab),
                            library, old, reps=reps)
        nbytes = tape_bound(table, tp.lanes, tp.wire.shape[1])
        times["bound_ms"], times["bound_by"] = bound_ms(nbytes, nbytes // 2)
        scratch = old.clone()
        times["host_us"] = host_us(lambda: wk.window_merge(scratch, wire, tab))
        times["shape"] = shape
        del scratch
        log(f"window_merge {name} tape {shape} (wire {tp.wire.shape[1]} B/row, "
            f"{int((table[:, 0] == wk.OP_PAD).sum())} PAD rows, {nbytes} bytes "
            f"to move): " + json.dumps(times))
        deferred.append((f"window_merge {name} tape {shape}", times, "device_ms",
                         lambda o, wire=wire, tab=tab: wk.window_merge(o, wire, tab),
                         old, reps))
        if library is not None:
            scratch = old.clone()
            times["library_host_us"] = host_us(lambda: library(scratch))
            del scratch
            deferred.append((f"torch.maximum(out=old) {name} tape {shape}", times,
                             "library_device_ms", library, old, reps))
        wm[name] = times
    # A [2, 16] tape: a packed row whose length ends inside its only vector
    # and a dense row of length 0.
    tab = torch.tensor([[wk.OP_BLOOM, 0, 0, 13, 0], [wk.OP_HLL, 1, 0, 0, 0]],
                       dtype=torch.int32, device=dev)
    wire = torch.randint(0, 256, (2, 16), dtype=torch.uint8, device=dev, generator=g)
    old = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    wm_err = max(wm_err, check_window_merge("[2, 16]", old, wire, tab))
    wm["mixed"].update(hll_window=wm["hll"], max_abs_err=wm_err)
    return dmerge, wm["mixed"]


def check_window_merge(what: str, old, wire, tab) -> int:
    """window_merge against its plain version on copies of `old`: cells and
    the bool flags it returns."""
    import torch
    from redisson_tpu_torch.ops import window_kernel as wk

    want_m, want_c = wk.window_merge_plain(old.clone(), wire, tab)
    got_m, got_c = wk.window_merge(old.clone(), wire, tab)
    if got_c.dtype != torch.bool:
        raise AssertionError(f"window_merge returned {got_c.dtype} flags")
    return max(_same(f"window_merge {what}", got_m, want_m),
               _same(f"window_merge {what} changed", got_c, want_c))


# -- phases 10-12: the delta / tape / hostfold ingest -------------------------


def reset_all_launches():
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok
    from redisson_tpu_torch.ops import window_kernel as wk

    ik.reset_launches()
    ok.reset_launches()
    wk.reset_launches()


def delta_launches() -> dict:
    import torch
    from redisson_tpu_torch.ops import kernels as ok
    from redisson_tpu_torch.ops import window_kernel as wk

    torch.cuda.synchronize()
    return {"delta_merge": ok.launches["delta_merge"],
            "window_merge": wk.launches["window_merge"]}


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def delta_hll_path(seed: int, ref):
    """The HLL path of phase 3 under each host-side ingest: banks, PFADD
    flags and estimates equal to ingest="sort"."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    ref_res, ref_bank, ref_rows = ref
    total = {}
    for ingest, kernel in (("delta", "delta_merge"), ("tape", "window_merge"),
                           ("hostfold", None)):
        reset_all_launches()
        client = RedissonTorch.create(Config().use_cuda(ingest=ingest))
        res = drive(client, seed)
        launches = delta_launches()
        bank, rows = client.to_numpy_state()
        stats = client.sketch.ingest_stats()
        client.shutdown()
        log(f"hll path under ingest={ingest}: launches {launches}; counters "
            + json.dumps({k: round(v, 3) for k, v in stats.items()}))
        same_bank(bank, rows, ref_bank, ref_rows, f"ingest={ingest}")
        for key in ("added", "big_added", "counts", "big_count", "merge_count",
                    "merge_and_count", "count_with"):
            if res[key] != ref_res[key]:
                raise AssertionError(f"ingest={ingest}: {key} differs from ingest=sort")
        if kernel and not launches[kernel]:
            raise AssertionError(f"kernel {kernel} never launched under ingest={ingest}")
        total = add_launches(total, launches)
    log("hll path under delta / tape / hostfold: PFADD flags and estimates equal "
        "to ingest=sort")
    return total


def newly_vs_added(what: str, newly: np.ndarray, added: np.ndarray) -> int:
    """A key newly set by the in-order host fold was also `added` by the
    device path (whose flag is taken against the batch start): check the
    implication and count the keys where only the device path says added
    (all of their bits set by earlier keys of the same batch)."""
    if newly.shape != added.shape or (newly & ~added).any():
        raise AssertionError(f"{what}: a newly flag without the device's added flag")
    only = int((added & ~newly).sum())
    log(f"{what}: newly flags imply the device path's added flags; {only} of "
        f"{added.size} keys added on the device but not newly in the host fold "
        "(their bits were set earlier in the same batch)")
    return only


def delta_bloom_path(seed: int, ref):
    """The Bloom path's adds under ingest="delta", then under "hostfold"
    from the host mirror, against the cells of ingest="scatter"."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    ref_cells, ref_added = ref
    reset_all_launches()
    client = RedissonTorch.create(Config().use_cuda(ingest="delta"))
    f, newly = bloom_fill(client, "bloom", seed)
    launches = delta_launches()
    cells = export_cells(client, "bloom")
    client.shutdown()
    log(f"bloom path under ingest=delta: launches {launches}")
    if not np.array_equal(cells, ref_cells):
        raise AssertionError("ingest=delta bloom cells differ from scatter")
    newly_vs_added("bloom ingest=delta", newly, ref_added)
    if not launches["delta_merge"]:
        raise AssertionError("delta_merge never launched on the bloom delta path")

    client = RedissonTorch.create(Config().use_cuda(ingest="hostfold"))
    f, newly = bloom_fill(client, "bloom", seed)
    mirror = client.sketch._bloom_mirrors.get("bloom")
    first = f.contains_ints(bloom_keys(0, BLOOM_CONTAINS, seed))
    count = f.count()
    version = client._store.get("bloom").version
    client._executor.execute_sync("bloom", "bloom_sync", None)
    cells = export_cells(client, "bloom")
    client.shutdown()
    if mirror is None or version != 0:
        raise AssertionError("ingest=hostfold did not serve the adds from the mirror")
    if not first.all():
        raise AssertionError("false negatives from the host mirror")
    if not np.array_equal(cells, ref_cells):
        raise AssertionError("ingest=hostfold bloom cells after bloom_sync differ")
    newly_vs_added("bloom ingest=hostfold", newly, ref_added)
    log(f"bloom under ingest=hostfold: 10M adds and contains of {BLOOM_CONTAINS} "
        f"keys from the host mirror (no false negative), count() {count}; after "
        "bloom_sync the cells equal ingest=scatter's")
    return launches


def delta_bitset_path(seed: int):
    """The BitSet days under ingest="delta", each day's SETBITs in four
    2M-index ops: old bits and cells equal to numpy's (a window's old bits
    are its start state)."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    ids = day_ids(seed)
    reset_all_launches()
    client = RedissonTorch.create(Config().use_cuda(ingest="delta"))
    ref = np.zeros(DAY_BITS, np.uint8)
    for d in range(DAYS):
        ref[:] = 0
        day = client.get_bit_set(f"dday:{d}")
        for lo in range(0, DAY_SETS, DAY_SETS // 4):
            chunk = ids[d][lo: lo + DAY_SETS // 4]
            old = day.set_bits(chunk)
            if not np.array_equal(old, ref[chunk] != 0):
                raise AssertionError(f"ingest=delta SETBIT old bits of day {d} differ")
            ref[chunk] = 1
        if not np.array_equal(export_cells(client, f"dday:{d}"), ref):
            raise AssertionError(f"ingest=delta cells of day {d} differ from numpy")
    launches = delta_launches()
    client.shutdown()
    log(f"bitset under ingest=delta: {DAYS} days x 4 x {DAY_SETS // 4} SETBITs, old "
        f"bits and cells equal to numpy; launches {launches}")
    if not launches["delta_merge"]:
        raise AssertionError("delta_merge never launched on the bitset delta path")
    return launches


def hold_dispatcher(client):
    """Block the client's dispatcher on a barrier until the returned event
    is set, so that ops submitted meanwhile queue up and coalesce into one
    run (what a client batch of many keys' writes looks like)."""
    import threading

    release, entered = threading.Event(), threading.Event()

    def block():
        entered.set()
        release.wait(60)

    fut = client._executor.execute_barrier(block)
    if not entered.wait(60):
        raise AssertionError("the dispatcher never reached the barrier")
    return release, fut


def mixed_ops(client, seed: int, n_hll: int):
    """One held window: n_hll PFADDs of 40,000 keys, 16 Bloom adds of
    50,000 keys and 16 SETBIT batches of 100,000 indexes, on distinct
    targets -> (the ops' results, the targets' state)."""
    rng = np.random.default_rng(seed)
    blooms = [client.get_bloom_filter(f"mix:f{i}") for i in range(MIX_N)]
    for f in blooms:
        f.try_init(100_000, 0.01)
    release, fut = hold_dispatcher(client)
    futs = [client.get_hyper_log_log(f"mix:h{i}").add_ints_async(
        rng.integers(0, 2**64, KEYS, dtype=np.uint64)) for i in range(n_hll)]
    futs += [f.add_ints_async(rng.integers(0, 2**63, 50_000, dtype=np.uint64))
             for f in blooms]
    for i in range(MIX_N):
        idx = rng.integers(0, MIX_BITS, 100_000)
        idx[0] = MIX_BITS - 1  # every BitSet grows to 2^20 bits
        futs.append(client.get_bit_set(f"mix:b{i}").set_bits_async(idx))
    release.set()
    fut.result(60)
    results = [f.result(120) for f in futs]
    state = {}
    for name in [f"mix:f{i}" for i in range(MIX_N)] + [f"mix:b{i}" for i in range(MIX_N)]:
        client._executor.execute_sync(name, "bloom_sync", None)
        state[name] = export_cells(client, name)
    for i in range(n_hll):
        name = f"mix:h{i}"
        state[name] = client._executor.execute_sync(name, "hll_export", None)[0]
    client.flushall()
    return results, state


def mixed_window(seed: int):
    """Phase 11: a mixed window in one window_merge launch, then one past
    the cell budget through chunked delta_merge."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    runs = {}
    launches = {}
    for ingest in ("tape", "delta", "scatter"):
        client = RedissonTorch.create(Config().use_cuda(ingest=ingest))
        for window, n_hll in (("fits", 2 * MIX_N), ("over", 2 * MIX_N + 1)):
            if ingest == "tape":
                reset_all_launches()
            runs[(ingest, window)] = mixed_ops(client, seed + n_hll, n_hll)
            if ingest == "tape":
                launches[window] = delta_launches()
                log(f"mixed window ({window}, {n_hll + 2 * MIX_N} targets) under "
                    f"ingest=tape: launches {launches[window]}; counters "
                    + json.dumps(client.sketch.ingest_stats()))
        client.shutdown()
    if launches["fits"] != {"delta_merge": 0, "window_merge": 1}:
        raise AssertionError(f"the mixed window took {launches['fits']}, not one "
                             "window_merge launch")
    if launches["over"]["window_merge"] or launches["over"]["delta_merge"] < 2:
        raise AssertionError(f"the over-budget window took {launches['over']}")
    for window in ("fits", "over"):
        (tres, tstate), (dres, dstate), (sres, sstate) = (
            runs[(i, window)] for i in ("tape", "delta", "scatter"))
        n_hll = len(tres) - 2 * MIX_N
        for name in tstate:
            if not (np.array_equal(tstate[name], dstate[name])
                    and np.array_equal(tstate[name], sstate[name])):
                raise AssertionError(f"{window} window: state of {name} differs")
        for i, (t, d, sc) in enumerate(zip(tres, dres, sres)):
            if not np.array_equal(t, d):
                raise AssertionError(f"{window} window: result {i} differs from delta")
            if not (n_hll <= i < n_hll + MIX_N) and not np.array_equal(t, sc):
                raise AssertionError(f"{window} window: result {i} differs from scatter")
        newly_vs_added(f"mixed {window} window Bloom adds",
                       np.concatenate(tres[n_hll: n_hll + MIX_N]),
                       np.concatenate(sres[n_hll: n_hll + MIX_N]))
    log("mixed windows: results and state under tape equal delta's; state, PFADD "
        "flags and SETBIT old bits equal scatter's")
    return add_launches(launches["fits"], launches["over"])


def delta_rates(seed: int, card: str):
    """Warm rates of the host-side ingest paths, the link profile and what
    ingest="auto" picks for 2^21 keys."""
    import torch
    from redisson_tpu_torch.backend_torch import hostfold_policy, link_profile
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    rows = []
    for ingest in ("delta", "tape", "hostfold"):
        client = RedissonTorch.create(Config().use_cuda(ingest=ingest))
        hlls = [client.get_hyper_log_log(f"r:{i}") for i in range(SKETCHES)]
        big = client.get_hyper_log_log("r:big")
        many, one = [], []
        for rep in range(TIMING_REPS + 1):
            lo = rep * (1 << 36)
            batches = [keys_for(lo + i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
            big_keys = keys_for(lo + (1 << 35), BIG_KEYS, seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            [f.result() for f in [h.add_ints_async(b) for h, b in zip(hlls, batches)]]
            t1 = time.perf_counter()
            big.add_ints(big_keys)
            t2 = time.perf_counter()
            if rep:
                many.append(SKETCHES * KEYS / (t1 - t0) / 1e6)
                one.append(BIG_KEYS / (t2 - t1) / 1e6)
        log(f"ingest={ingest} counters after the rate passes: "
            + json.dumps(client.sketch.ingest_stats()))
        client.shutdown()
        rows += [(f"PFADD, {SKETCHES} sketches x {KEYS} keys, ingest={ingest}", many,
                  "M inserts/s"),
                 (f"PFADD, one {BIG_KEYS}-key batch, ingest={ingest}", one,
                  "M inserts/s")]
    client = RedissonTorch.create(Config().use_cuda(ingest="delta"))
    batches = [bloom_keys(lo, BLOOM_BATCH, seed) for lo in range(0, BLOOM_KEYS, BLOOM_BATCH)]
    adds = []
    for rep in range(TIMING_REPS + 1):
        f = client.get_bloom_filter(f"rate:{rep}")
        f.try_init(BLOOM_N, BLOOM_P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            f.add_ints(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f.delete()
        if rep:
            adds.append(BLOOM_KEYS / (t1 - t0) / 1e6)
    client.shutdown()
    rows.append((f"Bloom add_ints, {BLOOM_KEYS} keys in {BLOOM_BATCH}-key batches, "
                 "ingest=delta", adds, "M inserts/s"))
    report(card, rows)

    dev = torch.device("cuda", 0)
    prof = link_profile(dev)
    log(f"[{card}] link profile: {prof.transfer_ns_per_byte:.5f} ns/byte host->device "
        f"({8 * prof.transfer_ns_per_byte:.4f} ns per 8-byte key), host fold "
        f"{prof.fold_ns_per_key:.4f} ns/key, prefer_hostfold={prof.prefer_hostfold}")
    client = RedissonTorch.create(Config().use_cuda(ingest="auto"))
    back = client.sketch
    n = 1 << 21
    picks = client._executor.execute_barrier(lambda: {
        "hll": back._plan_ingest(n),
        "hll from the delta dispatch": back._plan_ingest(n, allow_delta=True),
        "bloom bits from the delta dispatch": back._plan_bits(
            n, BLOOM_M, plane_bytes=(BLOOM_M + 7) // 8, allow_delta=True),
        "bloom host mirror": hostfold_policy("auto", n, dev)}).result()
    log(f"ingest=auto at {n} keys picks: " + json.dumps(picks))
    client.shutdown()


def traced(what: str, window) -> None:
    """torch.profiler over one window: wall time, device busy share and the
    device time by kernel name (where the time goes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if dev_us(e) > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile: {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d} calls  {key[:90]}")


def merge_window(client) -> dict:
    """torch.profiler over 10 client PFMERGEs of config 3's 256 sketches
    into one target (257 listed rows each): one merge_stack kernel per
    merge, no memset and no host-to-device copy (the row list reaches the
    kernel by value)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from redisson_tpu_torch.ops import kernels as ok

    names = [f"b3:s{i}" for i in range(B3_SKETCHES)]
    dest = client.get_hyper_log_log("b3:profiled")
    dest.merge_with(*names)  # creates the target row
    torch.cuda.synchronize()
    before = ok.launches["merge_stack"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            dest.merge_with(*names)
        torch.cuda.synchronize()
    events = {e.key[:90]: e.count for e in prof.key_averages()}
    seen = {"merge_kernel": sum(n for k, n in events.items() if "merge_kernel" in k),
            "memset": sum(n for k, n in events.items() if "memset" in k.lower()),
            "host_to_device": sum(n for k, n in events.items() if "HtoD" in k),
            "launches": ok.launches["merge_stack"] - before}
    log(f"profile: 10 client PFMERGEs over {B3_SKETCHES} sketches: " + json.dumps(seen)
        + "; device events " + json.dumps(events))
    if seen != {"merge_kernel": 10, "memset": 0, "host_to_device": 0, "launches": 10}:
        raise AssertionError(f"10 client PFMERGEs: {seen}")
    return seen


def profile_path(seed: int):
    """Short traced windows of the HLL and Bloom paths."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    client = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    names = [f"p:{i}" for i in range(64)]
    batches = [keys_for(i * KEYS, KEYS, seed) for i in range(64)]
    client.get_hyper_log_log("warm").add_ints(batches[0])  # allocator warm-up

    def hll_window():
        futs = [client.get_hyper_log_log(n).add_ints_async(b)
                for n, b in zip(names, batches)]
        [f.result() for f in futs]
        [client.get_hyper_log_log(n).count() for n in names]
        client.get_hyper_log_log("u").merge_with_and_count(*names)

    traced(f"64 PFADDs x {KEYS} keys + 64 PFCOUNTs + 1 PFMERGE+count over 64",
           hll_window)

    bloom = client.get_bloom_filter("p:bloom")
    bloom.try_init(BLOOM_N, BLOOM_P)
    adds = [bloom_keys(lo, BLOOM_BATCH, seed) for lo in range(0, 3 * BLOOM_BATCH,
                                                              BLOOM_BATCH)]
    bloom.add_ints(adds[0])  # warm-up
    g = torch.Generator(device=client.device).manual_seed(seed)
    probe = torch.randint(0, 1 << 62, (1 << 24,), dtype=torch.int64,
                          device=client.device, generator=g)

    def bloom_window():
        for b in adds[1:]:
            bloom.add_ints(b)
        bloom.contains_ints(adds[1][:BLOOM_CONTAINS])
        bloom.contains_count_device_async(probe).result()

    traced(f"2 Bloom add_ints x {BLOOM_BATCH} keys (segment) + contains_ints "
           f"{BLOOM_CONTAINS} + contains_count of 2^24 device keys", bloom_window)
    client.shutdown()


# -- phases 13-14: BASELINE config 3 through RBatch, and the structures tier --


def b3_keys():
    """BASELINE config 3's keys as benchmarks/suite.py draws them: 40,000
    uint64 per sketch from seed 3 (staged as their 8-byte encodings)."""
    rng = np.random.default_rng(B3_SEED)
    return [rng.integers(0, 2**63, B3_KEYS, np.uint64) for _ in range(B3_SKETCHES)]


def batched_add(client, names, keys):
    """Stage one add_all_async per sketch into one RBatch and execute it ->
    (flags, seconds, executor runs). Drops each staged key list."""
    runs0 = client._executor.runs_dispatched()
    t0 = time.perf_counter()
    batch = client.create_batch()
    for i, n in enumerate(names):
        batch.get_hyper_log_log(n).add_all_async(keys[i])
        keys[i] = None  # staged: the encoded batch holds the keys now
    flags = batch.execute()
    return flags, time.perf_counter() - t0, client._executor.runs_dispatched() - runs0


def as_bytes(ints):
    return [[k.tobytes() for k in arr] for arr in ints]


def batch_path(card: str):
    """BASELINE config 3 on the card client (`RedissonTorch.create()`, the
    default cuda:0 and ingest="auto"): the batched PFADD of 256 x 40,000
    keys, then PFMERGE + PFCOUNT over the 256. The bank must equal the same
    keys added unbatched under ingest="sort" (no hand kernel), the merged
    row the host's max over those rows, the union be within 2% of
    10,240,000, and seg_insert and merge_stack must launch. Then the
    multi-target insert against the flat scatter, end to end."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok

    ints = b3_keys()
    t0 = time.perf_counter()
    keys = as_bytes(ints)
    log(f"config 3 keys: {B3_SKETCHES} x {B3_KEYS} 8-byte keys made in "
        f"{time.perf_counter() - t0:.2f} s (outside the timed region)")
    names = [f"b3:s{i}" for i in range(B3_SKETCHES)]
    c = RedissonTorch.create()
    c.get_hyper_log_log("b3:warmadd").add_all(keys[0])  # warm the add path
    torch.cuda.synchronize()

    reset_all_launches()
    flags, add_s, runs = batched_add(c, names, list(keys))
    # Warm the merge and count at this stack's shape, as the suite does.
    warm = c.get_hyper_log_log("b3:warm")
    warm.merge_with_and_count(*names)
    warm.merge_with(*names)
    warm.count()
    dest = c.get_hyper_log_log("b3:merged")
    t0 = time.perf_counter()
    union = dest.merge_with_and_count(*names)
    sync_ms = (time.perf_counter() - t0) * 1e3
    futs = []
    t0 = time.perf_counter()
    for _ in range(B3_CYCLES):
        futs.append(dest.merge_with_async(*names))
        futs.append(dest.count_async())
    for f in futs:
        f.result()
    pipe_ms = (time.perf_counter() - t0) * 1e3 / B3_CYCLES
    torch.cuda.synchronize()
    launches = {"seg_insert": ik.launches["seg_insert"],
                "merge_stack": ok.launches["merge_stack"]}
    log(f"config 3 path launches: {launches}; the batch took {runs} executor "
        f"run(s); ingest plan {c.sketch.planner.table() if c.sketch.planner else None}")
    if flags != [True] * B3_SKETCHES:
        raise AssertionError("a batched PFADD into an empty sketch reported no change")
    exact = B3_SKETCHES * B3_KEYS
    err = abs(union - exact) / exact
    log(f"config 3 union estimate {union} of {exact} ({err:.5f}); pipelined "
        f"counts {[f.result() for f in futs[1::2]][:2]}...")
    if err >= 0.02:
        raise AssertionError(f"config 3 union error {err:.4f} at or above 2%")
    if not launches["seg_insert"] or not launches["merge_stack"]:
        raise AssertionError(f"a kernel of the config 3 path never launched: {launches}")
    bank, rows = c.to_numpy_state()

    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    for n, arr in zip(names, ints):
        ref.get_hyper_log_log(n).add_ints(arr)
    ref_bank, ref_rows = ref.to_numpy_state()
    ref.shutdown()
    for n in names:
        if not np.array_equal(bank[rows[n]], ref_bank[ref_rows[n]]):
            raise AssertionError(f"config 3 row {n} differs from unbatched ingest=sort")
    # The union on the host, from the reference's rows: no kernel of the port.
    union_row = ref_bank[[ref_rows[n] for n in names]].max(axis=0)
    if not np.array_equal(bank[rows["b3:merged"]], union_row):
        raise AssertionError("config 3 merged row differs from the host's max of the rows")
    log(f"config 3 bank: all {B3_SKETCHES} sketches bit-identical to the same keys "
        "added unbatched under ingest=sort, the merged row to their max on the host")
    stats = {"batched_insert_keys_per_sec": exact / add_s, "merge_count_ms": sync_ms,
             "merge_count_pipelined_ms": pipe_ms, "batch_runs": runs,
             "union_estimate": union}
    log(f"config 3 on {card}: " + json.dumps(stats))
    multi_target_vs_scatter(card, keys, bank, rows)
    return launches, c


def multi_target_vs_scatter(card: str, keys, bank, rows) -> None:
    """The multi-target insert under ingest="segment" (one seg_insert
    launch per chunk of a run) against the flat scatter ("scatter"), end
    to end through RBatch. Config 3's batch under "scatter" on a client of
    its own (the card client's run above is the "segment" one), its rows
    equal to the card client's. Then two fresh clients, one of each, make
    the same 4096 sketches with one untimed batch of 4096 x 8-key PFADDs
    and take 8 timed batches of fresh keys into them, alternating scatter,
    segment, segment, scatter: each pair gives both the same keys, so
    their replies and final rows must be equal."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    names = [f"b3:s{j}" for j in range(B3_SKETCHES)]
    sc = RedissonTorch.create(Config().use_cuda(ingest="scatter"))
    try:
        sc.get_hyper_log_log("warm").add_all(keys[0][:1000])  # warm the add path
        flags, add_s, runs = batched_add(sc, names, keys)
        got, got_rows = sc.to_numpy_state()
    finally:
        sc.shutdown()
    if flags != [True] * B3_SKETCHES:
        raise AssertionError("a config 3 PFADD under scatter reported no change")
    for n in names:
        if not np.array_equal(got[got_rows[n]], bank[rows[n]]):
            raise AssertionError(f"config 3 row {n} under scatter differs")
    rates = {"config3_scatter_keys_per_sec": B3_SKETCHES * B3_KEYS / add_s,
             "config3_scatter_runs": runs, "window_4096x8_ms": {}, "window_runs": {},
             "window_changed": {}}

    rng = np.random.default_rng(B3_SEED + 1)
    order = ("scatter", "segment", "segment", "scatter") * 2
    sets = [[rng.integers(0, 2**63, 8, np.uint64) for _ in range(4096)]
            for _ in range(1 + len(order) // 2)]
    snames = [f"w:{j}" for j in range(4096)]
    clients = {ingest: RedissonTorch.create(Config().use_cuda(ingest=ingest))
               for ingest in ("scatter", "segment")}
    try:
        for cl in clients.values():  # untimed: the 4096 rows exist after it
            if batched_add(cl, snames, as_bytes(sets[0]))[0] != [True] * len(snames):
                raise AssertionError("a PFADD into an empty sketch reported no change")
        replies = {}
        for i, ingest in enumerate(order):
            sflags, small_s, sruns = batched_add(clients[ingest], snames,
                                                 as_bytes(sets[1 + i // 2]))
            if replies.setdefault(i // 2, sflags) != sflags:
                raise AssertionError(f"4096-sketch batch {i // 2}: replies differ "
                                     "between ingests")
            rates["window_4096x8_ms"].setdefault(ingest, []).append(small_s * 1e3)
            rates["window_runs"].setdefault(ingest, []).append(sruns)
            rates["window_changed"].setdefault(ingest, []).append(sum(sflags))
        states = {ingest: cl.to_numpy_state() for ingest, cl in clients.items()}
    finally:
        for cl in clients.values():
            cl.shutdown()
    (a, a_rows), (b, b_rows) = states["scatter"], states["segment"]
    for n in snames:
        if not np.array_equal(a[a_rows[n]], b[b_rows[n]]):
            raise AssertionError(f"4096-sketch batch row {n} differs between ingests")
    log(f"multi-target insert vs flat scatter on {card}: " + json.dumps(rates))


def timed(what: str, n: int, fn, unit: str = "ops"):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    log(f"  {what}: {n} {unit} in {dt:.3f} s, {n / dt:.4g} {unit}/s")
    return out, n / dt


def expect(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: got {str(got)[:200]}, want {str(want)[:200]}")


def structures_path(c, card: str):
    """The structures tier on the card client, each answer held against a
    plain-Python model. Host-tier rates: the structure engine runs on the
    host, as in the JAX package."""
    import threading

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.eviction import BATCH_LIMIT

    rng = np.random.default_rng(6)
    rates = {}
    log(f"structures tier on the card client ({card}); host-tier rates:")

    m = c.get_map("st:map")
    model = {}

    def put_map():
        for lo in range(0, ST_MAP, ST_MAP_CHUNK):
            chunk = {f"k{i}": i * 7 for i in range(lo, lo + ST_MAP_CHUNK)}
            m.put_all(chunk)
            model.update(chunk)

    _, rates["map_put_all_entries_per_s"] = timed("RMap put_all", ST_MAP, put_map, "entries")
    probe = [f"k{i}" for i in rng.integers(0, ST_MAP + ST_MAP // 10, ST_MAP_GET)]
    got, rates["map_get_all_keys_per_s"] = timed("RMap get_all", ST_MAP_GET,
                                                 lambda: m.get_all(probe), "keys")
    expect("RMap get_all", got, {k: model[k] for k in probe if k in model})
    expect("RMap size", m.size(), len(model))

    z = c.get_scored_sorted_set("st:board")
    scores = rng.integers(0, 10**6, ST_ZSET).astype(float)
    members = [f"p{i}" for i in range(ST_ZSET)]

    def fill_board():
        for lo in range(0, ST_ZSET, ST_MAP_CHUNK):
            z.add_all([(scores[i], members[i]) for i in range(lo, lo + ST_MAP_CHUNK)])

    _, rates["zset_add_members_per_s"] = timed("RScoredSortedSet add_all", ST_ZSET,
                                               fill_board, "members")
    order = sorted(range(ST_ZSET), key=lambda i: (scores[i], c._codec.encode(members[i])))
    rank_of = {i: r for r, i in enumerate(order)}
    picks = [int(i) for i in rng.integers(0, ST_ZSET, ST_ZSET_PROBES)]
    got, rates["zset_rank_per_s"] = timed(
        "RScoredSortedSet rank", len(picks), lambda: [z.rank(members[i]) for i in picks])
    expect("rank", got, [rank_of[i] for i in picks])
    expect("value_range top 100", z.value_range(0, 99), [members[i] for i in order[:100]])
    expect("value_range bottom 100", z.value_range(-100, -1),
           [members[i] for i in order[-100:]])
    lo, hi = 500_000.0, 500_300.0
    expect("value_range_by_score", z.value_range_by_score(lo, True, hi, True),
           [members[i] for i in order if lo <= scores[i] <= hi])

    q = c.get_blocking_queue("st:queue")
    got = [[] for _ in range(ST_QUEUE_THREADS)]

    def consume(k):
        while True:
            v = q.take()
            if v == "stop":
                return
            got[k].append(tuple(v))

    def produce(p):
        for i in range(ST_QUEUE_ITEMS):
            q.offer([p, i])

    def run_queue():
        cons = [threading.Thread(target=consume, args=(k,)) for k in range(ST_QUEUE_THREADS)]
        prods = [threading.Thread(target=produce, args=(p,)) for p in range(ST_QUEUE_THREADS)]
        for t in cons + prods:
            t.start()
        for t in prods:
            t.join()
        for _ in cons:
            q.offer("stop")
        for t in cons:
            t.join(60)
            if t.is_alive():
                raise AssertionError("a blocking-queue consumer never finished")

    n_items = ST_QUEUE_THREADS * ST_QUEUE_ITEMS
    _, rates["queue_items_per_s"] = timed(
        f"RBlockingQueue {ST_QUEUE_THREADS} producers / {ST_QUEUE_THREADS} consumers",
        n_items, run_queue, "items")
    delivered = [v for part in got for v in part]
    expect("queue items delivered", sorted(delivered),
           [(p, i) for p in range(ST_QUEUE_THREADS) for i in range(ST_QUEUE_ITEMS)])
    parked = c._executor.execute_barrier(
        lambda: sum(len(w) for w in c._routing.structures._waiters.values())).result()
    expect("consumers left parked", parked, 0)
    expect("queue left over", q.size(), 0)

    lk, counter = c.get_lock("st:lock"), c.get_atomic_long("st:counter")

    def locked_increments():
        for _ in range(ST_LOCK_ITERS):
            lk.lock()
            try:
                counter.increment_and_get()
            finally:
                lk.unlock()

    def run_locks():
        ts = [threading.Thread(target=locked_increments) for _ in range(ST_LOCK_THREADS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    n_locks = ST_LOCK_THREADS * ST_LOCK_ITERS
    _, rates["lock_increments_per_s"] = timed(
        f"RLock {ST_LOCK_THREADS} threads lock/increment/unlock", n_locks, run_locks,
        "increments")
    expect("RAtomicLong under RLock", counter.get(), n_locks)
    expect("lock released", lk.is_locked(), False)

    mc = c.get_map_cache("st:cache")

    def fill_cache():
        futs = [mc.put_async(f"c{i}", i, ST_CACHE_TTL_S) for i in range(ST_CACHE)]
        for f in futs:
            f.result()

    _, rates["mapcache_put_per_s"] = timed("RMapCache put (TTL 1 s)", ST_CACHE, fill_cache)
    time.sleep(ST_CACHE_TTL_S + 0.05)  # every entry's TTL has passed
    structures = c._routing.structures

    def sweep():
        removed = sweeps = 0
        while True:
            n = c._executor.execute_sync("st:cache", "mc_evict_expired",
                                         {"limit": BATCH_LIMIT})
            removed, sweeps = removed + n, sweeps + 1
            if n == 0:
                return removed, sweeps

    (removed, sweeps), _ = timed("mc_evict_expired sweeps", ST_CACHE, sweep, "entries")
    left = c._executor.execute_barrier(
        lambda: len(structures._data["st:cache"].value)
        if "st:cache" in structures._data else 0).result()
    log(f"  eviction: {sweeps} sweeps of up to {BATCH_LIMIT}, {removed} removed by "
        f"them (the client's EvictionScheduler swept the rest), {left} entries left")
    expect("map cache entries left after the sweep", left, 0)
    expect("map cache size", mc.size(), 0)

    topic = c.get_topic("st:topic")
    heard = [[], []]
    done = threading.Event()

    def listener(k):
        def fn(channel, msg):
            heard[k].append(msg)
            if len(heard[0]) == len(heard[1]) == ST_TOPIC:
                done.set()
        return fn

    for k in range(2):
        topic.add_listener(listener(k))
    receivers, rates["topic_publish_per_s"] = timed(
        "RTopic publish to 2 listeners", ST_TOPIC,
        lambda: [topic.publish(i) for i in range(ST_TOPIC)], "messages")
    if not done.wait(60):
        raise AssertionError(f"topic delivered {len(heard[0])}, {len(heard[1])} "
                             f"of {ST_TOPIC}")
    expect("topic receivers", set(receivers), {2})
    expect("topic messages in order", heard, [list(range(ST_TOPIC))] * 2)
    topic.remove_all_listeners()

    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    try:
        results = []
        for client, staged in ((c, True), (ref, False)):
            client.get_bloom_filter("st:bf").try_init(100_000, 0.01)
            b = client.create_batch() if staged else client
            futs = [b.get_map("st:bmap").put_async(f"k{i}", i) for i in range(ST_BATCH_PUTS)]
            futs += [b.get_hyper_log_log(f"st:h{j}").add_all_async(
                [f"u{j}:{i}" for i in range(1000 * (j + 1))]) for j in range(ST_BATCH_HLLS)]
            futs.append(b.get_bloom_filter("st:bf").add_all_async(["x", "y", "x"]))
            if staged:
                t0 = time.perf_counter()
                res = b.execute()
                rates["mixed_batch_ops_per_s"] = len(res) / (time.perf_counter() - t0)
            else:
                res = [f.result() for f in futs]
            results.append([r.tolist() if isinstance(r, np.ndarray) else r for r in res])
        expect("mixed RBatch against the same ops unbatched", results[0], results[1])
        log(f"  mixed RBatch: {len(results[0])} results in staging order, equal to the "
            f"same ops unbatched ({rates['mixed_batch_ops_per_s']:.0f} ops/s)")
    finally:
        ref.shutdown()
    log(f"structures tier host-tier rates on {card}: " + json.dumps(rates))
    return rates


def merge_pair(tree: str, seed: int) -> int:
    """The client's merge call (`engine._merged_rows`: a numpy row list of
    257 and 1001 bank rows, as the backend passes it) and merge_stack over a
    stack of 256 beside torch.amax, with the package of `tree` (this
    checkout or another commit's): as called, host us per call and
    device-only (all of a call's device events: kernels, memsets, copies).
    Run once per tree, in turns, for a paired comparison in one call."""
    import torch

    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    from redisson_tpu_torch import engine
    from redisson_tpu_torch.ops import kernels as ok

    if not os.path.abspath(engine.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {engine.__file__}, not the package in {root}")
    card = card_line()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = 16384
    bank = torch.randint(0, 52, (SKETCHES + 4, m), dtype=torch.int32, device=dev, generator=g)
    stack = torch.randint(0, 52, (B3_SKETCHES, m), dtype=torch.int32, device=dev, generator=g)
    out = {}
    for r in (B3_SKETCHES + 1, MERGE_N + 1):
        rows = torch.randperm(SKETCHES + 4, device=dev, generator=g)[:r].to(
            torch.int32).cpu().numpy()
        want = bank[torch.from_numpy(rows).to(dev).long()].amax(0)
        if not torch.equal(engine._merged_rows(bank, rows), want):
            raise AssertionError(f"{tree}: the client's merge of {r} rows disagrees")
        call = lambda rows=rows: engine._merged_rows(bank, rows)  # noqa: E731
        out[f"client merge R={r}"] = {"ms": cuda_ms(call), "host_us": host_us(call),
                                      "_call": call}
    out["S=256"] = {"ms": cuda_ms(lambda: ok.merge_stack(stack)),
                    "host_us": host_us(lambda: ok.merge_stack(stack)),
                    "library_ms": cuda_ms(lambda: torch.amax(stack, 0)),
                    "library_host_us": host_us(lambda: torch.amax(stack, 0)),
                    "_call": lambda: ok.merge_stack(stack)}
    for part in out.values():  # device-only last: the profiler slows later launches
        call = part.pop("_call")
        part["device_ms"] = device_ms(lambda _b, call=call: call(), [bank[:1]] * 11)[0]
    print(card)
    print(json.dumps({"tree": tree, **out}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace short HLL and Bloom windows with torch.profiler")
    ap.add_argument("--merge-pair", metavar="TREE",
                    help="only time the client's merge call of the package in TREE (a "
                         "checkout of this or another commit), for a paired comparison")
    args = ap.parse_args()
    # A run that hangs prints every thread's stack and exits non-zero before
    # the 1200 s the run is allowed.
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.merge_pair:
        return merge_pair(args.merge_pair, args.seed)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from redisson_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: redisson_tpu_torch not found: {exc}", file=sys.stderr)
        return 2

    from redisson_tpu_torch import native

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build()
    log(f"kernel build: {build_s:.2f} s (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))
    t0 = time.perf_counter()
    native.build()
    if not native.available():
        raise AssertionError("the host fold library did not load")
    log(f"host fold library: {native.target().name}, built and loaded in "
        f"{time.perf_counter() - t0:.2f} s {native.BUILD_LOG.strip()}")

    deferred = []  # (what, row, key, fn, src, reps): device-only times, taken last
    phases = [("kernels", lambda: check_kernels(args.seed, deferred)),
              ("bits kernels", lambda: check_bits_kernels(args.seed, deferred)),
              ("delta kernels", lambda: check_delta_kernels(args.seed, deferred)),
              ("hll path", lambda: main_path(args.seed)),
              ("hll rates", lambda: rates(args.seed, card)),
              ("hll auto", lambda: auto_path(args.seed)),
              ("hll small vs cpu", lambda: small_vs_cpu(args.seed)),
              ("fpr probes", lambda: fpr_probes(args.seed)),
              ("bloom path", lambda: bloom_path(args.seed, out["fpr probes"])),
              ("bloom rates", lambda: bloom_rates(args.seed, card, out["fpr probes"])),
              ("bitset path", lambda: bitset_path(args.seed, card)),
              ("delta hll path", lambda: delta_hll_path(args.seed, out["hll path"][1])),
              ("delta bloom path", lambda: delta_bloom_path(args.seed,
                                                            out["bloom path"][1])),
              ("delta bitset path", lambda: delta_bitset_path(args.seed)),
              ("mixed tape window", lambda: mixed_window(args.seed)),
              ("delta rates", lambda: delta_rates(args.seed, card)),
              ("batch path", lambda: batch_path(card)),
              ("structures", lambda: structures_path(out["batch path"][1], card))]
    out = {}
    for name, fn in phases:
        t = time.perf_counter()
        out[name] = fn()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    # Once torch.profiler has run in a process, every later launch costs the
    # host more: the device-only times come after every host-timed phase.
    t = time.perf_counter()
    for what, row, key, fn, src, reps in deferred:
        row[key], parts = device_ms(fn, [src.clone() for _ in range(reps + 1)])
        log(f"{what}: device-only {row[key]:.5f} ms per call, by event: "
            + json.dumps(parts))
    del deferred
    log(f"phase device times: {time.perf_counter() - t:.1f} s")
    out["kernels"][1]["client_merge_window"] = merge_window(out["batch path"][1])
    if args.profile:
        profile_path(args.seed)
    out["batch path"][1].shutdown()
    seg, mrg = out["kernels"]
    pop, bop, bseg = out["bits kernels"]
    dmerge, wmerge = out["delta kernels"]
    launches = add_launches(out["hll path"][0], out["batch path"][0])
    bloom_l, bitset_l = out["bloom path"][0], out["bitset path"]
    delta_l = [out[p] for p in ("delta hll path", "delta bloom path",
                                "delta bitset path", "mixed tape window")]

    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "redisson_tpu")
                    or m.startswith(("jax.", "redisson_tpu.")))
    if leaked:
        raise AssertionError(f"the port loaded JAX modules: {leaked[:5]}")

    src = "redisson_tpu_torch/csrc/"
    kernels = [
        dict(name="seg_insert", route="cuda", source=src + "seg_insert.cu",
             replaces="redisson_tpu/ingest/kernels.py:127",
             launches=launches["seg_insert"], **seg),
        dict(name="merge_stack", route="cuda", source=src + "merge_stack.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:67",
             launches=launches["merge_stack"], **mrg),
        dict(name="bits_insert_segmented", route="cuda", source=src + "bits_insert.cu",
             replaces="redisson_tpu/ingest/kernels.py:145",
             launches=bloom_l["bits_insert_segmented"], **bseg),
        dict(name="popcount_partials", route="cuda", source=src + "popcount.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:172",
             launches=bloom_l["popcount_partials"] + bitset_l["popcount_partials"],
             **pop),
        dict(name="bitop_cells", route="cuda", source=src + "bitop.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:223",
             launches=bitset_l["bitop_cells"], **bop),
        dict(name="delta_merge", route="cuda", source=src + "delta_merge.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:116",
             launches=sum(d["delta_merge"] for d in delta_l), **dmerge),
        dict(name="window_merge", route="cuda", source=src + "window_merge.cu",
             replaces="redisson_tpu/ops/window_kernel.py:120",
             launches=sum(d["window_merge"] for d in delta_l), **wmerge),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
