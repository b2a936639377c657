#!/usr/bin/env python3
"""On-card smoke run of redisson_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]

Needs one CUDA card (Hopper: the kernels build for sm_90a) and `nvcc`.
Phases, each of which fails the run on error:

  1. print the card's name and power limit; build the CUDA kernels of
     `redisson_tpu_torch/csrc/` (one nvcc per source, in parallel);
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes (bit-identical), and time kernel, plain version,
     the kernel's bound and one PyTorch library call with CUDA events;
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
 10. with --profile, torch.profiler traces of short HLL and Bloom windows
     (device busy share, device time by kernel).

Each path (3, 7, 8) resets the launch counters just before it and reads
them just after. The last lines are the card's name and power limit, a
JSON object with one entry per kernel, and `{"ok": true, "device": {...}}`.
Exits non-zero, with no result, when no card is visible or the package is
missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

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


def check_kernels(seed: int):
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import hll
    from redisson_tpu_torch.ops import kernels as ok

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = hll.M
    n = 1 << 21
    regs = torch.randint(0, 20, (m,), dtype=torch.int32, device=dev, generator=g)
    cases = {
        "uniform": torch.randint(0, m, (n,), dtype=torch.int32, device=dev, generator=g),
        "hot_bucket": torch.full((n,), 12345, dtype=torch.int32, device=dev),
        "empty": torch.zeros((0,), dtype=torch.int32, device=dev),
    }
    seg_err = 0
    for name, bucket in cases.items():
        rank = torch.randint(0, 52, bucket.shape, dtype=torch.int32, device=dev,
                             generator=g)
        rank[: rank.numel() // 8] = 0  # invalid lanes
        got = ik.hll_insert_segmented(regs, bucket, rank)
        want = ik.hll_insert_segmented_plain(regs, bucket, rank)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        log(f"seg_insert {name} n={bucket.numel()}: max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"seg_insert {name} disagrees with its plain version")
        seg_err = max(seg_err, err)
    bucket = cases["uniform"]
    rank = torch.randint(1, 52, (n,), dtype=torch.int32, device=dev, generator=g)
    codes = bucket * 64 + rank
    sorted_codes, starts = ik.sort_codes(codes, m)
    scratch = regs.clone()
    idx = bucket.long()
    seg = {
        "ms": cuda_ms(lambda: ik.seg_insert_launch(regs, sorted_codes, starts)),
        "sort_ms": cuda_ms(lambda: ik.sort_codes(codes, m)),
        "plain_ms": cuda_ms(lambda: ik.hll_insert_segmented_plain(regs, bucket, rank)),
        "library_ms": cuda_ms(lambda: scratch.scatter_reduce_(0, idx, rank, reduce="amax")),
    }
    seg["bound_ms"], seg["bound_by"] = bound_ms(
        n * 4 + starts.numel() * 4 + 2 * m * 4, n)
    seg["max_abs_err"] = seg_err

    merge_err = 0
    for s in (SKETCHES, SKETCHES - 24, 0):
        stack = torch.randint(0, 52, (s, m), dtype=torch.int32, device=dev, generator=g)
        got = ok.merge_stack(stack)
        want = ok.merge_stack_plain(stack)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        log(f"merge_stack S={s}: max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"merge_stack S={s} disagrees with its plain version")
        merge_err = max(merge_err, err)
    stack = torch.randint(0, 52, (SKETCHES, m), dtype=torch.int32, device=dev, generator=g)
    mrg = {
        "ms": cuda_ms(lambda: ok.merge_stack(stack)),
        "plain_ms": cuda_ms(lambda: ok.merge_stack_plain(stack)),
        "library_ms": cuda_ms(lambda: torch.amax(stack, 0)),
    }
    mrg["bound_ms"], mrg["bound_by"] = bound_ms(
        SKETCHES * m * 4 + m * 4, SKETCHES * m)
    mrg["max_abs_err"] = merge_err
    return seg, mrg


def _same(name: str, got, want) -> int:
    """Raise unless `got` equals `want`; return their max abs difference."""
    import torch

    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    log(f"{name}: max_abs_err={err}")
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_bits_kernels(seed: int):
    """The BitSet / Bloom kernels against their plain versions at the Bloom
    and BitSet paths' shapes, and their times."""
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
                    ik.bits_insert_segmented(cells, idx),
                    ik.bits_insert_segmented_plain(cells, idx))
    small = cells_of(4096 + 7, 0.01)
    sidx = torch.randint(0, small.numel() + 1, (5000,), device=dev, generator=g)
    seg_err = max(seg_err, _same("bits_insert_segmented m=4103 (ragged tile)",
                                 ik.bits_insert_segmented(small, sidx),
                                 ik.bits_insert_segmented_plain(small, sidx)))
    codes, starts = ik.sort_codes(idx.to(torch.int32), BLOOM_M, 0, ik.BITS_TILE)
    scratch = cells.clone()
    vidx = idx[idx < BLOOM_M]  # the library call takes no sentinel
    seg = {"ms": cuda_ms(lambda: ik.seg_insert_launch(
               cells, codes, starts, 0, ik.BITS_TILE, "bits_insert_segmented")),
           "sort_ms": cuda_ms(lambda: ik.sort_codes(idx.to(torch.int32), BLOOM_M, 0,
                                                    ik.BITS_TILE)),
           "plain_ms": cuda_ms(lambda: ik.bits_insert_segmented_plain(cells, idx)),
           "library_ms": cuda_ms(lambda: scratch.scatter_(0, vidx, 1)),
           "max_abs_err": seg_err}
    seg["bound_ms"], seg["bound_by"] = bound_ms(
        n * 4 + starts.numel() * 4 + 2 * BLOOM_M, n)
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
    drive(ref, seed)
    ref_bank, ref_rows = ref.to_numpy_state()
    ref.shutdown()
    if set(rows) != set(ref_rows) or any(
            not np.array_equal(bank[r], ref_bank[ref_rows[n]]) for n, r in rows.items()):
        raise AssertionError("ingest=segment registers differ from ingest=sort")
    log(f"final bank: all {len(rows)} sketches bit-identical to ingest=sort")
    return launches


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
    return launches


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace short HLL and Bloom windows with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from redisson_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: redisson_tpu_torch not found: {exc}", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build()
    log(f"kernel build: {build_s:.2f} s (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))

    phases = [("kernels", lambda: check_kernels(args.seed)),
              ("bits kernels", lambda: check_bits_kernels(args.seed)),
              ("hll path", lambda: main_path(args.seed)),
              ("hll rates", lambda: rates(args.seed, card)),
              ("hll auto", lambda: auto_path(args.seed)),
              ("hll small vs cpu", lambda: small_vs_cpu(args.seed)),
              ("fpr probes", lambda: fpr_probes(args.seed)),
              ("bloom path", lambda: bloom_path(args.seed, out["fpr probes"])),
              ("bloom rates", lambda: bloom_rates(args.seed, card, out["fpr probes"])),
              ("bitset path", lambda: bitset_path(args.seed, card))]
    out = {}
    for name, fn in phases:
        t = time.perf_counter()
        out[name] = fn()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    if args.profile:
        profile_path(args.seed)
    seg, mrg = out["kernels"]
    pop, bop, bseg = out["bits kernels"]
    launches = dict(out["hll path"])
    bloom_l, bitset_l = out["bloom path"], out["bitset path"]

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
        dict(name="bits_insert_segmented", route="cuda", source=src + "seg_insert.cu",
             replaces="redisson_tpu/ingest/kernels.py:145",
             launches=bloom_l["bits_insert_segmented"], **bseg),
        dict(name="popcount_partials", route="cuda", source=src + "popcount.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:172",
             launches=bloom_l["popcount_partials"] + bitset_l["popcount_partials"],
             **pop),
        dict(name="bitop_cells", route="cuda", source=src + "bitop.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:223",
             launches=bitset_l["bitop_cells"], **bop),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
