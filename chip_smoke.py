#!/usr/bin/env python3
"""On-card smoke run of redisson_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]
    python3 chip_smoke.py --phase serve       # the build and one phase (see phase_table)
    python3 chip_smoke.py --phase replica     # the build and phase 19 alone
    python3 chip_smoke.py --phase cluster     # the build and phase 20 alone
    python3 chip_smoke.py --phase geo         # the build, a sort reference and phase 21
    python3 chip_smoke.py --phase redis       # the build and phase 22 alone
    python3 chip_smoke.py --phase pod         # the build, the references and phase 23
    python3 chip_smoke.py --phase passthrough # the build and phase 24 alone
    python3 chip_smoke.py --merge-pair TREE   # the client's merge call only, of TREE's package
    python3 chip_smoke.py --child-writer DIR  # phase 15's writer (the phase starts it)

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
  9. Bloom and BitSet rates, warm (median, min and max of 3 passes);
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
     producers and 4 consumers of 5,000 items each, 8 threads x 250
     RLock-guarded RAtomicLong increments, a 40,000-entry RMapCache with a
     1 s TTL swept empty by mc_evict_expired, 10,000 RTopic messages to 2
     listeners, and a mixed RBatch (10,000 map puts, 8 PFADDs, a Bloom add)
     equal to the same ops unbatched; host-tier ops/s of each;
 15. durability and faults (persist/, fault/): PFADD of 1024 x 40,000
     keys with the write-ahead journal under fsync="always" and
     "everysec" against none (median, min and max of 2 warm passes;
     fsyncs, journal bytes per key and new segments per pass); the bank,
     BASELINE config 2's Bloom filter and 2 daily bitmaps of phase 8 (cut
     from 7: savez_compressed of each 128 MiB cell array costs host
     seconds) journaled, then a snapshot while a second thread writes
     (the cut's dispatcher stall, seconds, bytes on disk); a child of this
     script (`--child-writer DIR`) reopens the directory, writes
     acknowledged batches with fsync="always" and is SIGKILLed; a new
     client recovers the directory (time to recover, replay ops/s, the
     kernels it launched: seg_insert and the segment-OR must), every
     acknowledged batch is present and the bank, Bloom cells and bitmaps
     equal a no-persist `sort` client fed the snapshot and the journal's
     records; then an injected retryable kernel_launch fault (the row
     unchanged), an injected state_uncertain readback (quarantine,
     rebuild, the row as before) and a real CUDA out-of-memory error
     (RetryableFault; the next PFADD succeeds);
 16. serving, tracing and memory (serve/, trace/, memstat/,
     observability.py) on clients with use_serve(), use_trace() (stride
     128) and use_memstat(): the HLL path of 3 sent by 8 caller threads as
     4 tenants, each PFADD once, one tenant held to 200,000 keys/s with a
     burst of one batch (its admitted keys at most burst + rate x elapsed +
     one batch, so it is shed; the others never), its shed PFADDs resent
     from the default tenant, then PFCOUNT of each sketch and PFMERGE +
     count over 1000 (bank equal to the unserved sort client's, estimates
     within phase 3's limits); the memory state (the 64 MiB bank, BASELINE
     config 2's filter, 7 daily 2^27-bit bitmaps): memory_verify() without
     drift, the ledger equal to the tensors' nbytes and to the caching
     allocator's requested bytes, every block made and kept in the window
     holding a ledger tensor within the allocator's rounding rule
     (memory_allocated's growth printed beside), memory_stats() keyed as
     the JAX package's; at the high watermark a SETBIT shed with
     RejectedError(reason="memory") before it allocates, a PFCOUNT served
     beside it, still shed after a delete leaves usage between the marks,
     admitted below the low watermark (marks configured, not read from the
     card's free memory); xxhash64 of 8M keys
     against the CPU, bitpos on the bitmaps against numpy, count_estimate
     against numpy's float32 formula, the (hi, lo) PFADD of the 1024 x
     40,000 keys under segment against the packed PFADDs' rows (seg_insert
     launched); a retryable kernel_launch fault, twice, absorbed by the
     serve retry (row equal to an oracle's) and a state-uncertain readback
     opening the breaker, the rebuild closing it (polled, up to 120 s);
     the learned cost model and the watchdog deadline it gives; PFADD
     inserts/s (512 x 40,000 keys a pass) and executor runs per pass of a
     plain, a ledger-detached, an untraced served and the served client
     (2 warm passes each, in turns; printed beside the JAX package's < 1%
     budgets); per-stage p50/p99 from the sampled spans; SLOWLOG booking a
     50 ms journal_fsync stall to the stalled PFADD's journal stage (at
     least 50 ms); a served pass traced at stride 1 (one op span per op,
     one run span per run, every op span nested in its run's span in the
     Chrome trace; each run's host staging and completion wait printed); a
     seeded churn ending at zero ledger bytes; get_nodes_group().ping_all().
     No check of this phase reads a rate or a latency;
 17. torch.profiler over 10 client PFMERGEs of config 3's sketches: one
     merge_stack kernel each, no memset, no host-to-device copy; then
     observability.profile() around 10 served PFADDs, whose trace names a
     seg_insert kernel;
 18. with --profile, torch.profiler traces of short HLL and Bloom windows
     (device busy share, device time by kernel);
 19. the read-replica tier (persist/follower.py, replica/, reactive/,
     services/; run after 16, before the device-only times): (1) a
     persisting primary (fsync="always", ingest="segment") writes the HLL
     path's 1024 x 40,000 keys, BASELINE config 2's Bloom filter with 10M
     adds and one 2^27-bit day with 8M SETBITs, and shuts down; a
     standalone JournalFollower on the card replays its journal (the only
     launches of that window: seg_insert and the segment-OR must), ending
     bit-identical to the primary with lag 0 and every state tensor on the
     card; (2) a client with two replicas on the same card takes the same
     writes: wait_for_replicas(2) = 2, both replicas bit-identical to the
     primary, then PFCOUNT of all 1024, countWith over 1000, contains of 1M
     Bloom keys and BITCOUNT routed to the replicas (each answer equal to
     the primary executor's; merge_stack and popcount_partials launched);
     a replica whose tail is stopped never serves once outside
     max_lag_seqs, reads fall back with both stopped, and a read after the
     tenant's write is pinned at or above its acked seq; (3) a failover
     drill on config 3's 256 x 40,000 keys: the old journal fenced (a
     write there refused), the promotee equal to the old primary at the
     fence, its journal continuing the numbering, the survivor resynced
     and caught up, writes after the failover reaching it, every
     acknowledged PFADD present (a `sort` oracle); (4) create_reactive on
     the card (8 awaited PFADDs and PFCOUNTs equal to a sync client's,
     seg_insert launched), an async lock between two tasks, an
     RRemoteService round trip and a CacheManager put / get / TTL. Every
     wait polls a state (timeout 120 s); catch-up seconds, replay keys/s,
     lag, reads per replica, failover seconds and the snapshot's bytes are
     printed, never checked.
 20. the cluster tier and the RESP front-end (cluster/, wire/; run after
     19): Redis Cluster's layout of 16384 CRC16 slots in contiguous ranges
     over four masters (ClusterConfig's default), every shard on cuda:0,
     each journaling under its own directory (fsync "off"): (1) every
     shard's device cuda:0, CLUSTER SLOTS covering 0-16383 once; (2) the
     HLL path's 1024 x 40,000 keys and 64 {t} sketches as one RBatch through
     the facade (the router splits it per owner; all four shards own some):
     registers bit-identical and PFCOUNT equal to a single `sort` client's;
     (3) a cross-shard PFMERGE over 1000 sketches (the host max-fold) and a
     countWith over the 64 {t} sketches on their shard (merge_stack), equal
     to the single client's; (4) BASELINE config 2's filter (10M adds) and
     two 2^27-bit {day} bitmaps (8M SETBITs each) on shard 3: BITCOUNT and
     BITOP OR equal numpy, the cells a single client's; (5) shard 0's range
     (about 256 sketches) migrated to shard 1 while two writers PFADD into
     those sketches (held at a barrier, not timed), then add_shard() and
     256 slots of shard 2 moved into it: every acknowledged PFADD present
     (a reference fed exactly those batches), no future lost; (ha)
     shard-level HA on a second cluster, Redis Cluster's 2 masters with one
     replica each (replicas_per_shard=1, four engines on cuda:0): 256 of the
     sketches and a 2^27-bit day (8M SETBITs) caught up by both replicas bit
     for bit; shard 0's primary executor killed under a writer and its
     replica promoted: its slots kept, every acknowledged PFADD present (a
     sort client fed exactly those batches), writes resumed on the
     promotee, countWith over shard 0's sketches (merge_stack) equal, BITCOUNT
     computed on the promotee after one more SETBIT (a popcount launch of its
     own), failovers 1, and a rejoined replica caught up, listed in
     CLUSTER SLOTS; a fresh 5-shard facade on the directory recovers the
     slot table and the registers; (6) on that facade, one RESP server per shard: 8 raw
     sockets (the port's resp_encode / RespParser) read CLUSTER SLOTS and
     pipeline PFADD of 1024 sketches x 4,000 12-byte keys (cut from 40,000:
     RESP carries keys as bulk strings) to the owning servers, registers
     equal an in-process client fed the same bytes; -MOVED from a wrong
     shard, -ASK on a slot parked in a cutover window while another shard
     imports it; PFCOUNT of the {t} keys, BITCOUNT and BITOP over the wire
     equal the in-process answers; wire.commands equal to the commands
     sent. Seconds, keys/s, migration seconds and stats, redirects, wire
     bytes and commands/s, the HA catch-up and failover seconds and replay
     keys/s are printed, never checked.
 21. geo replication (geo/; run after 20): Redis Enterprise's
     Active-Active database as its documentation describes it, two
     participating clusters with conflict-free merge and add-wins
     deletes: sites A and B on cuda:0 (the default config: the card,
     ingest "auto"), each journaling under its own directory with the
     default fsync, GeoConfig defaults, meshed with connect_sites. (1) The
     HLL path's 1024 x 40,000 keys, each sketch's keys split between the
     sites, the first 64 sketches written in full at both: after converge
     both banks equal the `sort` reference of phase 3 (the union); (2)
     config 2's filter initialized alike at both, 5M adds at each: cells
     equal each other and a single `scatter` client's; (3) one 2^27-bit
     bitmap, 4M SETBITs at each: cells equal, BITCOUNT equal to numpy's at
     both; (4) partitioned, B (its journal pumped past A's) PFADDs to 8 of
     the 16 sketches A deletes: after the heal the 8 hold B's state at both
     sites and the other 8 are gone at both; then a SETBIT-to-0 of 1,000
     bits at A (pumped past B) replicates as a replace; (5) B isolated by
     geo_link faults while both write 64 sketches: bit-identical after the
     heal; (6) B shut down, A writing, B reopened on its directory: its
     version vector equals the one its sidecar saved, and the sites
     converge bit-identical over every key. geo_planes > 0 and
     geo_classic == 0 at both sites, delta_merge launched. Converge seconds
     per step, remote-apply keys/s, link against raw journal bytes and the
     phase's launches are printed, never checked.
 22. the redis durability tier (interop/): the port's EmbeddedRedis in
     this process with redis's own HLL hash (MurmurHash64A), and a card
     client (cuda:0, ingest "segment", hll_hash="redis") whose redis
     section points at it. (1) BASELINE config 3's 256 sketches of the HLL
     path's 40,000 keys (each uint64's 8 little-endian bytes, with the
     path's neighbouring overlap), config 2's Bloom filter (m =
     257,296,945, k = 7) with 10M adds and one 2^27-bit day of 8M SETBITs;
     (2) `durability.flush()` writes 258 objects: each HLL blob decodes to
     the card's bank row bit for bit, the Bloom blob is packbits of the
     card's cells and its {name}__config hash carries size,
     hashIterations, expectedInsertions and falseProbability, the BitSet
     blob is the packed extent; (3) the server's own PFADD of 4 sketches'
     keys into fresh keys gives the card's registers, and its PFCOUNT of
     every sketch is its estimator over the card's registers, the card's
     count within rel 1e-5 of it (plus half a unit of integer rounding);
     (4) a fresh card client loads every object: registers, cells and
     bitmap equal, BITCOUNT equal to numpy's, all 10M added keys
     contained (counted on the card), the union PFCOUNT over the 256
     (merge_stack) equal, every state tensor on cuda:0; (5) a client with
     flush_interval_s = 0.2 carries one more PFADD to the server's blob,
     and a second only_dirty flush writes nothing; seg_insert,
     bits_insert_segmented, popcount_partials and merge_stack launched.
     Fill, flush and load seconds, flush MB/s, the device-to-host copy of
     the Bloom cells apart from np.packbits and the phase's wall seconds
     are printed, never checked.
 23. the pod tier and the mesh data plane (parallel/, cluster/ mesh
     plane): a pod client (use_pod(num_shards=4, bank_capacity=1024): four
     mesh entries, entry i on cuda:{i % cards}, each entry's rows of the
     bank and cells of every BitSet and Bloom a tensor of its own; on one
     card four tensors of cuda:0; each array's blocks printed with their
     card and bytes). (1) The HLL path's 1024 x
     40,000 keys (a 64 MiB bank, 256 rows per shard; one seg_insert per
     shard per chunk) and 64 of the sketches again as 8-byte strings
     (hashed on the card, no register rises): the bank bit-identical to
     phase 3's `sort` reference, per-sketch PFCOUNT, count-all (per-shard
     merge_stack, a max across shards) and PFMERGE+count over 1000 equal
     to it (rel 1e-5); reshard(2) then reshard(4) keep the bank bit for
     bit (64 sketches re-counted). (2)
     Config 2's filter sharded over the 4 shards, 10M adds in 2M batches
     (one segment-OR launch per shard per batch): cells and added flags
     equal phase 7's single-card `scatter` filter, all 10M contained,
     count() equal. (3) One 2^32-bit BitSet (4 GiB, 2^30 cells per shard):
     SETBIT at each shard's first and last cell (2^32 - 1 among them) with
     the old values, LENGTH 2^32, set_range [0, 2^31 + 2^20] and BITCOUNT
     equal to the host's exact count past 2^31 (per-shard popcount
     partials, an int64 combine); BITOP OR and AND of two 2^27-bit days
     against numpy. (4) With two cards or more, steps 1-3 ran over
     min(4, cards) cards, and a child process that sees one card
     (`--pod-one-card`) runs step 1 and step 5 again on four tensors of
     that card: PFADD keys/s, PFMERGE+count ms and reshard seconds of both
     printed side by side with every card's name and power limit; on one
     card a line says the step did not run. (5)
     `use_cluster(num_shards=4, data_plane="mesh")`, its bank one block
     per entry over min(4, cards) cards (four tensors of cuda:0 on one
     card; each block's card and bytes printed), with phase 20's keys and
     layout against the stacks plane on the same sequence: replies (128
     PFCOUNTs among them) and every register equal, collective_merges > 0,
     mesh_occupancy() the live sketch count; shard 0's range migrated live
     to the shard with the most free rows under two writers, every
     acknowledged PFADD present, rows relocated across blocks; its RBatch
     seconds, PFMERGE-over-1000 ms and migration seconds printed, on
     several cards beside the one-card child's. seg_insert, merge_stack,
     bits_insert_segmented, popcount_partials and bitop_cells must launch
     in (1)-(3). Keys/s, merge ms, reshard and migration seconds are
     printed, never checked. Run alone (`--phase pod`) it makes its own
     `sort` and `scatter` references.
 24. the passthrough mode (interop/backend_redis.py, bloom_redis.py,
     coordination_redis.py): a config whose only section is redis against
     the port's EmbeddedRedis (redis's HLL hash) in this process. Config
     3's 256 sketches x 4,000 keys through server-side PFADD: every
     server register equals a redis-family card client's (built before
     the window) and every PFCOUNT the server fold of them; a Bloom filter
     of 100,000 adds whose contains of 20,000 probes, count() and server
     string equal the card client's cells; one round of RMap, RQueue with
     a blocking pop, RLock, fair and read-write locks, semaphore, latch,
     topic, map cache with its TTL sweep and a script. Cuts (listed in the
     phase's docstring): 4,000 keys per sketch, 100,000 Bloom adds. Gate:
     torch.cuda.memory_allocated() is the same before the passthrough
     client is made and after it shuts down.

Each path (3, 7, 8, 10, 11, 13, 15's recovery with the checks after it,
16, each step of 19, 20 and 23, 21 and 22) resets the launch counters just
before it and reads them just after. The last lines are the card's name and power limit, a
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
EXACT_ALL = (SKETCHES - 1) * STRIDE + KEYS  # the union of every sketch
TIMING_REPS = 3
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
# producers and 4 consumers of 5,000 items each; 8 threads x 250 locked
# increments; a 40,000-entry map cache with a 1 s TTL swept empty; 10,000
# topic messages to 2 listeners; one mixed RBatch of 10,000 map puts, 8
# PFADDs and a Bloom add. The queue, lock and cache passes are per-op host
# paths, cut below user sizes to keep the whole run inside its limit (the
# queue and lock passes halved again when phases 23-24 came): a smaller
# count reads the same per-op rate.
ST_MAP = 1_000_000
ST_MAP_CHUNK = 10_000
ST_MAP_GET = 100_000
ST_ZSET = 1_000_000
ST_ZSET_PROBES = 1
ST_QUEUE_THREADS = 4
ST_QUEUE_ITEMS = 5_000
ST_LOCK_THREADS = 8
ST_LOCK_ITERS = 250
ST_CACHE = 40_000
ST_CACHE_TTL_S = 1.0
ST_TOPIC = 10_000
ST_BATCH_PUTS = 10_000
ST_BATCH_HLLS = 8

# Phase 15, durability and faults: the HLL path's 1024 x 40,000 keys, BASELINE
# config 2's Bloom filter and DUR_DAYS of phase 8's daily bitmaps (cut from
# 7: savez_compressed of each 128 MiB cell array costs host seconds).
DUR_DAYS = 2
DUR_REPS = 2  # timed journaled-ingest passes per fsync policy, after a warm one
DUR_DIR = "build/phase15"  # git-ignored, inside the checkout; removed after
CHILD_SKETCHES = 16  # the child writer's batches cycle over these sketches
CHILD_BATCH_KEYS = 20_000
CHILD_KILL_AFTER = 40  # acknowledged batches the parent waits for, then SIGKILL
CHILD_TIMEOUT_S = 180
# The traffic beside the snapshot: a PFADD of this many keys, then a pause
# (unthrottled, the thread's journaling starves savez_compressed of the GIL
# and every record it adds is replayed twice later).
TRAFFIC_KEYS = 10_000
TRAFFIC_PAUSE_S = 0.1
# Phase 16, serving, tracing and memory: the HLL path's 1024 x 40,000 keys
# from SV_THREADS caller threads as SV_TENANTS tenants, one of them held to
# SV_LIMITED_RATE keys/s with a burst of one batch (far below any served
# rate, so the shed check is an inequality that holds at any speed: see
# served_hll); SV_REPS timed passes per client for the overhead ratios; a
# SV_STALL_S journal_fsync stall; SV_BITS_PER_DAY SETBITs into each of the
# 7 daily bitmaps; the 8M-key xxhash64 batch; a churn of SV_CHURN_STEPS
# steps. No check of the phase reads a rate or a latency: those are printed.
SV_THREADS = 8
SV_TENANTS = 4
SV_LIMITED = "tenant-3"
SV_LIMITED_RATE = 200_000
SV_LIMITED_BURST = KEYS
SV_TIMEOUT_MS = 600_000  # a served op's deadline (ServeConfig default: 3 s)
SV_REPS = 2
# Sketches per overhead pass: an eighth of the HLL path's (the rates are
# per key, printed and never checked; 4 clients x 3 passes of the whole
# path would take most of the phase's minute).
SV_RATE_SKETCHES = SKETCHES // 8
SV_STALL_S = 0.05
SV_BITS_PER_DAY = 1_000_000
SV_XXH_KEYS = 1 << 23
SV_CHURN_STEPS = 200
# Waits on a state another thread reaches (the completer retiring runs, the
# rebuild closing a breaker): polled, never slept for a fixed time.
SV_WAIT_S = 120.0
# MEMORY STATS keys beside the per-kind "<kind>.bytes" ones (the JAX
# package's memstat/report.py keys, in its order).
MEM_STATS_KEYS = ("peak.allocated", "total.allocated", "dataset.bytes",
                  "dataset.percentage", "keys.count", "keys.bytes-per-key",
                  "cache.bytes", "scratch.bytes", "staging.bytes", "disk.bytes",
                  "fragmentation", "bank.bytes", "lifecycle.events")
SV_DIR = "build/phase16"  # git-ignored, inside the checkout; removed after
SV_PROFILE_DIR = "build/phase16-profile"
# Phase 19, the read-replica tier: a journal follower replaying the HLL
# path's 1024 x 40,000 keys, BASELINE config 2's Bloom filter (10M adds) and
# one 2^27-bit daily bitmap (8M SETBITs); a fleet of two replicas taking the
# same writes; a failover drill on config 3's 256 x 40,000 state. Every wait
# polls for a state and fails only after RP_WAIT_S; no check reads a rate, a
# latency or a lag in seconds (those are printed).
RP_DIR = "build/phase19"  # git-ignored, inside the checkout; removed after
RP_WAIT_S = 120.0
RP_MAX_LAG = 64  # the fleet's max_lag_seqs
RP_FREEZE_WRITES = 2 * RP_MAX_LAG  # PFADDs that push a frozen replica out
RP_FREEZE_KEYS = 1000
RP_POST_BATCHES = 16  # PFADDs of 40,000 keys through the router after the failover
RP_RX_SKETCHES = 8
RP_CACHE_TTL_S = 0.5
# Phase 20: the cluster tier and the RESP front-end (Redis Cluster's layout:
# 16384 CRC16 slots in contiguous ranges over four masters, all on cuda:0).
CL_DIR = "build/phase20"  # git-ignored, inside the checkout; removed after
CL_SHARDS = 4  # ClusterConfig's default (redis.io's tutorial: at least 3)
CL_TAG_SKETCHES = 64  # {t} sketches on one shard, for countWith
CL_WRITE_KEYS = 10_000  # keys per writer PFADD during the migration
CL_WRITE_MIN = 8  # batches each writer sends at least
CL_WRITE_MAX = 400  # and at most (it stops once the migration is done)
CL_NEW_RANGE = 256  # slots moved into the added shard
CL_WIRE_KEYS = 4_000  # byte keys per sketch over the wire (cut from KEYS)
CL_WIRE_KEY_BYTES = 12
CL_WIRE_SOCKETS = 8
CL_WIRE_PIPELINE = 64  # commands in flight per socket (the cap is 128)
CL_WAIT_S = 120.0
# Phase 20's "ha" step: a second cluster, Redis Cluster's smallest HA
# layout (2 masters, one replica each: four engines on cuda:0).
CL_HA_DIR = os.path.join(CL_DIR, "ha")
CL_HA_SKETCHES = 256  # the first of cl_data's sketches, over both shards by slot
CL_HA_WRITE_SKETCHES = 64  # further sketches of shard 0 the writer PFADDs into
CL_HA_WRITE_MIN = 8  # acknowledged writer PFADDs before the kill, and after
CL_HA_WRITE_MAX = 4000  # the writer's cap (it stops once the checks have run)

# Phase 21: Redis Enterprise's Active-Active (CRDT) database, two
# participating clusters on one card: sites A and B, each journaling under
# its own directory (default fsync), GeoConfig defaults.
GEO_DIR = "build/phase21"  # git-ignored, inside the checkout; removed after
GEO_BOTH = 64  # sketches written in full at both sites (the rest split 50/50)
GEO_LWW_DEL = 16  # sketches A deletes while partitioned
GEO_LWW_NEWER = 8  # of them, the ones B writes to with newer stamps
GEO_LWW_KEYS = 1_000  # keys of each of B's newer PFADDs
GEO_CLEAR = 1_000  # bits a SETBIT-to-0 clears (replicated as a replace)
GEO_PART_SKETCHES = 64  # sketches both sites write while B is isolated
GEO_KILL_KEYS = 10_000  # keys per sketch A writes while B is down
GEO_WAIT_S = 120.0

# Phase 22 (the redis durability tier): BASELINE config 3's 256 sketches of
# the HLL path's keys, config 2's Bloom filter and one day of the BitSet
# path, flushed to the embedded RESP server and loaded back.
RD_SKETCHES = 256  # B3_SKETCHES
RD_FOLD_CHECK = 4  # sketches the server re-folds from the keys (pure Python)
RD_FLUSH_S = 0.2  # the periodic client's flush_interval_s
RD_EXTRA_KEYS = 10_000  # keys of the PFADD the periodic flusher must carry
RD_TIMEOUT_MS = 60_000  # the pool's response timeout: a 32 MB SET is one reply
RD_WAIT_S = 60.0

# Phase 23: the pod tier and the mesh data plane, 4 logical shards on cuda:0.
PD_DIR = "build/phase23"  # git-ignored, inside the checkout; removed after
PD_SHARDS = 4
PD_BYTE_SKETCHES = 64  # sketches whose keys go in again as 8-byte strings
PD_BIG_BITS = 1 << 32  # the BitSet at the tier's own limit: 4 GiB of cells
PD_RANGE_LAST = (1 << 31) + (1 << 20)  # set_range [0, PD_RANGE_LAST], inclusive
PD_WAIT_S = 120.0
PD_RESHARD_COUNTS = 64  # sketches re-counted after each reshard (the bank is compared whole)
PD_PLANE_COUNTS = 128  # PFCOUNTs per data plane (every register is compared)

# Phase 24: the passthrough mode against the port's EmbeddedRedis.
PT_SKETCHES = 256  # B3_SKETCHES
PT_KEYS = 4_000  # CL_WIRE_KEYS: keys cross the socket as bulk strings
PT_STRIDE = PT_KEYS * 3 // 4
PT_BLOOM_N = 100_000  # adds (and the filter's expected insertions)
PT_BLOOM_P = 0.01
PT_PROBES = 10_000  # contains probes of added keys, and as many fresh ones
PT_TIMEOUT_MS = 60_000  # a Lua-guarded Bloom slab on the pure-Python server
PT_WAIT_S = 30.0
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
            raw.counted = False  # a direct foreign call: no wrapper counts it
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
            raw.counted = False  # a direct foreign call: no wrapper counts it
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

    ref = sort_reference(seed)
    same_bank(bank, rows, ref[1], ref[2], "ingest=segment")
    return launches, ref


def sort_reference(seed: int):
    """The main path's ops under ingest="sort" (no hand kernel): (results,
    bank, rows), the reference the other ingests' banks are held to."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    try:
        ref_res = drive(ref, seed)
        ref_bank, ref_rows = ref.to_numpy_state()
    finally:
        ref.shutdown()
    return ref_res, ref_bank, ref_rows


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


#: the one event of a device_ms result timed between CUDA events
CUDA_EVENTS = "cuda events around each call"


def device_ms(fn, bufs, counted: bool = False):
    """Device time per call of `fn(buf)` over distinct buffers, from
    torch.profiler's kernel and memset events (host issue excluded), after a
    warm-up on the first -> (total ms per call, {event: ms per call}). Each
    event of a call runs once per call; its time is the mean over the
    occurrences the profiler recorded, which may be fewer than the calls
    (it can drop events), so a dropped event does not thin the mean.
    Where the profiler records nothing three times, each call is timed
    between CUDA events instead ({CUDA_EVENTS: ms}); `counted` says `fn`
    goes through a kernel wrapper, which must then count a launch a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(bufs[0])
    torch.cuda.synchronize()
    calls = len(bufs) - 1
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in bufs[1:]:
                fn(b)
            torch.cuda.synchronize()
        parts, seen = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if us:
                parts[e.key[:60]] = us / 1e3 / e.count
                seen[e.key[:60]] = e.count
        if parts:
            break
        # A window may come back empty (seen once, after ~130 profiled
        # windows): trace it again on the same buffers, and say so, since an
        # in-place kernel then meets inputs it has already merged.
        log(f"torch.profiler recorded no device time in window {attempt + 1}; "
            "tracing again on the same buffers (already merged into)")
    if not parts:
        # Three empty windows in a row (seen once in a run of ~80
        # windows): time each call between CUDA events instead. The
        # window then also holds the call's launch gap.
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in bufs[1:]]
        before = sum(all_launches().values())
        for (start, end), b in zip(marks, bufs[1:]):
            start.record()
            fn(b)
            end.record()
        torch.cuda.synchronize()
        launched = sum(all_launches().values()) - before
        if counted and launched < calls:
            raise AssertionError(f"{launched} kernel launches counted in {calls} calls "
                                 "timed between CUDA events")
        ms = sum(start.elapsed_time(end) for start, end in marks) / calls
        log(f"torch.profiler recorded no device time in 3 windows; CUDA events "
            f"around each call instead: {ms:.5f} ms per call")
        return ms, {CUDA_EVENTS: ms}
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


def all_launches() -> dict:
    """Every kernel's launch counter (after a synchronize)."""
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import kernels as ok
    from redisson_tpu_torch.ops import window_kernel as wk

    torch.cuda.synchronize()
    return {**ik.launches, **ok.launches, **wk.launches}


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


# -- phase 15: durability and faults -----------------------------------------


def metric(card: str, what: str, value) -> None:
    """One phase-15 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 15 {what}: {value}")


def persist_client(path: str, fsync: str = "always", ingest: str = "segment",
                   **faults):
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(ingest=ingest)
    if path:
        cfg.use_persist(path, fsync=fsync)
    if faults:
        cfg.use_faults(**faults)
    return RedissonTorch.create(cfg)


def journal_pass_stats(client):
    """(fsyncs, bytes appended, segment files) of a client's journal."""
    from redisson_tpu_torch.persist.journal import _list_segments

    if client.persist is None:
        return 0, 0, 0
    st = client.persist.journal.stats()
    return st["fsyncs"], st["bytes_appended"], len(_list_segments(client.persist.cfg.dir))


def journaled_rates(seed: int, card: str, passes) -> dict:
    """PFADD inserts/s of 1024 sketches x 40,000 keys through the client
    without persistence and with the journal under fsync="always" and
    "everysec": one warm pass, then DUR_REPS timed passes of fresh keys."""
    import shutil

    rows, out = [], {}
    for policy in (None, "always", "everysec"):
        path = os.path.join(DUR_DIR, f"ingest-{policy}")
        shutil.rmtree(path, ignore_errors=True)
        client = persist_client(path if policy else "", fsync=policy or "always")
        hlls = [client.get_hyper_log_log(f"j:{i}") for i in range(SKETCHES)]
        rate, fsyncs, per_key, segs = [], [], [], []
        for rep, batches in enumerate(passes):
            f0, b0, s0 = journal_pass_stats(client)
            t0 = time.perf_counter()
            futs = [h.add_ints_async(b) for h, b in zip(hlls, batches)]
            [f.result() for f in futs]
            dt = time.perf_counter() - t0
            f1, b1, s1 = journal_pass_stats(client)
            if rep:
                rate.append(SKETCHES * KEYS / dt)
                fsyncs.append(f1 - f0)
                per_key.append((b1 - b0) / (SKETCHES * KEYS))
                segs.append(s1 - s0)
        client.shutdown()
        shutil.rmtree(path, ignore_errors=True)
        what = "none" if policy is None else f'fsync="{policy}"'
        rows.append((f"journaled PFADD, {SKETCHES} x {KEYS} keys, persistence {what}",
                     [r / 1e6 for r in rate], "M inserts/s"))
        out[what] = {"inserts_per_s": median_spread(rate), "fsyncs_per_pass": fsyncs,
                     "journal_bytes_per_key": per_key, "segments_per_pass": segs}
        if policy:
            metric(card, f"fsyncs per pass, {what}", fsyncs)
            metric(card, f"journal bytes per key, {what}", per_key)
            metric(card, f"new journal segments per pass, {what}", segs)
    report(card, rows, ", ingest=segment")
    return out


def build_state(client, seed: int, batches) -> None:
    """The phase's data set: the bank, the Bloom filter, the daily bitmaps."""
    futs = [client.get_hyper_log_log(f"hll:{i}").add_ints_async(b)
            for i, b in enumerate(batches)]
    [f.result() for f in futs]
    bloom_fill(client, "bloom", seed)
    for d, ids in enumerate(day_ids(seed)[:DUR_DAYS]):
        client.get_bit_set(f"day:{d}").set_bits(ids)


def snapshot_in_traffic(client, seed: int, card: str) -> dict:
    """snapshot_now() while a second thread keeps PFADDs in flight (one of
    TRAFFIC_KEYS keys every TRAFFIC_PAUSE_S)."""
    import threading

    stop, sent = threading.Event(), [0]

    def traffic():
        i = 0
        while not stop.wait(TRAFFIC_PAUSE_S):
            client.get_hyper_log_log(f"live:{i % 64}").add_ints(
                keys_for((1 << 42) + i * TRAFFIC_KEYS, TRAFFIC_KEYS, seed))
            i += 1
            sent[0] = i

    t = threading.Thread(target=traffic, name="phase15-traffic")
    t.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    path = client.snapshot_now()
    wall = time.perf_counter() - t0
    stop.set()
    t.join(60)
    if t.is_alive():
        raise AssertionError("the traffic thread did not stop")
    st = client.persist.snapshotter.stats()
    out = {"cut_stall_ms": st["last_cut_s"] * 1e3, "snapshot_s": wall,
           "bytes_on_disk": client.persist.snapshotter.disk_bytes(),
           "traffic_pfadds": sent[0], "path": path}
    metric(card, "snapshot cut: dispatcher stall (ms)", out["cut_stall_ms"])
    metric(card, "snapshot under traffic: seconds", wall)
    metric(card, "snapshot: bytes on disk", out["bytes_on_disk"])
    metric(card, f"snapshot: PFADDs of {TRAFFIC_KEYS} keys from the second thread "
           "meanwhile", sent[0])
    return out


def child_writer(path: str, seed: int) -> int:
    """The --child-writer role: reopen the persist directory (auto-recovery),
    then write batches with fsync="always", printing each acknowledged
    batch's id, until killed."""
    client = persist_client(path)
    log(f"READY {json.dumps(client.persist.last_recovery)}")
    bloom = client.get_bloom_filter("bloom")
    bits = client.get_bit_set("crash:bits")
    for i in range(1 << 30):
        keys = keys_for((1 << 44) + i * CHILD_BATCH_KEYS, CHILD_BATCH_KEYS, seed)
        client.get_hyper_log_log(f"crash:{i % CHILD_SKETCHES}").add_ints(keys)
        bloom.add_ints(keys & np.uint64(MASK63))
        bits.set(i, True)
        print(f"ACK {i}", flush=True)
    return 0


def run_child(path: str, seed: int):
    """Start the child writer, SIGKILL it once CHILD_KILL_AFTER batches are
    acknowledged; returns (acknowledged ids, what its recovery printed)."""
    import signal
    import threading

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child-writer", path,
         "--seed", str(seed)], stdout=subprocess.PIPE, text=True)
    timer = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
    timer.start()
    acked, ready = [], None
    try:
        for line in proc.stdout:
            if line.startswith("READY "):
                ready = json.loads(line[6:])
            elif line.startswith("ACK "):
                acked.append(int(line[4:]))
                if len(acked) == CHILD_KILL_AFTER:
                    proc.send_signal(signal.SIGKILL)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait(60)
    if len(acked) < CHILD_KILL_AFTER:
        raise AssertionError(f"the child writer acknowledged {len(acked)} batches "
                             f"in {CHILD_TIMEOUT_S} s (exit {proc.returncode})")
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"child writer exited {proc.returncode} after "
                             f"{len(acked)} acknowledged batches")
    if acked != list(range(len(acked))):
        raise AssertionError("the child's acknowledgements are out of order")
    return acked, ready


def same_objects(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want) or any(not np.array_equal(got[n][1], want[n][1])
                                    for n in want):
        raise AssertionError(f"{what}: BitSet / Bloom cells differ")


def recover_and_check(seed: int, path: str, acked, card: str) -> dict:
    """Open the crashed directory in a new client, time the recovery, read
    the kernels it launched, and hold the state against a no-persist
    reference fed the newest snapshot and the journal's records."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.persist.journal import iter_records
    from redisson_tpu_torch.persist.snapshotter import find_snapshots

    reset_all_launches()
    t0 = time.perf_counter()
    client = persist_client(path)
    wall = time.perf_counter() - t0
    rec = client.persist.last_recovery
    names = [f"hll:{i}" for i in range(SKETCHES)]
    union = client.get_hyper_log_log(names[0]).count_with(*names[1:])
    day_counts = [client.get_bit_set(f"day:{d}").cardinality() for d in range(DUR_DAYS)]
    launches = all_launches()
    metric(card, "time to recover: client create on the crashed directory (s)", wall)
    metric(card, "recovery: snapshot load + journal replay (s)", rec["seconds"])
    metric(card, "recovery: ops replayed", rec["replayed"])
    metric(card, "recovery: replay ops/s", rec["ops_per_s"])
    metric(card, "recovery: kernel launches (recovery and the checks after it)",
           json.dumps(launches))
    if rec["replay_errors"]:
        raise AssertionError("journal records failed on replay")
    for name in ("seg_insert", "bits_insert_segmented", "merge_stack",
                 "popcount_partials"):
        if not launches[name]:
            raise AssertionError(f"{name} did not launch during recovery: {launches}")
    bank, rows = client.to_numpy_state()
    objects = client.to_numpy_objects()
    client.shutdown()
    bits = objects["crash:bits"][1]
    missing = [i for i in acked if not bits[i]]
    if missing:
        raise AssertionError(f"acknowledged batches lost: {missing[:10]}")

    watermark, snap = find_snapshots(path)[-1]
    ref = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    ref.load_checkpoint(snap)
    n = 0
    for r in iter_records(path, from_seq=watermark):
        if r.seq > rec["last_seq"]:
            break
        ref._executor.execute_sync(r.target, r.kind, r.payload)
        n += 1
    ref_bank, ref_rows = ref.to_numpy_state()
    ref_objects = ref.to_numpy_objects()
    ref_union = ref.get_hyper_log_log(names[0]).count_with(*names[1:])
    ref.shutdown()
    same_bank(bank, rows, ref_bank, ref_rows, "recovery (snapshot + journal)")
    same_objects(objects, ref_objects, "recovery (snapshot + journal)")
    want_days = [int(np.count_nonzero(ref_objects[f"day:{d}"][1])) for d in range(DUR_DAYS)]
    if union != ref_union or day_counts != want_days:
        raise AssertionError(f"count_with {union} vs {ref_union}, BITCOUNT "
                             f"{day_counts} vs {want_days}")
    log(f"  recovered state: all {len(acked)} acknowledged child batches present; "
        f"bank, Bloom cells and bitmaps equal a no-persist sort/scatter client fed "
        f"the snapshot and {n} journal records; count_with {union}, BITCOUNT {day_counts}")
    return {"recover_s": wall, "replay_s": rec["seconds"], "replayed": rec["replayed"],
            "replay_ops_per_s": rec["ops_per_s"], "launches": launches}


def fault_checks(seed: int, batches, card: str) -> dict:
    """The three fault checks on a persist client holding the 1024-sketch
    bank: an injected retryable kernel_launch fault, an injected
    state_uncertain readback fault and its rebuild, and a real CUDA out-of-
    memory error through the classifier."""
    import shutil

    import torch
    from redisson_tpu_torch.fault.taxonomy import (RetryableFault,
                                                   StateUncertainFault)

    path = os.path.join(DUR_DIR, "faults")
    shutil.rmtree(path, ignore_errors=True)
    plan = [{"seam": "kernel_launch", "fault": "retryable", "nth": 2,
             "kind": "hll_add", "target": "f:retry"},
            {"seam": "d2h_complete", "fault": "state_uncertain", "nth": 1,
             "kind": "hll_count", "target": "hll:7"}]
    client = persist_client(path, plan=plan)
    ex = client._executor
    try:
        futs = [client.get_hyper_log_log(f"hll:{i}").add_ints_async(b)
                for i, b in enumerate(batches)]
        [f.result() for f in futs]
        client.snapshot_now()
        # 1. a retryable fault before the kernels: nothing commits
        retry = client.get_hyper_log_log("f:retry")
        retry.add_ints(keys_for(1 << 45, KEYS, seed))
        before = ex.execute_sync("f:retry", "hll_export", None)[0]
        try:
            retry.add_ints(keys_for((1 << 45) + KEYS, KEYS, seed))
            raise AssertionError("the injected kernel_launch fault did not fire")
        except RetryableFault as exc:
            if exc.seam != "kernel_launch":
                raise
        if not np.array_equal(ex.execute_sync("f:retry", "hll_export", None)[0], before):
            raise AssertionError("a PFADD that failed retryably changed its row")
        log("  fault 1: kernel_launch retryable fault -> RetryableFault, row unchanged")
        # 2. a state-uncertain readback: quarantine, rebuild, row as before
        h7 = client.get_hyper_log_log("hll:7")
        h7.add_ints(keys_for(1 << 46, KEYS, seed))  # a suffix past the snapshot
        want = ex.execute_sync("hll:7", "hll_export", None)[0]
        t0 = time.perf_counter()
        try:
            h7.count()
            raise AssertionError("the injected d2h_complete fault did not fire")
        except StateUncertainFault:
            pass
        if not client.fault.rebuild.wait_idle(timeout=120):
            raise AssertionError("the rebuild did not settle")
        rebuild_s = time.perf_counter() - t0
        snap = client.fault.rebuild.snapshot()
        got = ex.execute_sync("hll:7", "hll_export", None)[0]
        if snap["rebuilt_total"] < 1 or snap["rebuild_failures"] or snap["degraded"]:
            raise AssertionError(f"rebuild state {snap}")
        if not np.array_equal(got, want):
            raise AssertionError("the rebuilt row differs from the pre-fault row")
        log("  fault 2: d2h_complete state_uncertain on PFCOUNT -> quarantine, rebuild "
            f"from snapshot + {snap['replayed_total']} suffix records, row equal to "
            "the pre-fault row")
        metric(card, "fault 2: fault to rebuilt and settled (s)", rebuild_s)
        # 3. a real CUDA error: a bitmap larger than the card's free memory
        free, total = torch.cuda.mem_get_info()
        try:
            client.get_bit_set("f:huge").set(2 * free, True)  # one byte per bit
            raise AssertionError("a bitmap twice the free memory was allocated")
        except RetryableFault as exc:
            if not isinstance(exc.cause, torch.cuda.OutOfMemoryError):
                raise
        if not client.get_hyper_log_log("f:after").add_ints(keys_for(1 << 47, KEYS, seed)):
            raise AssertionError("the PFADD after the OOM reported no change")
        log(f"  fault 3: SETBIT needing {2 * free} bytes ({free} of {total} free) -> "
            "torch.cuda.OutOfMemoryError -> RetryableFault; the next PFADD succeeded")
    finally:
        client.shutdown()
        shutil.rmtree(path, ignore_errors=True)
    return {"rebuild_s": rebuild_s, "rebuild_replayed": snap["replayed_total"]}


def durability_path(seed: int, card: str) -> dict:
    """Phase 15: journaled ingest rates, a snapshot under traffic, a
    SIGKILLed child writer and the recovery after it, and the fault checks."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    os.makedirs(DUR_DIR)
    passes = [[keys_for(rep * (1 << 36) + i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
              for rep in range(DUR_REPS + 1)]
    log(f"phase 15 on {card}:")
    out = {"ingest": journaled_rates(seed, card, passes)}
    path = os.path.join(DUR_DIR, "crash")
    client = persist_client(path)
    try:
        build_state(client, seed, passes[0])
        out["snapshot"] = snapshot_in_traffic(client, seed, card)
    finally:
        client.shutdown()
    acked, ready = run_child(path, seed)
    log(f"  child writer: its own recovery {json.dumps(ready)}")
    metric(card, "child writer: batches acknowledged before the SIGKILL", len(acked))
    out["recovery"] = recover_and_check(seed, path, acked, card)
    out["faults"] = fault_checks(seed, passes[0], card)
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    metric(card, "wall seconds", out["wall_s"])
    return out


# -- phase 16: serving, tracing and memory -----------------------------------


def sv_metric(card: str, what: str, value) -> None:
    """One phase-16 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 16 {what}: {value}")


def served_client(ingest: str = "segment", trace: dict = None, memstat: dict = None,
                  persist: str = "", faults: dict = None, **serve):
    """A card client with the serving layer, the tracer (default stride 128
    unless `trace` overrides; none for trace=False) and the memory
    section."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(ingest=ingest)
    cfg.use_serve(default_timeout_ms=SV_TIMEOUT_MS, **serve)
    if trace is not False:  # False: no tracer
        cfg.use_trace(**(trace or {}))
    cfg.use_memstat(**(memstat or {}))
    if persist:
        cfg.use_persist(persist, fsync="always", group_commit_runs=1)
    if faults:
        cfg.use_faults(**faults)
    return RedissonTorch.create(cfg)


def estimate_errors(counts, exact: int):
    errs = np.array([abs(c - exact) / exact for c in counts])
    return float(np.sqrt(np.mean(errs ** 2))), float(np.mean(errs > 0.02))


def served_hll(client, seed: int, card: str, ref) -> float:
    """1024 x 40,000 keys from SV_THREADS caller threads as SV_TENANTS
    tenants, each thread's PFADDs sent at once and each sent once. The
    rate-limited tenant's bucket admits at most SV_LIMITED_BURST +
    SV_LIMITED_RATE x elapsed keys, one batch more for slack, at any speed
    of host or card; the 10.24M keys it offers exceed that for any pass
    under 50 s, so it is shed. The others meet no gate (the queue bound is
    10,000 ops, 1024 are offered) and are never shed. After those checks
    the limited tenant's shed PFADDs are resent from the default (unlimited)
    tenant; then PFCOUNT of each sketch and PFMERGE + count over 1000, and
    the bank against the unserved sort client's. Returns the pass's served
    inserts/s (printed, never checked)."""
    import threading

    from redisson_tpu_torch.serve.errors import RejectedError

    _ref_res, ref_bank, ref_rows = ref
    names = [f"hll:{i}" for i in range(SKETCHES)]
    batches = [keys_for(i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
    tenants = [f"tenant-{t}" for t in range(SV_TENANTS)]
    sheds, admitted = dict.fromkeys(tenants, 0), dict.fromkeys(tenants, 0)
    offered = dict.fromkeys(tenants, 0)
    resend, lock, errors = [], threading.Lock(), []

    def caller(t: int) -> None:
        tenant = tenants[t % SV_TENANTS]
        try:
            with client.serve.tenant(tenant):
                futs = [(i, client.get_hyper_log_log(names[i]).add_ints_async(batches[i]))
                        for i in range(t, SKETCHES, SV_THREADS)]
            for i, f in futs:
                try:
                    if not f.result():
                        raise AssertionError(f"{names[i]}: first PFADD unchanged")
                    with lock:
                        admitted[tenant] += KEYS
                except RejectedError:
                    with lock:
                        sheds[tenant] += 1
                        resend.append(i)
            with lock:
                offered[tenant] += len(futs) * KEYS
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(SV_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    rate = sum(admitted.values()) / dt
    sv_metric(card, f"served PFADD, {SKETCHES} x {KEYS} keys from {SV_THREADS} threads "
              f"as {SV_TENANTS} tenants, admitted keys over the pass's wall, M inserts/s",
              rate / 1e6)
    adm = client.serve.snapshot()["admission"]
    sv_metric(card, "admission snapshot", json.dumps(adm))
    bound = SV_LIMITED_BURST + SV_LIMITED_RATE * dt + KEYS
    sv_metric(card, f"per tenant: offered keys, admitted keys, sheds ({SV_LIMITED} at "
              f"{SV_LIMITED_RATE} keys/s, burst {SV_LIMITED_BURST}; its bound over "
              f"{dt:.3f} s is {bound:.0f} keys)",
              json.dumps({t: [offered[t], admitted[t], sheds[t]] for t in tenants}))
    limited = sheds[SV_LIMITED]
    if admitted[SV_LIMITED] > bound:
        raise AssertionError(f"{SV_LIMITED} admitted {admitted[SV_LIMITED]} keys, past "
                             f"burst + rate x elapsed + one batch = {bound:.0f}")
    if offered[SV_LIMITED] > bound and not limited:
        raise AssertionError(f"{SV_LIMITED} offered {offered[SV_LIMITED]} keys, past its "
                             f"bound {bound:.0f}, and was never shed")
    if (any(sheds[t] for t in tenants if t != SV_LIMITED) or adm["shed_total"] != limited
            or adm["shed_by_reason"] != ({"tenant_rate": limited} if limited else {})):
        raise AssertionError(f"sheds {sheds}, admission {adm}")
    futs = [client.get_hyper_log_log(names[i]).add_ints_async(batches[i]) for i in resend]
    if not all(f.result() for f in futs):
        raise AssertionError("a resent first PFADD reported no change")
    counts = [client.get_hyper_log_log(n).count() for n in names]
    union = client.get_hyper_log_log("union:mc").merge_with_and_count(*names[:MERGE_N])
    rms, share = estimate_errors(counts, KEYS)
    merge_err = abs(union - EXACT_UNION) / EXACT_UNION
    log(f"  served estimates ({len(resend)} shed PFADDs resent): rms {rms:.5f}, "
        f"{share:.2%} above 0.02; union of {MERGE_N}: {union} (exact {EXACT_UNION}, "
        f"error {merge_err:.5f})")
    if rms >= 0.02 or share > MAX_SHARE_ABOVE_2PCT or merge_err >= 0.02:
        raise AssertionError("served estimate error past phase 3's limits")
    bank, rows = client.to_numpy_state()
    for n in names:
        if not np.array_equal(bank[rows[n]], ref_bank[ref_rows[n]]):
            raise AssertionError(f"served {n} differs from the unserved sort client")
    log(f"  served bank: all {SKETCHES} sketches equal to an unserved ingest=sort client")
    return rate


def timed_pass(client, names, batches) -> float:
    t0 = time.perf_counter()
    futs = [client.get_hyper_log_log(n).add_ints_async(b) for n, b in zip(names, batches)]
    [f.result() for f in futs]
    return len(names) * KEYS / (time.perf_counter() - t0)


def overheads(served, seed: int, card: str) -> dict:
    """PFADD inserts/s of SV_RATE_SKETCHES x 40,000 keys, SV_REPS warm
    passes each, in turns: a plain client (phase 4's), the same with the ledger's seams
    detached, a served client without the tracer, and the served client
    (serve + trace at stride 128 + ledger); beside each, the executor runs
    a pass takes. Where the served client's cost goes, by what each step
    adds; measured and printed, never checked."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    plain = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    bare = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    bare._store.accounting = None
    bare.sketch.accounting = None
    untraced = served_client(trace=False)
    clients = {"plain": plain, "ledger detached": bare, "served, no tracer": untraced,
               "served": served}
    names = [f"hll:{i}" for i in range(SV_RATE_SKETCHES)]
    got = {k: [] for k in clients}
    runs = {k: [] for k in clients}
    try:
        for rep in range(SV_REPS + 1):
            batches = [keys_for((rep + 8) * (1 << 36) + i * STRIDE, KEYS, seed)
                       for i in range(SV_RATE_SKETCHES)]
            for what, c in clients.items():
                r0 = c._executor.runs_dispatched()
                r = timed_pass(c, names, batches)
                if rep:  # rep 0 warms each client
                    got[what].append(r)
                    runs[what].append(c._executor.runs_dispatched() - r0)
    finally:
        plain.shutdown()
        bare.shutdown()
        untraced.shutdown()
    med = {k: median_spread(v) for k, v in got.items()}
    for k, v in got.items():
        sv_metric(card, f"PFADD {SV_RATE_SKETCHES} x {KEYS}, {k} client, M inserts/s "
                  "(median, min, max); executor runs per pass",
                  [[round(x / 1e6, 4) for x in med[k]], runs[k]])
    cost = {k: 100.0 * (1.0 - med[k][0] / med["plain"][0]) for k in clients}
    ledger_cost = 100.0 * (1.0 - med["plain"][0] / med["ledger detached"][0])
    sv_metric(card, "cost against the plain rate, % (JAX's budgets: < 1% for tracing, "
              "< 1% for the ledger)", json.dumps({k: round(v, 3) for k, v in cost.items()}))
    sv_metric(card, "ledger cost, % of the detached rate (JAX's budget < 1%)",
              round(ledger_cost, 3))
    return {"inserts_per_s": med, "runs_per_pass": runs, "cost_pct": cost,
            "ledger_cost_pct": ledger_cost}


def run_breakdown(seed: int, card: str) -> dict:
    """Where a served pass's time goes, and the trace's counts: a served
    client with every op traced (stride 1) takes a warm pass and a timed
    pass of the overhead workload. The timed pass leaves one op span per
    op and one run span per run dispatched, and the Chrome trace nests
    every op span in its run's span by run_id. From the run spans, each
    run's host staging (dispatched -> staged: the backend's staging, H2D
    and launches, on the dispatcher) and its completion wait (staged ->
    completed: the completer's event wait, behind the in-flight window),
    the runs and ops per run, beside the pass's wall and the adaptive
    policy's key cap for hll_add (printed)."""
    c = served_client(trace={"sample_every": 1, "ring": 1 << 14})
    names = [f"hll:{i}" for i in range(SKETCHES)]
    try:
        for rep in (0, 1):
            batches = [keys_for((rep + 16) * (1 << 36) + i * STRIDE, KEYS, seed)
                       for i in range(SKETCHES)]
            t_pass = c.trace.tracer.clock()
            runs0 = c._executor.runs_dispatched()
            rate = timed_pass(c, names, batches)
        wall = SKETCHES * KEYS / rate
        dispatched = c._executor.runs_dispatched() - runs0
        deadline = time.monotonic() + SV_WAIT_S
        while True:  # the completer retires a run just after its futures resolve
            ring = c.trace.tracer.ring()
            runs = [sp for sp in ring
                    if sp.span_type == "run" and sp.t0 >= t_pass and sp.t1 is not None]
            ops = [sp for sp in ring if sp.span_type == "op" and sp.kind == "hll_add"
                   and sp.t0 >= t_pass and sp.t1 is not None]
            if (len(runs) >= dispatched and len(ops) >= SKETCHES) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.01)
        sv_metric(card, "stride-1 pass: op spans / ops, run spans / runs dispatched",
                  [len(ops), SKETCHES, len(runs), dispatched])
        if len(ops) != SKETCHES or len(runs) != dispatched:
            raise AssertionError(f"{len(ops)} op spans of {SKETCHES} ops, {len(runs)} run "
                                 f"spans of {dispatched} runs")
        doc = json.loads(json.dumps(c.trace.chrome_trace()))
        run_ids = {e["args"]["span_id"] for e in doc["traceEvents"]
                   if e.get("cat") == "run" and e.get("ph") == "X"}
        pass_ids = {sp.span_id for sp in ops}
        op_events = [e for e in doc["traceEvents"] if e.get("cat") == "op"
                     and e.get("ph") == "X" and e["args"].get("span_id") in pass_ids]
        nested = [e for e in op_events if e["args"].get("run_id") in run_ids]
        sv_metric(card, "chrome trace of the pass: op spans, nested in a run span by run_id",
                  [len(op_events), len(nested)])
        if len(op_events) != SKETCHES or len(nested) != SKETCHES:
            raise AssertionError("the chrome trace does not nest every op span of the "
                                 f"pass in a run span: {len(nested)} of {len(op_events)}")
        # A run the completer retired before the dispatcher came back from
        # backend.run has no "staged" mark: its staging lasted to completion.
        done = [sp.first("completed") for sp in runs]
        staged = [sp.first("staged") for sp in runs]
        staged = [d if st is None else st for st, d in zip(staged, done)]
        stage = np.array([st - sp.t0 for st, sp in zip(staged, runs)])
        wait = np.array([d - st for d, st in zip(done, staged)])
        nops = np.array([sp.annotations["nops"] for sp in runs])
        ex = c._executor
        cap = ex.policy.batch_key_limit("hll_add", ex._max_batch_keys)
        out = {"runs": len(runs), "runs_dispatched": dispatched,
               "ops_per_run_median": float(np.median(nops)), "ops_per_run_max": int(nops.max()),
               "policy_key_cap": int(cap), "pass_wall_s": wall, "inserts_per_s": rate,
               "retired_before_staged": sum(sp.first("staged") is None for sp in runs),
               "staging_sum_s": float(stage.sum()), "wait_sum_s": float(wait.sum()),
               "staging_ms_p50_p99": [float(np.percentile(stage, q)) * 1e3 for q in (50, 99)],
               "wait_ms_p50_p99": [float(np.percentile(wait, q)) * 1e3 for q in (50, 99)],
               "learned_ns_per_key": c.serve.cost_model.s_per_key("hll_add") * 1e9,
               "stages": stage_quantiles(c)}
    finally:
        c.shutdown()
    sv_metric(card, "served pass traced at stride 1: runs, ops per run, policy cap, "
              "host staging and completion wait per run, stage p50/p99", json.dumps(out))
    return out


def stage_quantiles(client) -> dict:
    """p50 / p99 (ms) of each pipeline stage over the sampled op spans."""
    from redisson_tpu_torch.trace.hist import LatencyHistogram

    hists = {}
    for s in client.trace.tracer.ring():
        if s.span_type != "op" or s.t1 is None:
            continue
        for stage, d in s.stages().items():
            hists.setdefault(stage, LatencyHistogram()).record(d)
    return {k: {"n": h.count, "p50_ms": h.quantile(0.5) * 1e3,
                "p99_ms": h.quantile(0.99) * 1e3} for k, h in hists.items()}


def attribution(served, seed: int, card: str) -> dict:
    """The served run's stage quantiles (printed), then SLOWLOG under an
    injected 50 ms journal_fsync stall: the stalled PFADD's entry books at
    least the stall to its journal stage (the stall sleeps between the
    dispatched and journaled marks; which stage is the worst is not
    checked, since a host pause can land in any)."""
    import shutil

    q = stage_quantiles(served)
    sv_metric(card, "stage p50/p99 ms of the served run (sampled spans)", json.dumps(q))
    path = os.path.join(SV_DIR, "stall")
    shutil.rmtree(path, ignore_errors=True)
    plan = [{"seam": "journal_fsync", "fault": "stall", "nth": 2, "times": 2,
             "delay_s": SV_STALL_S}]
    c = served_client(persist=path, trace={"sample_every": 1, "slowlog_threshold_ms": 5.0},
                      faults={"plan": plan})
    try:
        from redisson_tpu_torch.fault import inject as fault_inject

        h = c.get_hyper_log_log("ts:stall")
        h.add_ints(keys_for(1 << 48, KEYS, seed))  # fsync 1: unstalled
        injected0 = fault_inject.installed().snapshot()["injected"]
        c.trace.slowlog.reset()
        h.add_ints(keys_for((1 << 48) + KEYS, KEYS, seed))  # fsync 2: stalled
        h.count()
        stalls = fault_inject.installed().snapshot()["injected"] - injected0
        # An op's span is finished (and its entry logged) by a done-callback
        # that may run just after the caller's result() returns: wait for it.
        deadline = time.monotonic() + SV_WAIT_S
        while True:
            entries = c.trace.slowlog.get()
            adds = [e for e in entries if e.kind == "hll_add"]
            journal_s = max((e.stages.get("journal", 0.0) for e in adds), default=0.0)
            if journal_s >= SV_STALL_S or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        for e in entries:
            log(f"  slowlog entry: {e.kind} {e.duration_s * 1e3:.3f} ms, worst "
                f"{e.worst_stage}: {json.dumps({k: v * 1e3 for k, v in e.stages.items()})}")
        if stalls != 1:
            raise AssertionError(f"{stalls} journal_fsync stalls fired in the window, not 1")
        stalled = max(adds, key=lambda e: e.stages.get("journal", 0.0), default=None)
        if stalled is None:
            raise AssertionError("the stalled PFADD never reached the slowlog")
        sv_metric(card, "SLOWLOG entry of the PFADD under a 50 ms journal_fsync stall",
                  json.dumps({"ms": stalled.duration_s * 1e3,
                              "worst_stage": stalled.worst_stage,
                              "stages_ms": {k: v * 1e3 for k, v in stalled.stages.items()}}))
        if journal_s < SV_STALL_S:
            raise AssertionError(f"journal stage {journal_s * 1e3:.3f} ms under a "
                                 f"{SV_STALL_S * 1e3:.0f} ms stall")
        fh = c.trace.fsync_hist.get("journal_fsync", "")
        sv_metric(card, "journal fsyncs, count and max ms", [fh.count, fh.max_s * 1e3])
        q_stall = stage_quantiles(c)
        sv_metric(card, "stage p50/p99 ms with the journal (sample_every=1)",
                  json.dumps(q_stall))
    finally:
        c.shutdown()
        shutil.rmtree(path, ignore_errors=True)
    return {"stages": q, "stages_journaled": q_stall, "journal_ms": journal_s * 1e3}


def settled_allocated() -> int:
    """torch.cuda.memory_allocated() once the card is idle and the caching
    allocator has freed every block whose last use it waits on by event (a
    tensor used on a second stream, as the staging copies are, stays counted
    after its free until the allocator processes that event; empty_cache
    does, and moves nothing else memory_allocated counts)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def allocated_blocks() -> dict:
    """address -> bytes of the caching allocator's allocated blocks."""
    import torch

    return {blk["address"]: blk["size"] for seg in torch.cuda.memory._snapshot()["segments"]
            for blk in seg["blocks"] if blk["state"] == "active_allocated"}


def block_slack(nbytes: int) -> int:
    """The most bytes the CUDA caching allocator's block for a tensor of
    `nbytes` can hold beyond them: the size rounds up to 512 bytes, and a
    free block is split only when more than 1 MiB would be left (large
    pool, rounded sizes over 1 MiB) or at least 512 bytes (small pool)."""
    rounded = -(-nbytes // 512) * 512
    return rounded - nbytes + (511 if rounded <= 1 << 20 else 1 << 20)


def memory_state(seed: int, card: str, ids) -> tuple:
    """The 64 MiB bank, BASELINE config 2's filter and 7 daily 2^27-bit
    bitmaps on one served client: the ledger against the tensors' nbytes
    and against the caching allocator's own counts over the window: the
    bytes requested equal the ledger, and every block made in the window
    and still held holds a ledger tensor, each block no larger than the
    allocator's rounding rule allows (`block_slack`). memory_allocated's
    growth is printed beside them: it depends on what the process freed
    before, since a cached free block is handed out whole when a split
    would leave too little."""
    import gc

    import torch

    def requested() -> int:
        settled_allocated()
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    gc.collect()
    alloc0, req0 = settled_allocated(), requested()
    before = set(allocated_blocks())
    c = served_client(memstat={"high_watermark_bytes": 1 << 50})
    futs = [c.get_hyper_log_log(f"hll:{i}").add_ints_async(keys_for(i * STRIDE, 1000, seed))
            for i in range(SKETCHES)]
    [f.result() for f in futs]
    bf = c.get_bloom_filter("bloom")
    if not bf.try_init(BLOOM_N, BLOOM_P):
        raise AssertionError("try_init of a fresh filter returned False")
    bf.add_ints(bloom_keys(0, BLOOM_BATCH, seed))
    for d in range(DAYS):
        c.get_bit_set(f"day:{d}").set_bits(np.append(ids[d], DAY_BITS - 1))
    gc.collect()
    grown, req = settled_allocated() - alloc0, requested() - req0
    blocks = allocated_blocks()
    v = c.memory_verify()
    owned = {int(c.sketch.bank.data_ptr()): int(c.sketch.bank.nbytes)}
    for n in c._store.live_nbytes():
        t = c._store.get(n).state
        owned[int(t.data_ptr())] = int(t.nbytes)
    # Blocks made in the window that hold no ledger tensor (address: bytes).
    unowned = {a: size for a, size in blocks.items() if a not in before and a not in owned}
    excess = {addr: blocks[addr] - nb for addr, nb in owned.items() if addr in blocks}
    tensors = sum(owned.values())
    live = c.memstat.live_bytes()
    sv_metric(card, "ledger live bytes, tensors' nbytes (live tensors), allocator bytes "
              "requested, memory_allocated growth, blocks' excess over their tensors",
              [live, tensors, len(owned), req, grown, sorted(excess.values())])
    stats = c.memory_stats()
    sv_metric(card, "memory_stats", json.dumps(
        {k: v for k, v in stats.items() if not k.startswith("by_")}))
    if not v["ok"] or v["drift_bytes"] or live != tensors:
        raise AssertionError(f"ledger drift: {v}, live {live}, tensors {tensors}")
    if req != live:
        raise AssertionError(f"the allocator's requested bytes grew {req}, the ledger "
                             f"holds {live}")
    loose = {a: (e, owned[a]) for a, e in excess.items()
             if not 0 <= e <= block_slack(owned[a])}
    if unowned or len(excess) != len(owned) or loose:
        raise AssertionError(f"memory_allocated grew {grown}: blocks held by no ledger "
                             f"tensor {unowned}, blocks' excess {excess}, beyond "
                             f"the rounding rule (excess, nbytes) {loose}")
    kinds = {"hll", "bloom", "bitset"}
    want_keys = set(MEM_STATS_KEYS) | {f"{k}.bytes" for k in kinds} | {"by_tenant", "by_slot"}
    if set(stats) != want_keys:
        raise AssertionError(f"memory_stats keys {sorted(set(stats) ^ want_keys)} differ "
                             "from the JAX package's")
    counted = bf.count()
    cards = [c.get_bit_set(f"day:{d}").cardinality() for d in range(DAYS)]
    log(f"  Bloom count() {counted}; day cardinalities {cards}")
    return c, {"ledger_bytes": live, "requested_growth": req, "allocated_growth": grown,
               "rounding": sum(excess.values())}


def churn(seed: int, card: str) -> int:
    """A seeded create / grow / delete / rename / flushall churn on a card
    client: memory_verify() clean after every step, zero bytes at the end."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    rng = np.random.default_rng(seed + 16)
    c = RedissonTorch.create(Config().use_cuda(ingest="segment"))
    try:
        names = [f"c:{i}" for i in range(12)]
        for step in range(SV_CHURN_STEPS):
            n = names[int(rng.integers(len(names)))]
            op = int(rng.integers(7))
            if op == 0:
                c.get_hyper_log_log("h" + n).add_ints(keys_for(step * 997, 500, seed))
            elif op == 1:
                c.get_bit_set("b" + n).set(int(rng.integers(1 << int(rng.integers(8, 22)))))
            elif op == 2:
                f = c.get_bloom_filter("f" + n)
                f.try_init(int(rng.integers(1000, 100000)), 0.01)
            elif op in (3, 4):
                c.delete(("h", "b", "f")[int(rng.integers(3))] + n)
            elif op == 5:
                src = ("h", "b", "f")[int(rng.integers(3))] + n
                dst = src[0] + names[int(rng.integers(len(names)))]
                try:
                    c._dispatch.execute_sync(src, "rename", {"newkey": dst})
                except KeyError:  # an absent source: nothing moves
                    pass
            elif step % 50 == 49:
                c.flushall()
            v = c.memory_verify()
            if not v["ok"]:
                raise AssertionError(f"churn step {step} (op {op}): {v}")
        c.flushall()
        end = c.memstat.live_bytes()
        if end != 0 or not c.memory_verify()["ok"]:
            raise AssertionError(f"churn ended at {end} ledger bytes")
    finally:
        c.shutdown()
    sv_metric(card, f"churn of {SV_CHURN_STEPS} steps: drift-free after each; "
              "ledger bytes at the end", 0)
    return SV_CHURN_STEPS


def watermark(c, card: str) -> None:
    """The memory gate on the card, driven by configured marks (JAX's rule:
    it sheds on the ledger's total alone). At the high watermark a SETBIT
    of a new bitmap is shed with RejectedError(reason="memory") before
    anything is allocated, and a concurrent PFCOUNT is served; a delete
    that leaves usage between the marks keeps the gate shedding
    (hysteresis); below the low watermark the SETBIT is admitted."""
    import threading

    from redisson_tpu_torch.serve.errors import RejectedError

    def shed(what: str, write) -> RejectedError:
        try:
            write()
        except RejectedError as exc:
            if exc.reason != "memory" or not exc.retry_after_s > 0:
                raise
            return exc
        raise AssertionError(f"{what} was admitted")

    p = c._pressure
    p.config.include_overhead = False
    small = c.get_bit_set("wm:small")
    small.set(1)  # 1024 cells
    live = c.memstat.live_bytes()
    p.config.high_watermark_bytes = live
    p.config.low_watermark_bytes = live - DAY_BITS // 2
    b = c.get_bit_set("day:new")
    before = settled_allocated()
    counted = []
    reader = threading.Thread(
        target=lambda: counted.append(c.get_hyper_log_log("hll:0").count()))
    reader.start()
    exc = shed("a SETBIT at the high watermark", lambda: b.set(DAY_BITS - 1))
    reader.join()
    after = settled_allocated()
    if after != before or not counted or not p.snapshot()["shedding"]:
        raise AssertionError(f"shed write allocated {after - before} bytes; PFCOUNT "
                             f"served: {counted}; shedding {p.snapshot()['shedding']}")
    small.delete()  # below the high mark, above the low one: still shedding
    if not p.config.low_watermark_bytes <= c.memstat.live_bytes() < live:
        raise AssertionError("the first delete did not land between the marks")
    shed("a SETBIT between the watermarks, in hysteresis", lambda: b.set(DAY_BITS - 1))
    c.get_bit_set("day:0").delete()  # below the low mark
    if c.memstat.live_bytes() >= p.config.low_watermark_bytes:
        raise AssertionError("the deletes did not bring usage below the low watermark")
    b.set(DAY_BITS - 1)
    if p.snapshot()["shedding"] or not c.memory_verify()["ok"]:
        raise AssertionError("still shedding, or ledger drift, after the admitted write")
    p.config.high_watermark_bytes = 1 << 50
    device = p.snapshot()["device"]
    sv_metric(card, "pressure snapshot: the device's memory", json.dumps(device))
    if device["source"] != "torch.cuda" or not 0 < device["free_bytes"] <= device["total_bytes"]:
        raise AssertionError(f"the pressure snapshot's device memory: {device}")
    sv_metric(card, "watermark: SETBIT shed at the high mark (retry_after_s, bytes "
              "allocated), PFCOUNT beside it; shed between the marks, admitted below "
              "the low mark", [exc.retry_after_s, after - before, counted[0], "shed",
                               "ok"])


def served_faults(served, seed: int, card: str) -> dict:
    """A retryable kernel_launch fault, twice, absorbed by the serve retry;
    a state-uncertain d2h_complete fault opening the kind's breaker, closed
    by the rebuild; the learned cost model and the watchdog deadline."""
    import shutil

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config, FaultConfig
    from redisson_tpu_torch.fault.taxonomy import StateUncertainFault
    from redisson_tpu_torch.fault.watchdog import RunWatchdog
    path = os.path.join(SV_DIR, "faults")
    shutil.rmtree(path, ignore_errors=True)
    plan = [{"seam": "kernel_launch", "fault": "retryable", "nth": 1, "times": 2,
             "kind": "hll_add", "target": "f:retry"},
            {"seam": "d2h_complete", "fault": "state_uncertain", "nth": 1,
             "kind": "hll_count", "target": "f:u"}]
    c = served_client(persist=path, faults={"plan": plan})
    oracle = RedissonTorch.create(Config().use_cuda(ingest="sort"))
    keys = keys_for(1 << 49, KEYS, seed)
    try:
        if not c.get_hyper_log_log("f:retry").add_ints(keys):
            raise AssertionError("the retried PFADD reported no change")
        oracle.get_hyper_log_log("f:retry").add_ints(keys)
        retries = c.metrics.counter("serve.retries_total")
        got = c._executor.execute_sync("f:retry", "hll_export", None)[0]
        want = oracle._executor.execute_sync("f:retry", "hll_export", None)[0]
        if retries < 2 or not np.array_equal(got, want):
            raise AssertionError(f"retries {retries}; row equal: {np.array_equal(got, want)}")
        u = c.get_hyper_log_log("f:u")
        u.add_ints(keys)
        before = c._executor.execute_sync("f:u", "hll_export", None)[0]
        try:
            u.count()
            raise AssertionError("the injected d2h_complete fault did not fire")
        except StateUncertainFault:
            pass
        # The fault opens hll_count's breaker and starts the rebuild, which
        # closes it: both are waited for (polled up to SV_WAIT_S, at least
        # 10x the breaker's reset interval), never slept for. opens_total
        # counts the opening however soon the rebuild closes the breaker.
        breaker = c.serve._breakers.get("hll_count")
        interval = c.serve._cfg.breaker_reset_timeout_ms / 1e3
        if SV_WAIT_S < 10 * interval:
            raise AssertionError(f"wait {SV_WAIT_S} s under 10x the interval {interval} s")
        t_fault = time.monotonic()
        deadline = t_fault + SV_WAIT_S
        while breaker.snapshot()["opens_total"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        opened = breaker.snapshot()["opens_total"]
        settled = c.fault.rebuild.wait_idle(timeout=max(0.0, deadline - time.monotonic()))
        while breaker.state != "closed" and time.monotonic() < deadline:
            time.sleep(0.005)
        state = breaker.snapshot()
        rebuild = c.fault.rebuild.snapshot()
        if opened < 1 or not settled or state["state"] != "closed":
            raise AssertionError(f"breaker opened {opened} times, rebuild settled {settled}, "
                                 f"breaker {state}, rebuild {rebuild}")
        if rebuild["rebuilt_total"] < 1 or rebuild["rebuild_failures"]:
            raise AssertionError(f"rebuild {rebuild}")
        after = c._executor.execute_sync("f:u", "hll_export", None)[0]
        if not np.array_equal(after, before):
            raise AssertionError("the rebuilt row differs from the pre-fault row")
        n = u.count()
        log(f"  faults under serve: kernel_launch x2 absorbed ({retries:.0f} retries, row "
            f"equal to the oracle's); d2h_complete -> breaker opened ({opened}x) -> "
            f"rebuild -> breaker {state['state']} after "
            f"{time.monotonic() - t_fault:.3f} s (waits polled, up to {SV_WAIT_S:.0f} s), "
            f"row as before, PFCOUNT {n}")
    finally:
        c.shutdown()
        oracle.shutdown()
        shutil.rmtree(path, ignore_errors=True)
    cm = served.serve.cost_model
    snap = cm.snapshot()
    fc = FaultConfig()
    wd = RunWatchdog(served._executor, estimate=cm.estimate, margin=fc.watchdog_margin,
                     floor_s=fc.watchdog_floor_s)
    deadline = wd.deadline_s("hll_add", KEYS)
    sv_metric(card, "learned cost model: s_per_key per kind", json.dumps(snap["s_per_key"]))
    sv_metric(card, "learned cost model: overhead_s per kind", json.dumps(snap["overhead_s"]))
    sv_metric(card, f"learned estimate of a {KEYS}-key PFADD (s)", cm.estimate("hll_add", KEYS))
    sv_metric(card, f"watchdog deadline for a {KEYS}-key PFADD (s; margin "
              f"{fc.watchdog_margin}, floor {fc.watchdog_floor_s})", deadline)
    return {"cost_model": snap, "watchdog_deadline_s": deadline}


def item2_checks(served, mem, seed: int, card: str, ids) -> dict:
    """The ops and engine functions of this slice on the card: xxhash64 of
    an 8M-key batch against the CPU, bitpos on the 7 bitmaps against numpy,
    count_estimate of the filter against numpy's float32 formula, and a
    PFADD with the (hi, lo) payload under segment against add_ints.
    Returns the kernel launches it made outside the served path."""
    import torch
    from redisson_tpu_torch.ingest import kernels as ik
    from redisson_tpu_torch.ops import bitset, bloom, hashing
    from redisson_tpu_torch.ops import kernels as ok

    keys = keys_for(0, SV_XXH_KEYS, seed)
    data = torch.from_numpy(keys.view(np.uint8).reshape(-1, 8).copy())
    lengths = torch.full((SV_XXH_KEYS,), 8, dtype=torch.int32)
    t0 = time.perf_counter()
    on_card = hashing.xxhash64(data.cuda(), lengths.cuda()).cpu()
    t1 = time.perf_counter()
    on_cpu = hashing.xxhash64(data, lengths)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("xxhash64 on the card differs from the CPU")
    log(f"  xxhash64 of {SV_XXH_KEYS} 8-byte keys: card equals CPU "
        f"(card {t1 - t0:.3f} s with copies, CPU {time.perf_counter() - t1:.3f} s)")
    for d in range(1, DAYS):  # day:0 went in the watermark check
        cells = mem._store.get(f"day:{d}").state
        host = np.zeros(cells.shape[0], bool)
        host[ids[d]] = True
        host[DAY_BITS - 1] = True
        for value in (0, 1):
            hit = np.flatnonzero(host == bool(value))
            want = int(hit[0]) if hit.size else -1
            got = bitset.bitpos(cells, value)
            if got != want:
                raise AssertionError(f"bitpos(day:{d}, {value}) = {got}, numpy {want}")
    log(f"  bitpos(0 / 1) of days 1-{DAYS - 1} equal to numpy's")
    bits = mem._store.get("bloom").state
    n0 = ok.launches["popcount_partials"]
    bc = ok.popcount_partials(bits).to(torch.int64).sum()
    direct = ok.launches["popcount_partials"] - n0  # not a served-path launch
    est = float(bloom.count_estimate(bc, BLOOM_M, BLOOM_K))
    x = np.float32(int(bc))
    frac = np.clip(x / np.float32(BLOOM_M), np.float32(0), np.float32(1 - 1e-7))
    want = float(np.float32(-(BLOOM_M / BLOOM_K)) * np.log1p(-frac))
    if abs(est - want) > 1e-6 * abs(want):
        raise AssertionError(f"count_estimate {est}, numpy float32 {want}")
    log(f"  count_estimate of the filter ({int(bc)} bits set): {est} (numpy {want})")
    # The (hi, lo) payload: the 1024 x 40,000 keys of served_hll, as two
    # uint32 halves, into fresh sketches; the bank rows must equal the rows
    # the packed PFADDs of the same keys left.
    before = ik.launches["seg_insert"]
    futs = []
    for i in range(SKETCHES):
        k = keys_for(i * STRIDE, KEYS, seed)
        futs.append(served.serve.execute_async(f"hilo:{i}", "hll_add", {
            "hi": (k >> np.uint64(32)).astype(np.uint32),
            "lo": (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)}, KEYS))
    if not all(f.result() for f in futs):
        raise AssertionError("a first (hi, lo) PFADD reported no change")
    torch.cuda.synchronize()
    launched = ik.launches["seg_insert"] - before
    bank, rows = served.to_numpy_state()
    same = sum(np.array_equal(bank[rows[f"hilo:{i}"]], bank[rows[f"hll:{i}"]])
               for i in range(SKETCHES))
    if not launched or same != SKETCHES:
        raise AssertionError(f"hi/lo PFADD: seg_insert launches {launched}, {same} of "
                             f"{SKETCHES} rows equal to the packed PFADD's")
    log(f"  (hi, lo) PFADD of {SKETCHES} x {KEYS} keys under segment: all {SKETCHES} rows "
        f"equal to the packed PFADD's, {launched} seg_insert launch(es)")
    return {"popcount_partials": direct}


def serve_path(seed: int, card: str, ref):
    """Phase 16 on served clients; returns (launches, served client, numbers).
    The served client stays open for the profiler check after the
    device-only times."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(SV_DIR, ignore_errors=True)
    os.makedirs(SV_DIR)
    ids = [d[:SV_BITS_PER_DAY] for d in day_ids(seed)]
    log(f"phase 16 on {card}:")
    served = served_client(tenant_rates={SV_LIMITED: SV_LIMITED_RATE},
                           tenant_bursts={SV_LIMITED: SV_LIMITED_BURST})
    out, steps = {}, {}

    def step(name: str, fn):
        t = time.perf_counter()
        got = fn()
        steps[name] = round(time.perf_counter() - t, 3)
        return got

    try:
        reset_all_launches()
        out["served_inserts_per_s"] = step("served", lambda: served_hll(served, seed, card,
                                                                        ref))
        mem, out["memory"] = step("memory", lambda: memory_state(seed, card, ids))
        try:
            step("watermark", lambda: watermark(mem, card))
            direct = step("item 2", lambda: item2_checks(served, mem, seed, card, ids))
        finally:
            mem.shutdown()
        out["faults"] = step("faults", lambda: served_faults(served, seed, card))
        launches = all_launches()
        for k, n in direct.items():
            launches[k] -= n
        for k in ("seg_insert", "merge_stack", "bits_insert_segmented",
                  "popcount_partials"):
            if not launches.get(k):
                raise AssertionError(f"phase 16 never launched {k}: {launches}")
        log(f"  phase 16 launches: {json.dumps(launches)}")
        out["overheads"] = step("overheads", lambda: overheads(served, seed, card))
        out["attribution"] = step("slowlog", lambda: attribution(served, seed, card))
        out["runs"] = step("stride-1 pass", lambda: run_breakdown(seed, card))
        out["churn_steps"] = step("churn", lambda: churn(seed, card))
        if not served.get_nodes_group().ping_all():
            raise AssertionError("get_nodes_group().ping_all() is False on the card")
    except BaseException:
        served.shutdown()
        raise
    shutil.rmtree(SV_DIR, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    sv_metric(card, "seconds by step", json.dumps(steps))
    sv_metric(card, "wall seconds", out["wall_s"])
    return launches, served, out


def serve_profile(served, seed: int, card: str) -> None:
    """profile(logdir) around 10 served PFADDs: the trace names seg_insert's
    kernel (taken after every host-timed phase)."""
    import shutil

    from redisson_tpu_torch.observability import profile

    shutil.rmtree(SV_PROFILE_DIR, ignore_errors=True)
    h = served.get_hyper_log_log("prof:0")
    with profile(SV_PROFILE_DIR):
        for i in range(10):
            h.add_ints(keys_for((1 << 51) + i * KEYS, KEYS, seed))
    path = os.path.join(SV_PROFILE_DIR, "trace.json")
    if not os.path.exists(path):
        raise AssertionError("profile() wrote no trace")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    seg = sorted(n for n in names if "seg_" in n and "_kernel" in n)
    shutil.rmtree(SV_PROFILE_DIR, ignore_errors=True)
    sv_metric(card, "profile(): seg_insert kernels named in the trace", seg)
    if not seg:
        raise AssertionError("the profile() trace names no seg_insert kernel")


# -- phase 19: the read-replica tier -----------------------------------------


def rp_metric(card: str, what: str, value) -> None:
    """One phase-19 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 19 {what}: {value}")


def wait_state(what: str, pred, timeout_s: float = RP_WAIT_S) -> None:
    """Poll `pred` until it holds; fail only after `timeout_s`."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"no {what} within {timeout_s} s")
        time.sleep(0.005)


def card_config(ingest: str = "segment"):
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(ingest=ingest)
    return cfg


def rp_day(seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 19).integers(0, DAY_BITS, DAY_SETS)


def rp_write(client, seed: int) -> int:
    """The data set of steps 1 and 2: 1024 x 40,000 HLL keys, BASELINE
    config 2's Bloom filter with 10M adds, one 2^27-bit day with 8M
    SETBITs, all acknowledged -> keys written."""
    futs = [client.get_hyper_log_log(f"hll:{i}").add_ints_async(
        keys_for(i * STRIDE, KEYS, seed)) for i in range(SKETCHES)]
    [f.result() for f in futs]
    bloom_fill(client, "bloom", seed)
    client.get_bit_set("day:0").set_bits(rp_day(seed))
    return SKETCHES * KEYS + BLOOM_KEYS + DAY_SETS


def rp_state(client):
    """(bank, rows, objects) of a client, read after a synchronize."""
    import torch

    torch.cuda.synchronize()
    bank, rows = client.to_numpy_state()
    return bank, rows, client.to_numpy_objects()


def same_state(got, want, what: str) -> None:
    bank, rows, objects = got
    wbank, wrows, wobjects = want
    if set(rows) != set(wrows) or any(not np.array_equal(bank[r], wbank[wrows[n]])
                                      for n, r in rows.items()):
        raise AssertionError(f"{what}: HLL registers differ")
    same_objects(objects, wobjects, what)


def on_card(client) -> bool:
    """Every state tensor of the client (the bank, each BitSet and Bloom) is
    on the card."""
    tensors = [client.sketch.bank] + [client._store.get(n).state
                                      for n in client._store.keys()]
    return all(t is not None and t.is_cuda for t in tensors)


def follower_replay(seed: int, card: str) -> dict:
    """Step 1: a persisting primary writes the data set and shuts down; a
    standalone JournalFollower on the card replays its journal. Only the
    follower launches kernels in this window."""
    from redisson_tpu_torch.persist.follower import JournalFollower

    path = os.path.join(RP_DIR, "leader")
    primary = persist_client(path)
    try:
        nkeys = rp_write(primary, seed)
        want = rp_state(primary)
        last = primary.persist.journal.last_seq
    finally:
        primary.shutdown()
    reset_all_launches()
    t0 = time.perf_counter()
    follower = JournalFollower(path, config=card_config(), poll_interval_s=0.005)
    try:
        follower.start()
        max_lag = [0]

        def caught_up() -> bool:
            max_lag[0] = max(max_lag[0], follower.lag())
            return follower.applied_seq >= last

        wait_state("follower catch-up to the journal's last seq", caught_up)
        catch_up = time.perf_counter() - t0
        launches = all_launches()
        got = rp_state(follower.client)
        stats = follower.stats()
        lag, card_state = follower.lag(), on_card(follower.client)
    finally:
        follower.close()
    rp_metric(card, "follower: records replayed", stats["records_applied"])
    rp_metric(card, "follower: catch-up seconds (create, bootstrap, replay)", catch_up)
    rp_metric(card, "follower: replay keys/s", nkeys / catch_up)
    rp_metric(card, "follower: max lag (records) seen while catching up", max_lag[0])
    rp_metric(card, "follower: kernel launches", json.dumps(launches))
    if stats["apply_errors"]:
        raise AssertionError(f"follower apply errors: {stats}")
    for name in ("seg_insert", "bits_insert_segmented"):
        if not launches[name]:
            raise AssertionError(f"the follower's replay never launched {name}: {launches}")
    if lag != 0:
        raise AssertionError(f"follower lag {lag} after catch-up")
    if not card_state:
        raise AssertionError("a follower state tensor is not on the card")
    same_state(got, want, "follower")
    log(f"  follower: {stats['records_applied']} records replayed on the card; bank, "
        "Bloom cells and bitmap equal the primary's bit for bit; lag 0")
    return {"launches": launches, "catch_up_s": catch_up, "keys_per_s": nkeys / catch_up,
            "max_lag": max_lag[0]}


def primary_view(c):
    """The client's HLL, Bloom and BitSet models bound to the primary's own
    executor (the router never sees their ops)."""
    from redisson_tpu_torch.models.bitset import RBitSet
    from redisson_tpu_torch.models.bloomfilter import RBloomFilter
    from redisson_tpu_torch.models.hyperloglog import RHyperLogLog

    ex = c._executor
    return (lambda n: RHyperLogLog(n, ex, c._codec, c._widths),
            lambda n: RBloomFilter(n, ex, c._codec, c._widths),
            lambda n: RBitSet(n, ex, c._codec, c._widths))


def fleet_client(path: str, ingest: str = "segment"):
    from redisson_tpu_torch.client import RedissonTorch

    cfg = card_config(ingest)
    cfg.use_persist(path, fsync="always")
    cfg.use_replicas(2, auto_failover=False, health_interval_s=0.0,
                     poll_interval_s=0.005, max_lag_seqs=RP_MAX_LAG)
    return RedissonTorch.create(cfg)


def fleet_reads(c, seed: int, card: str) -> dict:
    """With no write in flight: PFCOUNT of every sketch, countWith over
    1000, contains of 1M Bloom keys and BITCOUNT, routed; each answer equal
    to the primary executor's; the kernels they launched."""
    router = c._dispatch
    hll, bloom, bits = primary_view(c)
    names = [f"hll:{i}" for i in range(SKETCHES)]
    probe = bloom_keys(0, BLOOM_CONTAINS, seed)  # the first 1M keys added
    reads0, fb0 = router.replica_reads, router.primary_fallbacks
    reset_all_launches()
    counts = [c.get_hyper_log_log(n).count() for n in names]
    cw = c.get_hyper_log_log(names[0]).count_with(*names[1:MERGE_N])
    contains = c.get_bloom_filter("bloom").contains_ints(probe)
    bitcount = c.get_bit_set("day:0").cardinality()
    launches = all_launches()
    served, fallbacks = router.replica_reads - reads0, router.primary_fallbacks - fb0
    per_replica = {r.name: r.reads_served for r in c.replicas.replicas}
    rp_metric(card, "fleet reads: kernel launches (replica reads only)",
              json.dumps(launches))
    rp_metric(card, "fleet reads: served per replica", json.dumps(per_replica))
    if served < SKETCHES + 3 or fallbacks:
        raise AssertionError(f"{served} reads served by replicas, {fallbacks} fell back")
    for name in ("merge_stack", "popcount_partials"):
        if not launches[name]:
            raise AssertionError(f"replica reads never launched {name}: {launches}")
    if counts != [hll(n).count() for n in names]:
        raise AssertionError("a replica's PFCOUNT differs from the primary's")
    if cw != hll(names[0]).count_with(*names[1:MERGE_N]):
        raise AssertionError("a replica's countWith differs from the primary's")
    if not np.array_equal(contains, bloom("bloom").contains_ints(probe)) or not contains.all():
        raise AssertionError("a replica's Bloom contains differs from the primary's")
    if bitcount != bits("day:0").cardinality():
        raise AssertionError("a replica's BITCOUNT differs from the primary's")
    log(f"  fleet reads: {served} served by replicas, each equal to the primary "
        f"executor's (countWith over {MERGE_N}: {cw}, BITCOUNT {bitcount})")
    return {"launches": launches, "per_replica": per_replica}


def fleet_freeze(c, seed: int, card: str) -> None:
    """A replica whose tail is stopped falls outside max_lag_seqs and is
    never picked; with both stopped, reads fall back to the primary; a
    tenant's read after its own write is pinned at or above its acked seq."""
    router, journal = c._dispatch, c.persist.journal
    hll = primary_view(c)[0]
    frozen, live = c.replicas.replicas
    frozen._stop.set()  # as the JAX corpus does: the tail loop ends
    frozen._thread.join(RP_WAIT_S)
    mark = frozen.applied_seq
    for i in range(RP_FREEZE_WRITES):
        c.get_hyper_log_log(f"lag:{i % 8}").add_ints(
            keys_for((1 << 44) + i * RP_FREEZE_KEYS, RP_FREEZE_KEYS, seed))
    if journal.last_seq - mark <= RP_MAX_LAG:
        raise AssertionError("the frozen replica is still inside max_lag_seqs")
    wait_state("the live replica's catch-up", lambda: live.applied_seq >= journal.last_seq)
    picks = [router.routed_read(f"lag:{i}", "hll_count", None) for i in range(8)]
    if any(rep is frozen for _, rep, _ in picks):
        raise AssertionError("a replica outside max_lag_seqs served a read")
    live._stop.set()
    live._thread.join(RP_WAIT_S)
    fb0 = router.primary_fallbacks
    for i in range(8):
        c.get_hyper_log_log(f"lag:{i}").add_ints(
            keys_for((1 << 45) + i * RP_FREEZE_KEYS, RP_FREEZE_KEYS, seed))
    got = [c.get_hyper_log_log(f"lag:{i}").count() for i in range(8)]
    fallbacks = router.primary_fallbacks - fb0
    if fallbacks < 8 or got != [hll(f"lag:{i}").count() for i in range(8)]:
        raise AssertionError(f"stale replicas: {fallbacks} fallbacks, counts {got}")
    for rep in (frozen, live):
        rep.retarget(rep.path)  # the same journal: a partial resync, tail restarted
    wait_state("both replicas' catch-up after the freeze",
               lambda: c.replicas.min_watermark() >= journal.last_seq)
    c.get_hyper_log_log("ryw").add_ints(keys_for(1 << 46, KEYS, seed))
    seq = journal.last_seq
    acked = router.acked_seq("")
    fut, rep, watermark = router.routed_read("ryw", "hll_count", None)
    if acked < seq or (rep is not None and watermark < acked):
        raise AssertionError(f"read-your-writes: acked {acked}, write {seq}, read at "
                             f"{watermark} on {rep and rep.name}")
    if fut.result() != hll("ryw").count():
        raise AssertionError("the pinned read differs from the primary's")
    rp_metric(card, "freeze: primary fallbacks with both tails stopped", fallbacks)
    log(f"  freeze: the frozen replica (watermark {mark}, primary at {journal.last_seq}) "
        f"never served; {fallbacks} reads fell back; the pinned read after a write "
        f"(acked {acked}) was served by {rep.name if rep else 'the primary'}")


def fleet_path(seed: int, card: str) -> dict:
    """Step 2: a client with two replicas on the same card takes the data
    set; the replicas catch up to the same state; routed reads."""
    path = os.path.join(RP_DIR, "fleet")
    c = fleet_client(path)
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        nkeys = rp_write(c, seed)
        last = c.persist.journal.last_seq
        max_lag = [0]

        def caught_up() -> bool:
            max_lag[0] = max(max_lag[0], c.replicas.max_lag())
            return c.replicas.min_watermark() >= last

        wait_state("fleet catch-up", caught_up)
        catch_up = time.perf_counter() - t0
        if c.wait_for_replicas(2, timeout_s=RP_WAIT_S) != 2:
            raise AssertionError("wait_for_replicas(2) did not return 2")
        replay = all_launches()
        want = rp_state(c)
        for rep in c.replicas.replicas:
            if not on_card(rep.client):
                raise AssertionError(f"a state tensor of {rep.name} is not on the card")
            same_state(rp_state(rep.client), want, rep.name)
        rp_metric(card, "fleet: write + catch-up seconds", catch_up)
        rp_metric(card, "fleet: replay keys/s (per replica, both in step)", nkeys / catch_up)
        rp_metric(card, "fleet: max lag (records) seen while catching up", max_lag[0])
        rp_metric(card, "fleet: kernel launches (primary and both replicas)",
                  json.dumps(replay))
        log("  fleet: wait_for_replicas(2) = 2; both replicas' bank, Bloom cells and "
            "bitmap equal the primary's bit for bit")
        reads = fleet_reads(c, seed, card)
        fleet_freeze(c, seed, card)
    finally:
        c.shutdown()
    return {"replay_launches": replay, "read_launches": reads["launches"],
            "catch_up_s": catch_up, "keys_per_s": nkeys / catch_up, "max_lag": max_lag[0],
            "per_replica": reads["per_replica"]}


def failover_drill(card: str) -> dict:
    """Step 3, on config 3's 256 x 40,000 state: fence, promote, retarget,
    continue; every acknowledged PFADD is in the new primary."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.persist.journal import iter_records

    path = os.path.join(RP_DIR, "failover")
    c = fleet_client(path)
    acked = []  # (name, keys) of every acknowledged PFADD
    try:
        names = [f"b3:{i}" for i in range(B3_SKETCHES)]
        keys = b3_keys()
        futs = [c.get_hyper_log_log(n).add_ints_async(k) for n, k in zip(names, keys)]
        [f.result() for f in futs]
        acked += list(zip(names, keys))
        if c.wait_for_replicas(2, timeout_s=RP_WAIT_S) != 2:
            raise AssertionError("wait_for_replicas(2) did not return 2 before the failover")
        mgr, old = c.replicas, c.persist.journal
        promoted = mgr.failover("phase 19 drill")
        if promoted is None or not old.fenced:
            raise AssertionError("failover() did not promote a replica behind a fence")
        fence = mgr.last_fence_seq
        probe = keys_for(1 << 47, 8, 0).view(np.uint32).reshape(-1, 2)
        try:
            c._executor.execute_sync("fenced:probe", "hll_add", {"packed": probe}, 8)
        except Exception as exc:  # the executor classifies the journal's refusal
            if "fenced" not in str(exc):
                raise
        else:
            raise AssertionError("a write on the fenced primary was acknowledged")
        if old.last_seq != fence or mgr._promoted.applied_seq != fence:
            raise AssertionError(f"fence {fence}: old journal at {old.last_seq}, "
                                 f"promotee at {mgr._promoted.applied_seq}")
        same_state(rp_state(promoted), rp_state(c), "promotee at the fence seq")
        snap_bytes = promoted.persist.snapshotter.disk_bytes()
        survivor = mgr.replicas[0]
        resyncs = survivor._partial_resyncs + survivor._full_resyncs
        post = [(f"b3:{i}", keys_for((1 << 48) + i * KEYS, KEYS, 0))
                for i in range(RP_POST_BATCHES)]
        for n, k in post:
            c.get_hyper_log_log(n).add_ints(k)  # through the router: the promotee
        acked += post
        new_journal = promoted.persist.journal
        first = next(iter_records(new_journal.path)).seq
        if first != fence + 1 or new_journal.last_seq != fence + RP_POST_BATCHES:
            raise AssertionError(f"the new journal starts at {first}, ends at "
                                 f"{new_journal.last_seq}; the fence was {fence}")
        if c.wait_for_replicas(1, timeout_s=RP_WAIT_S) != 1:
            raise AssertionError("the surviving replica did not catch up")
        if resyncs < 2:
            raise AssertionError("the survivor's retarget counted no resync")
        now = rp_state(promoted)
        same_state(rp_state(survivor.client), now, "survivor after the failover")
        oracle = RedissonTorch.create(card_config("sort"))
        try:
            for n, k in acked:
                oracle.get_hyper_log_log(n).add_ints(k)
            want = rp_state(oracle)
        finally:
            oracle.shutdown()
        same_state(now, want, "new primary vs a sort oracle fed the acknowledged PFADDs")
        seconds = mgr.last_failover_s
    finally:
        c.shutdown()
    rp_metric(card, "failover: seconds (fence, promote, snapshot, retarget)", seconds)
    rp_metric(card, "failover: the promotee's snapshot bytes on disk", snap_bytes)
    log(f"  failover: fenced at seq {fence}, the fenced write refused; the promotee "
        f"equal to the old primary; its journal continues at {fence + 1}; the survivor "
        f"resynced ({survivor._partial_resyncs} partial, {survivor._full_resyncs} full) "
        f"and caught up; all {len(acked)} acknowledged PFADDs present (sort oracle)")
    return {"seconds": seconds, "snapshot_bytes": snap_bytes}


def facades_on_card(seed: int, card: str) -> dict:
    """Step 4: create_reactive on the card; an async lock between two tasks;
    an RRemoteService round trip and a CacheManager on the card client."""
    import asyncio

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.reactive import create_reactive

    batches = [keys_for((1 << 49) + i * KEYS, KEYS, seed) for i in range(RP_RX_SKETCHES)]
    names = [f"rx:{i}" for i in range(RP_RX_SKETCHES)]
    rx = create_reactive(card_config())
    try:
        async def hll():
            hs = [rx.get_hyper_log_log(n) for n in names]
            await asyncio.gather(*(h.add_ints(b) for h, b in zip(hs, batches)))
            return await asyncio.gather(*(h.count() for h in hs))

        async def lock():
            lk, inside, most = rx.get_lock("rx:lock"), [], [0]

            async def critical(tag):
                async with lk:
                    inside.append(tag)
                    most[0] = max(most[0], len(inside))
                    await asyncio.sleep(0.01)
                    inside.remove(tag)

            await asyncio.gather(critical("a"), critical("b"))
            return most[0], await lk.is_locked()

        reset_all_launches()
        counts = asyncio.run(hll())
        launches = all_launches()
        state = rp_state(rx.sync)
        most, locked = asyncio.run(lock())
        ref = RedissonTorch.create(card_config())
        try:
            for n, b in zip(names, batches):
                ref.get_hyper_log_log(n).add_ints(b)
            want = rp_state(ref)
            ref_counts = [ref.get_hyper_log_log(n).count() for n in names]
        finally:
            ref.shutdown()
        same_state(state, want, "reactive PFADDs vs the sync client's")
        if counts != ref_counts or not launches["seg_insert"]:
            raise AssertionError(f"reactive counts {counts} vs {ref_counts}, "
                                 f"launches {launches}")
        if most != 1 or locked:
            raise AssertionError("the async lock let two tasks in, or stayed locked")
        c = rx.sync
        rs = c.get_remote_service("phase19")

        class Adder:
            def add(self, a, b):
                return a + b

        rs.register("Adder", Adder())
        if rs.get("Adder").add(20, 22) != 42:
            raise AssertionError("the remote service round trip failed")
        cache = c.get_cache_manager({"ttl": {"ttl_s": RP_CACHE_TTL_S}}).get_cache("ttl")
        cache.put("k", {"v": 1})
        if cache.get("k") != {"v": 1}:
            raise AssertionError("the cache manager lost a put")
        wait_state("the TTL'd cache entry's expiry", lambda: cache.get("k") is None)
    finally:
        rx.sync.shutdown()
    rp_metric(card, "reactive: kernel launches of the 8 awaited PFADDs + PFCOUNTs",
              json.dumps(launches))
    log(f"  facades: {RP_RX_SKETCHES} awaited PFADDs' rows equal the sync client's; the "
        "async lock admitted one task at a time; RRemoteService 20 + 22 = 42; the "
        "cache entry expired")
    return {"launches": launches}


def replica_path(seed: int, card: str) -> dict:
    """Phase 19: the journal follower, the fleet, the failover drill and the
    facades, each resetting the launch counters just before it."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(RP_DIR, ignore_errors=True)
    os.makedirs(RP_DIR)
    log(f"phase 19 on {card}:")
    steps, out = {}, {}
    for name, fn in (("follower", lambda: follower_replay(seed, card)),
                     ("fleet", lambda: fleet_path(seed, card)),
                     ("failover", lambda: failover_drill(card)),
                     ("facades", lambda: facades_on_card(seed, card))):
        t = time.perf_counter()
        out[name] = fn()
        steps[name] = round(time.perf_counter() - t, 3)
    shutil.rmtree(RP_DIR, ignore_errors=True)
    launches = {}
    for d in (out["follower"]["launches"], out["fleet"]["read_launches"],
              out["facades"]["launches"]):
        launches = add_launches(launches, d)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    rp_metric(card, "seconds by step", json.dumps(steps))
    rp_metric(card, "wall seconds", out["wall_s"])
    return out


# -- phase 20: the cluster tier and the RESP front-end ------------------------


def cl_metric(card: str, what: str, value) -> None:
    """One phase-20 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 20 {what}: {value}")


def cl_config(shards: int, wire: bool = False):
    """The deployment: Redis Cluster's contiguous CRC16 ranges over `shards`
    masters, each journaling under CL_DIR/shard-NN (fsync "off", the
    default). The cuda section names only the ingest, so each shard's
    device is the default, the card (`cuda:shard % cards`, cuda:0 here)."""
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(ingest="segment")
    cfg.use_cluster(num_shards=shards, dir=CL_DIR)
    if wire:
        cfg.use_wire(port=0)
    return cfg


def cl_name(prefix: str, table, shard: int) -> str:
    """The first `<prefix><i>` whose slot `shard` owns."""
    from redisson_tpu_torch.ops.crc16 import key_slot

    i = 0
    while table[key_slot(f"{prefix}{i}")] != shard:
        i += 1
    return f"{prefix}{i}"


def shard_primary(shard):
    """The shard's live engine: its fleet's promotee after a failover."""
    return shard.replicas.primary_client if shard.replicas else shard.client


def owner_rows(c) -> dict:
    """name -> registers of every HLL, read from the shard that owns its
    slot (a migrated sketch's old row stays behind on the source)."""
    from redisson_tpu_torch.ops.crc16 import key_slot

    table = c.cluster.router.slot_table()
    out = {}
    for sid, shard in c.cluster.shards.items():
        bank, rows = shard_primary(shard).to_numpy_state()
        for name, row in rows.items():
            if table[key_slot(name)] == sid:
                out[name] = bank[row]
    return out


def same_rows(got: dict, want: tuple, names, what: str) -> None:
    bank, rows = want
    bad = [n for n in names if n not in got or not np.array_equal(got[n], bank[rows[n]])]
    if bad:
        raise AssertionError(f"{what}: registers of {len(bad)} sketches differ "
                             f"from the reference, e.g. {bad[:3]}")


def cl_data(seed: int):
    """The HLL data set: SKETCHES sketches of KEYS int keys (phase 3's) and
    CL_TAG_SKETCHES `{t}` sketches that share one slot."""
    names = [f"hll:{i}" for i in range(SKETCHES)]
    batches = [keys_for(i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
    tags = [f"{{t}}:{j}" for j in range(CL_TAG_SKETCHES)]
    tag_batches = [keys_for((1 << 45) + j * KEYS, KEYS, seed)
                   for j in range(CL_TAG_SKETCHES)]
    return names, batches, tags, tag_batches


def cl_placement(c, card: str) -> dict:
    """Step 1: four shards on cuda:0; CLUSTER SLOTS covers 0-16383 once."""
    import torch

    shards = c.cluster.shards
    if len(shards) != CL_SHARDS:
        raise AssertionError(f"{len(shards)} shards, not {CL_SHARDS}")
    for sid, shard in shards.items():
        if shard.client.device != torch.device("cuda", 0):
            raise AssertionError(f"shard {sid} runs on {shard.client.device}")
    covered = np.zeros(16384, np.int64)
    ranges = c.cluster_slots()
    for start, end, _sid, _replicas in ranges:
        covered[start:end + 1] += 1
    if not (covered == 1).all():
        raise AssertionError("CLUSTER SLOTS does not cover 0-16383 exactly once")
    cl_metric(card, "CLUSTER SLOTS", json.dumps([r[:3] for r in ranges]))
    return {"ranges": len(ranges)}


def cl_hll(c, ref, data, card: str) -> dict:
    """Step 2: the HLL path's 1024 x 40,000 keys (and 64 {t} sketches) as
    one RBatch through the facade, split per owner by the router; the
    registers bit-identical and PFCOUNT equal to a single `sort` client's."""
    from redisson_tpu_torch.ops.crc16 import key_slot

    names, batches, tags, tag_batches = data
    table = c.cluster.router.slot_table()
    owners = np.bincount([table[key_slot(n)] for n in names], minlength=CL_SHARDS)
    if (owners == 0).any():
        raise AssertionError(f"a shard owns none of the sketches: {owners.tolist()}")
    reset_all_launches()
    t0 = time.perf_counter()
    b = c.create_batch()
    for n, keys in zip(names + tags, batches + tag_batches):
        b.get_hyper_log_log(n).add_ints_async(keys)
    added = b.execute()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    nkeys = (SKETCHES + CL_TAG_SKETCHES) * KEYS
    futs = [ref.get_hyper_log_log(n).add_ints_async(k)
            for n, k in zip(names + tags, batches + tag_batches)]
    [f.result() for f in futs]
    want = ref.to_numpy_state()
    if not all(added):
        raise AssertionError("a first PFADD into an empty sketch reported no change")
    same_rows(owner_rows(c), want, names + tags, "cluster PFADD")
    counts = [c.get_hyper_log_log(n).count() for n in names]
    ref_counts = [ref.get_hyper_log_log(n).count() for n in names]
    if counts != ref_counts:
        raise AssertionError("a cluster PFCOUNT differs from the single client's")
    for sid, shard in c.cluster.shards.items():
        if not on_card(shard.client):
            raise AssertionError(f"a state tensor of shard {sid} is not on the card")
    if not launches["seg_insert"]:
        raise AssertionError(f"the cluster PFADDs never launched seg_insert: {launches}")
    cl_metric(card, "sketches per shard", owners.tolist())
    cl_metric(card, f"RBatch PFADD seconds ({SKETCHES + CL_TAG_SKETCHES} x {KEYS} keys, "
              f"split over {CL_SHARDS} shards)", seconds)
    cl_metric(card, "RBatch PFADD keys/s through the facade", nkeys / seconds)
    log(f"  hll: {SKETCHES + CL_TAG_SKETCHES} sketches' registers bit-identical to "
        f"a single sort client's; {SKETCHES} PFCOUNTs equal")
    return {"launches": launches, "seconds": seconds, "keys_per_s": nkeys / seconds}


def cl_merges(c, ref, data, card: str) -> dict:
    """Step 3: a cross-shard PFMERGE over 1000 sketches (the host max-fold)
    and a countWith over the 64 {t} sketches on their one shard
    (merge_stack), each equal to the single client's."""
    names, _, tags, _ = data
    reset_all_launches()
    merges0 = c.cluster.router.cross_shard_merges
    t0 = time.perf_counter()
    c.get_hyper_log_log("union:cl").merge_with(*names[:MERGE_N])
    merge_s = time.perf_counter() - t0
    merged = c.get_hyper_log_log("union:cl").count()
    t0 = time.perf_counter()
    tag_count = c.get_hyper_log_log(tags[0]).count_with(*tags[1:])
    tag_s = time.perf_counter() - t0
    launches = all_launches()
    ref.get_hyper_log_log("union:cl").merge_with(*names[:MERGE_N])
    if merged != ref.get_hyper_log_log("union:cl").count():
        raise AssertionError("the cross-shard PFMERGE's count differs")
    regs = c._dispatch.execute_sync("union:cl", "hll_export", None)[0]
    if not np.array_equal(regs, ref._executor.execute_sync("union:cl", "hll_export",
                                                           None)[0]):
        raise AssertionError("the cross-shard PFMERGE's registers differ")
    if tag_count != ref.get_hyper_log_log(tags[0]).count_with(*tags[1:]):
        raise AssertionError("the {t} countWith differs")
    if c.cluster.router.cross_shard_merges != merges0 + 1:
        raise AssertionError("the PFMERGE did not take the cross-shard fold")
    if not launches["merge_stack"]:
        raise AssertionError(f"the {{t}} countWith never launched merge_stack: {launches}")
    cl_metric(card, f"cross-shard PFMERGE of {MERGE_N} seconds (host fold)", merge_s)
    cl_metric(card, f"countWith of {CL_TAG_SKETCHES} {{t}} sketches seconds", tag_s)
    log(f"  merges: PFMERGE over {MERGE_N} across 4 shards = {merged}, registers "
        f"equal; countWith over {CL_TAG_SKETCHES} {{t}} = {tag_count}; both equal")
    return {"launches": launches, "merge_s": merge_s}


def cl_bits(c, seed: int, card: str) -> dict:
    """Step 4: BASELINE config 2's filter (10M adds) and two 2^27-bit {day}
    bitmaps (8M SETBITs each) on shard 3; BITCOUNT and BITOP OR against
    numpy, the filter's cells against a single client's."""
    from redisson_tpu_torch.client import RedissonTorch

    table = c.cluster.router.slot_table()
    bloom = cl_name("bloom:", table, 3)
    tag = cl_name("d", table, 3)
    days = [f"{{{tag}}}:{d}" for d in range(2)]
    ids = day_ids(seed)[:2]
    reset_all_launches()
    t0 = time.perf_counter()
    bloom_fill(c, bloom, seed)
    for name, i in zip(days, ids):
        c.get_bit_set(name).set_bits(i)
    counts = [c.get_bit_set(n).cardinality() for n in days]
    union = c.get_bit_set(f"{{{tag}}}:or")
    union.or_(*days)
    union_count = union.cardinality()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    want = [np.zeros(DAY_BITS, np.uint8) for _ in range(2)]
    for w, i in zip(want, ids):
        w[i] = 1
    if counts != [int(w.sum()) for w in want]:
        raise AssertionError(f"BITCOUNT {counts} differs from numpy")
    or_want = want[0] | want[1]
    got_or = c._dispatch.execute_sync(union.name, "bits_export", None)[1]
    if union_count != int(or_want.sum()) or not np.array_equal(got_or, or_want):
        raise AssertionError("BITOP OR differs from numpy")
    ref = RedissonTorch.create(card_config("scatter"))
    try:
        bloom_fill(ref, bloom, seed)
        ref_cells = export_cells(ref, bloom)
    finally:
        ref.shutdown()
    if not np.array_equal(c._dispatch.execute_sync(bloom, "bits_export", None)[1],
                          ref_cells):
        raise AssertionError("the shard's Bloom cells differ from a single client's")
    if not on_card(c.cluster.shards[3].client):
        raise AssertionError("a state tensor of shard 3 is not on the card")
    for k in ("bits_insert_segmented", "popcount_partials", "bitop_cells"):
        if not launches[k]:
            raise AssertionError(f"the bits step never launched {k}: {launches}")
    cl_metric(card, f"bits step seconds ({BLOOM_KEYS} Bloom adds, 2 x {DAY_SETS} SETBITs, "
              "BITCOUNT, BITOP)", seconds)
    log(f"  bits: {bloom!r} on shard 3 equal to a single client's cells; BITCOUNT "
        f"{counts} and BITOP OR {union_count} equal numpy")
    return {"launches": launches, "seconds": seconds}


def cl_migrate(c, ref, data, seed: int, card: str) -> dict:
    """Step 5: shard 0's whole range (about 256 sketches) moves to shard 1
    while two writer threads PFADD into those sketches; then add_shard()
    and CL_NEW_RANGE slots of shard 2 move into it. Every acknowledged
    PFADD present (a reference fed exactly the acknowledged batches), no
    future lost."""
    import threading

    from redisson_tpu_torch.ops.crc16 import key_slot

    names = data[0]
    mgr = c.cluster
    table = mgr.router.slot_table()
    src_slots = [s for s in range(16384) if table[s] == 0]
    hot = [n for n in names if table[key_slot(n)] == 0]
    acked, errors, done = [], [], threading.Event()
    start = threading.Barrier(3)

    def writer(w: int) -> None:
        start.wait(CL_WAIT_S)
        for i in range(CL_WRITE_MAX):
            if done.is_set() and i >= CL_WRITE_MIN:
                return
            name = hot[(w * 7 + i) % len(hot)]
            keys = keys_for((1 << 50) + (w * CL_WRITE_MAX + i) * CL_WRITE_KEYS,
                            CL_WRITE_KEYS, seed)
            try:
                c.get_hyper_log_log(name).add_ints(keys)
                acked.append((name, keys))
            except Exception as exc:  # noqa: BLE001 — a lost future fails below
                errors.append(repr(exc))

    reset_all_launches()
    threads = [threading.Thread(target=writer, args=(w,), daemon=True) for w in range(2)]
    for t in threads:
        t.start()
    start.wait(CL_WAIT_S)
    t0 = time.perf_counter()
    try:
        stats = mgr.migrate_slots(src_slots, 1, timeout_s=CL_WAIT_S)
    finally:
        done.set()
    migrate_s = time.perf_counter() - t0
    for t in threads:
        t.join(CL_WAIT_S)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"a writer's PFADD failed or hung: {errors[:3]}")
    if stats["apply_errors"]:
        raise AssertionError(f"migration apply errors: {stats}")
    post = mgr.router.slot_table()
    if any(post[s] != 1 for s in src_slots):
        raise AssertionError("a migrated slot is not owned by shard 1")
    new_id = mgr.add_shard()
    moved = [s for s in range(16384) if post[s] == 2][:CL_NEW_RANGE]
    t0 = time.perf_counter()
    stats2 = mgr.migrate_slots(moved, new_id, timeout_s=CL_WAIT_S)
    add_s = time.perf_counter() - t0
    launches = all_launches()
    if stats2["apply_errors"] or any(mgr.router.slot_table()[s] != new_id for s in moved):
        raise AssertionError(f"the migration into the added shard failed: {stats2}")
    futs = [ref.get_hyper_log_log(n).add_ints_async(k) for n, k in acked]
    [f.result() for f in futs]
    want = ref.to_numpy_state()
    same_rows(owner_rows(c), want, names, "after the migrations")
    info = c.cluster_info()
    cl_metric(card, "migration of shard 0's range seconds", migrate_s)
    cl_metric(card, "migration stats", json.dumps(stats))
    cl_metric(card, f"PFADDs acknowledged during it (2 writers, {CL_WRITE_KEYS} keys)",
              len(acked))
    cl_metric(card, "redirects so far (router)", info["redirects"])
    cl_metric(card, f"add_shard + migration of {len(moved)} slots seconds", add_s)
    log(f"  migration: {len(src_slots)} slots ({len(hot)} sketches) shard 0 -> 1 under "
        f"2 writers, {len(acked)} acknowledged PFADDs all present, none lost; shard "
        f"{new_id} added, {len(moved)} slots moved in; registers equal the reference")
    return {"launches": launches, "migrate_s": migrate_s, "add_s": add_s,
            "acked": len(acked), "stats": stats, "redirects": info["redirects"]}


def cl_ha_config():
    """The "ha" step's deployment: Redis Cluster's 2 masters with one
    replica each (`replicas_per_shard=1`, `use_replicas(1)` the per-shard
    template), each shard journaling under CL_HA_DIR (fsync the phase's
    default). The probe is off: the failover is driven by hand."""
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(ingest="segment")
    cfg.use_cluster(num_shards=2, dir=CL_HA_DIR, replicas_per_shard=1)
    rc = cfg.use_replicas(1)
    rc.health_interval_s = 0.0
    rc.poll_interval_s = 0.002
    return cfg


def cl_fleet_caught_up(h) -> bool:
    """Every fleet member of every shard has applied its primary's journal
    to the tip (`lag() == 0`)."""
    fleets = [s.replicas for s in h.cluster.shards.values()]
    return all(f.replicas and all(r.lag() == 0 and r.applied_seq
                                  >= f.router.journal.last_seq for r in f.replicas)
               for f in fleets)


def cl_fleet_same(h, what: str) -> int:
    """Each replica's bank rows and cells bit-identical to its primary's,
    every state tensor on the card -> fleet members checked."""
    n = 0
    for sid, shard in h.cluster.shards.items():
        want = rp_state(shard_primary(shard))
        for rep in shard.replicas.replicas:
            if not on_card(rep.client):
                raise AssertionError(f"a state tensor of shard {sid}'s {rep.name} "
                                     "is not on the card")
            same_state(rp_state(rep.client), want, f"{what}: shard {sid} {rep.name}")
            n += 1
    return n


def cl_fleet_entries(h, what: str) -> None:
    """CLUSTER SLOTS lists one fleet member for each shard's ranges."""
    per_shard = {}
    for _start, _end, sid, reps in h.cluster_slots():
        per_shard.setdefault(sid, set()).update(e["id"] for e in reps)
    if sorted(per_shard) != [0, 1] or any(len(v) != 1 for v in per_shard.values()):
        raise AssertionError(f"{what}: CLUSTER SLOTS fleet members {per_shard}")


def cl_ha(seed: int, card: str, data) -> dict:
    """Step 6: shard-level HA. A second cluster (cl_ha_config) takes
    CL_HA_SKETCHES of the sketches and one 2^27-bit day (8M SETBITs) on
    shard 0; both replicas catch up bit for bit. A writer PFADDs into
    shard 0's further sketches while shard 0's primary executor is killed
    and its replica promoted: the slots stay owned, every acknowledged
    PFADD is present (a sort client on the card fed exactly the
    acknowledged batches), writes resume, countWith (merge_stack) agrees,
    the promotee computes BITCOUNT after one more SETBIT (a popcount launch
    of its own), and the rejoined replica catches up."""
    import itertools
    import shutil
    import threading

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.ops.crc16 import key_slot

    names, batches = data[0][:CL_HA_SKETCHES], data[1][:CL_HA_SKETCHES]
    shutil.rmtree(CL_HA_DIR, ignore_errors=True)
    h = RedissonTorch.create(cl_ha_config())
    try:
        mgr = h.cluster
        s0 = mgr.shards[0]
        table = mgr.router.slot_table()
        owners = np.bincount([table[key_slot(n)] for n in names], minlength=2)
        if (owners == 0).any():
            raise AssertionError(f"a shard owns none of the sketches: {owners.tolist()}")
        extra = list(itertools.islice(
            (n for n in (f"ha:w{j}" for j in itertools.count())
             if table[key_slot(n)] == 0), CL_HA_WRITE_SKETCHES))
        day = cl_name("ha:day", table, 0)
        ids = np.random.default_rng(seed + 3).integers(0, DAY_BITS, DAY_SETS)  # day 0
        cl_fleet_entries(h, "before the kill")
        reset_all_launches()
        t0 = time.perf_counter()
        b = h.create_batch()
        for n, keys in zip(names, batches):
            b.get_hyper_log_log(n).add_ints_async(keys)
        b.execute()
        h.get_bit_set(day).set_bits(ids)
        wait_state("fleet catch-up", lambda: cl_fleet_caught_up(h), CL_WAIT_S)
        catch_up = time.perf_counter() - t0
        nkeys = CL_HA_SKETCHES * KEYS + DAY_SETS
        cl_fleet_same(h, "after the catch-up")
        bitcount = h.get_bit_set(day).cardinality()
        owned = s0.guard.owned_slots()
        parts = {"writes + catch-up": time.perf_counter() - t0}
        t_part = time.perf_counter()

        acked, errors, stop = [], [], threading.Event()

        def writer() -> None:
            for j in range(CL_HA_WRITE_MAX):
                if stop.is_set():
                    return
                name = extra[j % len(extra)]
                keys = keys_for((1 << 51) + j * CL_WRITE_KEYS, CL_WRITE_KEYS, seed)
                try:
                    h.get_hyper_log_log(name).add_ints(keys)
                    acked.append((name, keys))
                except Exception as exc:  # noqa: BLE001 — its fate is held to the acks below
                    errors.append(repr(exc))
                    time.sleep(0.001)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            wait_state("writer PFADDs before the kill",
                       lambda: len(acked) >= CL_HA_WRITE_MIN, CL_WAIT_S)
            s0.client._executor.shutdown(wait=False)  # shard 0's primary dies
            t1 = time.perf_counter()
            promoted = s0.replicas.failover("phase 20: shard 0's primary killed")
            failover_s = time.perf_counter() - t1
            if promoted is None:
                raise AssertionError("failover() promoted no replica")
            at_failover = len(acked)
            # Until every writer sketch holds an acknowledged PFADD, and
            # CL_HA_WRITE_MIN more came back from the promotee.
            wait_state("writer PFADDs after the failover",
                       lambda: (len(acked) >= at_failover + CL_HA_WRITE_MIN
                                and len({n for n, _ in acked}) == len(extra))
                       or not t.is_alive(), CL_WAIT_S)
        finally:
            stop.set()
            t.join(CL_WAIT_S)
        if t.is_alive():
            raise AssertionError("the writer hung")
        if (len(acked) < at_failover + CL_HA_WRITE_MIN
                or len({n for n, _ in acked}) != len(extra)):
            raise AssertionError(f"writes did not resume after the failover: "
                                 f"{len(acked) - at_failover} acknowledged, {errors[-3:]}")
        if s0.guard.owned_slots() != owned:
            raise AssertionError("shard 0's owned slots changed across the failover")
        parts["writer + failover"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        fence = s0.replicas.last_fence_seq
        post = keys_for(1 << 52, KEYS, seed)
        h.get_hyper_log_log(extra[0]).add_ints(post)  # a write after the failover
        acked.append((extra[0], post))
        journal = promoted.persist.journal
        if journal.last_seq <= fence:
            raise AssertionError(f"the promotee's journal ends at {journal.last_seq}, "
                                 f"at or before the fence {fence}")
        mine = [n for n in names if table[key_slot(n)] == 0] + extra
        count_with = h.get_hyper_log_log(mine[0]).count_with(*mine[1:])
        # A SETBIT on the promotee: its BITCOUNT is computed there, not
        # answered from the read cache it filled as a replica.
        taken = np.zeros(min(DAY_BITS, 1 << 16), bool)
        taken[ids[ids < taken.size]] = True
        if taken.all():
            raise AssertionError(f"the day sets all of its first {taken.size} bits")
        fresh = int(np.argmin(taken))  # the first bit the day has not set
        h.get_bit_set(day).set(fresh)
        pc0 = all_launches()["popcount_partials"]
        bitcount_after = h.get_bit_set(day).cardinality()
        promotee_popcounts = all_launches()["popcount_partials"] - pc0
        info = h.cluster_info()
        parts["promotee's writes and reads"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        s0.replicas.rejoin()
        wait_state("the rejoined replica's catch-up", lambda: cl_fleet_caught_up(h),
                   CL_WAIT_S)
        launches = all_launches()
        parts["rejoin + catch-up"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        cl_fleet_same(h, "after the rejoin")
        cl_fleet_entries(h, "after the failover and the rejoin")
        got = owner_rows(h)
        day_cells = shard_primary(s0).to_numpy_objects()[day][1]
        parts["state reads"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
    finally:
        h.shutdown()
        shutil.rmtree(CL_HA_DIR, ignore_errors=True)
    parts["shutdown"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    ref = RedissonTorch.create(card_config("sort"))
    try:
        futs = [ref.get_hyper_log_log(n).add_ints_async(k)
                for n, k in list(zip(names, batches)) + acked]
        [f.result() for f in futs]
        want = ref.to_numpy_state()
        ref_count = ref.get_hyper_log_log(mine[0]).count_with(*mine[1:])
    finally:
        ref.shutdown()
    parts["reference"] = time.perf_counter() - t_part
    wbank, wrows = want
    if set(got) != set(wrows):
        raise AssertionError(f"after the failover: sketches {sorted(set(got) ^ set(wrows))[:5]} "
                             "are in only one of the cluster and the reference")
    bad = [n for n in wrows if not np.array_equal(got[n], wbank[wrows[n]])]
    if bad:
        above = sum(bool((got[n] >= wbank[wrows[n]]).all()) for n in bad)
        raise AssertionError(
            f"after the failover: registers of {len(bad)} sketches differ from the "
            f"reference fed the {len(acked)} acknowledged PFADDs, e.g. {bad[:3]}; "
            f"{above} of them only above it (a PFADD that failed at the writer "
            f"landed), {len(bad) - above} below it (an acknowledged PFADD lost); "
            f"{len(errors)} writer PFADDs failed, e.g. {errors[:3]}")
    if count_with != ref_count:
        raise AssertionError(f"countWith over shard 0's {len(mine)} sketches "
                             f"{count_with}, the reference's {ref_count}")
    if bitcount_after != bitcount + 1 or bitcount != len(np.unique(ids)):
        raise AssertionError(f"BITCOUNT {bitcount} before the kill, {bitcount_after} "
                             f"on the promotee after one more SETBIT, "
                             f"{len(np.unique(ids))} set")
    if promotee_popcounts < 1:
        raise AssertionError("the promotee's BITCOUNT launched no popcount_partials")
    if (int(day_cells.sum()) != bitcount + 1 or not day_cells[ids].all()
            or not day_cells[fresh]):
        raise AssertionError("the promotee's day cells differ from numpy's")
    if info["failovers"] != 1:
        raise AssertionError(f"cluster_info failovers {info['failovers']}, not 1")
    for k in ("seg_insert", "merge_stack", "popcount_partials"):
        if not launches[k]:
            raise AssertionError(f"the ha step never launched {k}: {launches}")
    cl_metric(card, "ha: 2 masters x 1 replica, catch-up / failover seconds and "
              "replica replay keys/s", json.dumps({
                  "catch_up_s": catch_up, "failover_s": failover_s,
                  "replay_keys_per_s": nkeys / catch_up}))
    cl_metric(card, f"ha: writer PFADDs ({CL_WRITE_KEYS} keys) acknowledged / failed "
              "(fate held to the acks)", f"{len(acked) - 1} / {len(errors)}")
    cl_metric(card, "ha: kernel launches (both primaries, both replicas, the promotee)",
              json.dumps(launches))
    cl_metric(card, "ha: seconds by part", json.dumps(parts))
    log(f"  ha: 2 shards x 1 replica caught up bit for bit ({nkeys} keys); shard 0's "
        f"primary killed under a writer, replica promoted in {failover_s:.3f} s; slots "
        f"kept, {len(acked)} acknowledged PFADDs all present, countWith over "
        f"{len(mine)} = {count_with} equal, BITCOUNT {bitcount} + 1 after a SETBIT "
        f"on the promotee ({promotee_popcounts} popcount launches); rejoined replica "
        "caught up")
    return {"launches": launches, "catch_up_s": catch_up, "failover_s": failover_s,
            "keys_per_s": nkeys / catch_up, "acked": len(acked)}


def cl_recover(c, card: str):
    """Step 5, last: a fresh facade (now 5 shards) on the same directory
    recovers the same slot table and registers; it starts the RESP servers
    the wire step uses."""
    from redisson_tpu_torch.client import RedissonTorch

    table = c.cluster.router.slot_table()
    rows = owner_rows(c)
    c.shutdown()
    t0 = time.perf_counter()
    fresh = RedissonTorch.create(cl_config(CL_SHARDS + 1, wire=True))
    seconds = time.perf_counter() - t0
    try:
        if fresh.cluster.router.slot_table() != table:
            raise AssertionError("the recovered slot table differs")
        got = owner_rows(fresh)
        if set(got) != set(rows) or any(not np.array_equal(got[n], rows[n]) for n in rows):
            raise AssertionError("the recovered registers differ")
    except BaseException:
        fresh.shutdown()
        raise
    cl_metric(card, "recovery of the 5-shard facade seconds (replay included)", seconds)
    log(f"  recovery: a fresh facade on {CL_DIR} has the same slot table and all "
        f"{len(rows)} sketches' registers")
    return fresh, seconds


def cl_socket(addr: str):
    import socket

    host, _, port = addr.rpartition(":")
    s = socket.create_connection((host, int(port)), timeout=CL_WAIT_S)
    s.settimeout(CL_WAIT_S)
    return s


def cl_exchange(sock, cmds) -> list:
    """Send `cmds` on a socket with the port's codec, CL_WIRE_PIPELINE at a
    time (below a connection's inflight cap, so none is shed), and read
    every reply."""
    from redisson_tpu_torch.wire import proto

    out = []
    parser = proto.RespParser()
    try:
        for lo in range(0, len(cmds), CL_WIRE_PIPELINE):
            part = cmds[lo:lo + CL_WIRE_PIPELINE]
            sock.sendall(proto.resp_encode_pipeline(part))
            want = len(out) + len(part)
            while len(out) < want:
                data = sock.recv(1 << 20)
                if not data:
                    raise AssertionError("a wire server closed the connection")
                out.extend(parser.feed(data))
    finally:
        parser.close()
    return out


def cl_one(addr: str, cmd):
    """One command on a fresh connection -> its reply."""
    s = cl_socket(addr)
    try:
        return cl_exchange(s, [cmd])[0]
    finally:
        s.close()


def cl_wire_pfadds(socks, plan) -> list:
    """Each socket sends its planned PFADDs from a thread of its own;
    -> every reply."""
    import threading

    replies, errors = [None] * len(socks), []

    def run(i):
        try:
            replies[i] = cl_exchange(socks[i][1], plan[i])
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(socks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(CL_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a wire socket failed or hung: {errors[:3]}")
    return [r for rs in replies for r in rs]


def cl_wire(c, seed: int, card: str) -> dict:
    """Step 6: one RESP server per shard. 8 raw sockets read CLUSTER SLOTS,
    pipeline PFADD of 1024 sketches x 4,000 byte keys to the owning servers
    (registers equal an in-process client fed the same bytes), see -MOVED
    on a wrong shard and -ASK on an importing slot, and PFCOUNT of {t}
    keys, BITCOUNT and BITOP equal the in-process answers; the wire.*
    gauges read the commands sent."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.ops.crc16 import key_slot
    from redisson_tpu_torch.wire import proto

    addrs = c.wire.addrs
    table = c.cluster.router.slot_table()
    slots = cl_one(addrs[min(addrs)], (b"CLUSTER", b"SLOTS"))
    sent = 1
    owner_addr = {(e[0], e[1]): f"{e[2][0].decode()}:{e[2][1]}" for e in slots}
    if sum(e - s + 1 for s, e in owner_addr) != 16384:
        raise AssertionError("CLUSTER SLOTS over the wire does not cover every slot")

    def addr_of(key: str) -> str:
        slot = key_slot(key)
        return next(a for (s, e), a in owner_addr.items() if s <= slot <= e)

    rng = np.random.default_rng(seed + 20)
    names = [f"w:{i}" for i in range(SKETCHES)]
    values = {n: [row.tobytes() for row in
                  rng.integers(0, 256, (CL_WIRE_KEYS, CL_WIRE_KEY_BYTES), np.uint8)]
              for n in names}
    # the 8 sockets, spread over the servers that own slots; each server's
    # PFADDs split over its sockets
    owners = sorted({a for a in owner_addr.values()})
    socks = [(owners[i % len(owners)], cl_socket(owners[i % len(owners)]))
             for i in range(CL_WIRE_SOCKETS)]
    plan = [[] for _ in socks]
    turn = {a: 0 for a in owners}
    for n in names:
        a = addr_of(n)
        mine = [i for i, (sa, _) in enumerate(socks) if sa == a]
        plan[mine[turn[a] % len(mine)]].append((b"PFADD", n.encode(), *values[n]))
        turn[a] += 1
    ref = None
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        replies = cl_wire_pfadds(socks, plan)
        wire_s = time.perf_counter() - t0
        sent += SKETCHES
        if replies != [1] * SKETCHES:
            raise AssertionError("a wire PFADD into an empty sketch did not answer 1")
        ref = RedissonTorch.create(card_config("sort"))
        for n in names:
            ref.get_hyper_log_log(n).add_all(values[n])
        same_rows(owner_rows(c), ref.to_numpy_state(), names, "wire PFADD")
        # -MOVED: a key sent to a server that does not own its slot
        home = addr_of("w:0")
        moved = cl_one(next(a for a in addrs.values() if a != home),
                       (b"PFADD", b"w:0", b"x"))
        want_moved = f"MOVED {key_slot('w:0')} {home}"
        if not isinstance(moved, proto.RespError) or str(moved) != want_moved:
            raise AssertionError(f"{moved!r} is not {want_moved!r}")
        # -ASK: the owner parks the slot in a cutover window while another
        # shard carries its importing mark
        ask_key = cl_name("ask:", table, 1)
        slot = key_slot(ask_key)
        c.cluster.shards[2].begin_migrate([slot], 2)
        c.cluster.router.begin_cutover([slot])
        try:
            ask = cl_one(addrs[1], (b"PFADD", ask_key.encode(), b"x"))
        finally:
            c.cluster.router.abort_cutover()
            c.cluster.shards[2].abort_migrate([slot])
        want_ask = f"ASK {slot} {addrs[2]}"
        if not isinstance(ask, proto.RespError) or str(ask) != want_ask:
            raise AssertionError(f"{ask!r} is not {want_ask!r}")
        sent += 2
        # PFCOUNT of the {t} keys, BITCOUNT and BITOP on their owners
        tags = [f"{{t}}:{j}" for j in range(CL_TAG_SKETCHES)]
        day_tag = cl_name("d", table, 3)
        days = [f"{{{day_tag}}}:{d}" for d in range(2)]
        dest = f"{{{day_tag}}}:wire-or"
        pfcount = cl_one(addr_of(tags[0]), (b"PFCOUNT", *[t.encode() for t in tags]))
        s = cl_socket(addr_of(days[0]))
        try:
            bit = cl_exchange(s, [(b"BITCOUNT", days[0].encode()),
                                  (b"BITOP", b"OR", dest.encode(),
                                   *[d.encode() for d in days]),
                                  (b"BITCOUNT", dest.encode())])
        finally:
            s.close()
        sent += 4
        in_proc = (c.get_hyper_log_log(tags[0]).count_with(*tags[1:]),
                   c.get_bit_set(days[0]).cardinality(),
                   c.get_bit_set(dest).size() // 8,
                   c.get_bit_set(f"{{{day_tag}}}:or").cardinality())
        launches = all_launches()
        if (pfcount, *bit) != in_proc:
            raise AssertionError(f"wire answers {(pfcount, *bit)} differ from the "
                                 f"in-process {in_proc}")
    finally:
        for _, s in socks:
            s.close()
        if ref is not None:
            ref.shutdown()
    snap = c.wire.snapshot()
    gauges = c.metrics.snapshot()["gauges"]
    if gauges["wire.commands"] != sent:
        raise AssertionError(f"wire.commands {gauges['wire.commands']} but {sent} sent")
    if gauges["wire.redirects"] < 2:
        raise AssertionError("wire.redirects did not count the -MOVED and -ASK")
    for k in ("seg_insert", "merge_stack", "popcount_partials", "bitop_cells"):
        if not launches[k]:
            raise AssertionError(f"the wire step never launched {k}: {launches}")
    nkeys = SKETCHES * CL_WIRE_KEYS
    cl_metric(card, f"wire PFADD seconds ({SKETCHES} x {CL_WIRE_KEYS} "
              f"{CL_WIRE_KEY_BYTES}-byte keys, {CL_WIRE_SOCKETS} sockets)", wire_s)
    cl_metric(card, "wire PFADD keys/s", nkeys / wire_s)
    cl_metric(card, "wire PFADD commands/s", SKETCHES / wire_s)
    cl_metric(card, "wire bytes in / out", f"{snap['bytes_in']} / {snap['bytes_out']}")
    cl_metric(card, "wire gauges", json.dumps({k: v for k, v in gauges.items()
                                                if k.startswith("wire.")}))
    log(f"  wire: {SKETCHES} PFADDs over {CL_WIRE_SOCKETS} sockets equal the "
        f"in-process registers; -MOVED and -ASK rendered; PFCOUNT {pfcount}, BITCOUNT "
        f"{bit[0]}, BITOP {bit[1]} bytes equal; wire.commands = {sent} sent")
    return {"launches": launches, "seconds": wire_s, "keys_per_s": nkeys / wire_s,
            "bytes_in": snap["bytes_in"], "bytes_out": snap["bytes_out"]}


def cluster_path(seed: int, card: str) -> dict:
    """Phase 20: the cluster tier (and, in its "ha" step, a second cluster
    with a replica per shard) and the RESP front-end on cuda:0, each step
    resetting the launch counters just before it."""
    import shutil

    from redisson_tpu_torch.client import RedissonTorch

    t_phase = time.perf_counter()
    shutil.rmtree(CL_DIR, ignore_errors=True)
    log(f"phase 20 on {card}:")
    data = cl_data(seed)
    steps, out = {}, {}
    c = RedissonTorch.create(cl_config(CL_SHARDS))
    ref = RedissonTorch.create(card_config("sort"))
    fresh = None
    try:
        for name, fn in (("placement", lambda: cl_placement(c, card)),
                         ("hll", lambda: cl_hll(c, ref, data, card)),
                         ("merges", lambda: cl_merges(c, ref, data, card)),
                         ("bits", lambda: cl_bits(c, seed, card)),
                         ("migration", lambda: cl_migrate(c, ref, data, seed, card)),
                         ("ha", lambda: cl_ha(seed, card, data))):
            t = time.perf_counter()
            out[name] = fn()
            steps[name] = round(time.perf_counter() - t, 3)
        ref.shutdown()
        ref = None
        t = time.perf_counter()
        fresh, out["recovery_s"] = cl_recover(c, card)
        steps["recovery"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        out["wire"] = cl_wire(fresh, seed, card)
        steps["wire"] = round(time.perf_counter() - t, 3)
    finally:
        if ref is not None:
            ref.shutdown()
        (fresh or c).shutdown()
        shutil.rmtree(CL_DIR, ignore_errors=True)
    launches = {}
    for step in ("hll", "merges", "bits", "migration", "ha", "wire"):
        launches = add_launches(launches, out[step]["launches"])
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    cl_metric(card, "seconds by step", json.dumps(steps))
    cl_metric(card, "wall seconds", out["wall_s"])
    cl_metric(card, "kernel launches", json.dumps(launches))
    return out


# -- phase 21: geo-replication (two active sites) ------------------------------


def geo_metric(card: str, what: str, value) -> None:
    """One phase-21 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 21 {what}: {value}")


def geo_site(sid: str):
    """A site with the default config (the card, ingest "auto"), persist
    under GEO_DIR/<sid> with the default fsync, GeoConfig defaults."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_persist(os.path.join(GEO_DIR, sid))
    cfg.use_geo(sid)
    return RedissonTorch.create(cfg)


def geo_converge(sites, what: str, card: str, steps: dict) -> float:
    """converge() polled up to GEO_WAIT_S from the last acknowledged write
    (the links ship while the writes run); its seconds are printed, never
    checked."""
    from redisson_tpu_torch.geo import converge

    t = time.perf_counter()
    if not converge(sites, GEO_WAIT_S):
        raise AssertionError(f"phase 21: the sites never converged after {what}")
    seconds = time.perf_counter() - t
    steps[what] = round(seconds, 3)
    geo_metric(card, f"converge seconds after {what} (from the last acknowledged "
               "write)", seconds)
    return seconds


def geo_rate(card: str, what: str, keys: int, t0: float) -> float:
    """Remote-apply keys/s of a step: the keys folded into the planes each
    site received, over the step's wall time (the writes, the shipping
    beside them and the converge)."""
    seconds = time.perf_counter() - t0
    geo_metric(card, f"{what}: step seconds {seconds:.4f}, remote-apply keys/s",
               keys / seconds)
    return keys / seconds


def geo_digest(client, names) -> dict:
    """name -> (type, cells bytes) or None, through the exports the links
    ship (host numpy cells): hll_export, else bits_export."""
    from redisson_tpu_torch.store import WrongTypeError

    ex, out = client._executor, {}
    for n in names:
        try:
            got = ex.execute_sync(n, "hll_export", None)
            otype = "hll"
        except WrongTypeError:
            got = None
        if got is None:
            got = ex.execute_sync(n, "bits_export", None)
            otype = None if got is None else str(got[0])
            got = None if got is None else got[1:]
        out[n] = None if got is None else (otype, np.asarray(got[0], np.uint8).tobytes())
    return out


def geo_same(sites, names, what: str) -> dict:
    da, db = (geo_digest(c, names) for c in sites)
    bad = [n for n in names if da[n] != db[n]]
    if bad:
        raise AssertionError(f"phase 21 {what}: the sites differ on {len(bad)} keys, "
                             f"e.g. {bad[:3]}")
    return da


def geo_partition(*targets):
    """Drop every geo_link tick toward the named sites."""
    from redisson_tpu_torch.fault import inject
    from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan, FaultRule

    inject.install(FaultInjector(FaultPlan(rules=[
        FaultRule(seam="geo_link", target=t, nth=1, times=1 << 30) for t in targets])))


def geo_pump(lead, behind, key: str) -> None:
    """SETBITs at `lead` until its journal is 32 records past `behind`'s, so
    its next stamps are the newer ones."""
    i = 0
    while lead.geo.journal_last_seq() <= behind.geo.journal_last_seq() + 32:
        lead.get_bit_set(key).set_bits([i])
        i += 1


def geo_hll(sites, ref, seed: int, card: str, steps: dict) -> dict:
    """Step 1: the HLL path's 1024 x 40,000 keys, each sketch's keys split
    between the sites (the first GEO_BOTH written in full at both); after
    converge both banks equal each other and the single-site sort
    reference fed the union."""
    a, b = sites
    names = [f"hll:{i}" for i in range(SKETCHES)]
    half = KEYS // 2
    t0 = time.perf_counter()
    futs = []
    for i, n in enumerate(names):
        keys = keys_for(i * STRIDE, KEYS, seed)
        if i < GEO_BOTH:
            futs += [a.get_hyper_log_log(n).add_ints_async(keys),
                     b.get_hyper_log_log(n).add_ints_async(keys)]
        else:
            futs += [a.get_hyper_log_log(n).add_ints_async(keys[:half]),
                     b.get_hyper_log_log(n).add_ints_async(keys[half:])]
    [f.result() for f in futs]
    geo_converge(sites, "hll", card, steps)
    remote = SKETCHES * half + GEO_BOTH * half  # keys each site received folded
    geo_rate(card, "hll", remote, t0)
    _res, ref_bank, ref_rows = ref
    for c, sid in zip(sites, "AB"):
        bank, rows = c.to_numpy_state()
        bad = [n for n in names if not np.array_equal(bank[rows[n]], ref_bank[ref_rows[n]])]
        if bad:
            raise AssertionError(f"phase 21 hll: site {sid}'s registers of {len(bad)} "
                                 f"sketches differ from the sort reference, e.g. {bad[:3]}")
    log(f"  hll: both sites' {SKETCHES} sketches bit-identical to the sort reference")
    return {"names": names, "remote_keys": remote}


def geo_bloom(sites, seed: int, card: str, steps: dict) -> dict:
    """Step 2: BASELINE config 2's filter initialized alike at both sites,
    10M adds split 5M / 5M; the cells equal each other and a single-site
    scatter client's."""
    from redisson_tpu_torch.client import RedissonTorch

    a, b = sites
    t0 = time.perf_counter()
    for c in sites:
        if not c.get_bloom_filter("bloom").try_init(BLOOM_N, BLOOM_P):
            raise AssertionError("try_init of a fresh filter returned False")
    step = BLOOM_KEYS // 10
    for lo in range(0, BLOOM_KEYS, step):
        (a if lo < BLOOM_KEYS // 2 else b).get_bloom_filter("bloom").add_ints(
            bloom_keys(lo, step, seed))
    geo_converge(sites, "bloom", card, steps)
    geo_rate(card, "bloom", BLOOM_KEYS // 2, t0)
    ref = RedissonTorch.create(card_config("scatter"))
    try:
        bloom_fill(ref, "bloom", seed)
        want = export_cells(ref, "bloom")
    finally:
        ref.shutdown()
    cells = geo_same(sites, ["bloom"], "bloom")["bloom"][1]
    if cells != want.tobytes():
        raise AssertionError("phase 21 bloom: the sites' cells differ from scatter's")
    log(f"  bloom: m = {BLOOM_M}, k = {BLOOM_K}: both sites' cells equal the "
        "single-site scatter client's")
    return {}


def geo_bits(sites, seed: int, card: str, steps: dict) -> dict:
    """Step 3: one 2^27-bit bitmap, 8M SETBITs split between the sites; the
    cells equal, BITCOUNT equal at both sites and to numpy's."""
    a, b = sites
    idx = rp_day(seed)
    half = DAY_SETS // 2
    t0 = time.perf_counter()
    a.get_bit_set("geo:day").set_bits(idx[:half])
    b.get_bit_set("geo:day").set_bits(idx[half:])
    geo_converge(sites, "bitset", card, steps)
    geo_rate(card, "bitset", half, t0)
    geo_same(sites, ["geo:day"], "bitset")
    want = int(np.unique(idx).size)
    counts = [c.get_bit_set("geo:day").cardinality() for c in sites]
    if counts != [want, want]:
        raise AssertionError(f"phase 21 bitset: BITCOUNT {counts}, numpy {want}")
    log(f"  bitset: cells identical; BITCOUNT {want} at both sites and in numpy")
    return {"idx": idx}


def geo_lww(sites, seed: int, card: str, steps: dict, idx) -> dict:
    """Step 4: with the sites partitioned, B (its stamps pumped past A's)
    PFADDs to GEO_LWW_NEWER of the GEO_LWW_DEL sketches A deletes; after the
    heal those are resurrected at both sites (B's state) and the rest are
    gone at both. Then a SETBIT-to-0 at A (its stamps pumped past B's)
    replicates as a full-state replace."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.fault import inject

    a, b = sites
    doomed = [f"hll:{i}" for i in range(GEO_LWW_DEL)]
    newer = doomed[:GEO_LWW_NEWER]
    geo_partition("A", "B")
    try:
        geo_pump(b, a, "geo:pump:b")
        new_keys = [keys_for((1 << 44) + j * GEO_LWW_KEYS, GEO_LWW_KEYS, seed)
                    for j in range(GEO_LWW_NEWER)]
        for n, keys in zip(newer, new_keys):
            b.get_hyper_log_log(n).add_ints(keys)
        a.get_keys().delete(*doomed)
    finally:
        inject.uninstall()
    geo_converge(sites, "lww", card, steps)
    digest = geo_same(sites, doomed, "lww")
    gone = [n for n in doomed[GEO_LWW_NEWER:] if digest[n] is not None]
    if gone:
        raise AssertionError(f"phase 21 lww: deleted sketches survive: {gone}")
    ref = RedissonTorch.create(card_config("sort"))
    try:
        for i, (n, keys) in enumerate(zip(newer, new_keys)):
            ref.get_hyper_log_log(n).add_ints(keys_for(i * STRIDE, KEYS, seed))
            ref.get_hyper_log_log(n).add_ints(keys)
        want = geo_digest(ref, newer)
    finally:
        ref.shutdown()
    bad = [n for n in newer if digest[n] != want[n]]
    if bad:
        raise AssertionError(f"phase 21 lww: resurrected sketches differ from B's "
                             f"writes: {bad}")
    res = [c.geo.applier.resurrections for c in sites]
    sup = [c.geo.applier.suppressed for c in sites]
    if not sum(res) or not sum(sup):
        raise AssertionError(f"phase 21 lww: no suppression or resurrection: {sup}, {res}")
    # SETBIT-to-0 at A, newer than every write B made to the bitmap.
    geo_pump(a, b, "geo:pump:a")
    cleared = np.unique(idx)[:GEO_CLEAR]
    a.get_bit_set("geo:day").clear_bits(cleared)
    geo_converge(sites, "bitset clear", card, steps)
    geo_same(sites, ["geo:day"], "bitset clear")
    want_count = int(np.unique(idx).size) - GEO_CLEAR
    counts = [c.get_bit_set("geo:day").cardinality() for c in sites]
    if counts != [want_count, want_count]:
        raise AssertionError(f"phase 21 bitset clear: BITCOUNT {counts}, want {want_count}")
    geo_metric(card, "lww: suppressed, resurrections (A, B)", json.dumps([sup, res]))
    log(f"  lww: {GEO_LWW_NEWER} sketches resurrected at both sites as B wrote them, "
        f"{GEO_LWW_DEL - GEO_LWW_NEWER} gone at both; a SETBIT-to-0 of {GEO_CLEAR} bits "
        "replicated as a replace")
    return {}


def geo_partition_heal(sites, seed: int, card: str, steps: dict) -> dict:
    """Step 5: B isolated by geo_link faults while both sites write; after the
    heal the sites converge bit-identical."""
    from redisson_tpu_torch.fault import inject

    a, b = sites
    names = [f"geo:p:{j}" for j in range(GEO_PART_SKETCHES)]
    half = KEYS // 2
    geo_partition("A", "B")
    try:
        for j, n in enumerate(names):
            keys = keys_for((1 << 46) + j * KEYS, KEYS, seed)
            a.get_hyper_log_log(n).add_ints(keys[:half])
            b.get_hyper_log_log(n).add_ints(keys[half:])
        time.sleep(0.1)  # ticks run into the partition
    finally:
        inject.uninstall()
    parts = a.geo.links["B"].stats["partitions"] + b.geo.links["A"].stats["partitions"]
    geo_converge(sites, "partition heal", card, steps)
    geo_same(sites, names, "partition heal")
    if not parts:
        raise AssertionError("phase 21 partition: no link tick was dropped")
    geo_metric(card, "partition: link ticks dropped", parts)
    log(f"  partition: {parts} ticks dropped; {len(names)} sketches bit-identical "
        "after the heal")
    return {"names": names}


def geo_rejoin(sites, names, seed: int, card: str, steps: dict):
    """Step 6: B shut down and reopened on its directory while A writes: the
    reopened site's version vector is the one its sidecar saved, and the
    sites converge bit-identical again."""
    from redisson_tpu_torch.geo import connect_sites

    a, b = sites
    vv = dict(b.geo.applier.vv)
    b.shutdown()
    for i in range(GEO_BOTH):
        a.get_hyper_log_log(f"hll:{i}").add_ints(
            keys_for((1 << 47) + i * GEO_KILL_KEYS, GEO_KILL_KEYS, seed))
    t = time.perf_counter()
    b2 = geo_site("B")
    steps["reopen"] = round(time.perf_counter() - t, 3)
    sites[1] = b2
    got = dict(b2.geo.applier.vv)
    if got != vv:
        raise AssertionError(f"phase 21 rejoin: version vector {got}, saved {vv}")
    connect_sites(sites)
    geo_converge(sites, "rejoin", card, steps)
    geo_same(sites, names, "rejoin")
    geo_metric(card, "rejoin: reopen seconds (journal replay)", steps["reopen"])
    log(f"  rejoin: B's version vector {got} restored; {len(names)} keys bit-identical")
    return b2


def geo_path(seed: int, card: str, ref) -> dict:
    """Phase 21: two geo sites on cuda:0 converging through delta_merge; the
    launch counters are reset at its start and read at its end."""
    import shutil

    from redisson_tpu_torch.geo import connect_sites

    t_phase = time.perf_counter()
    shutil.rmtree(GEO_DIR, ignore_errors=True)
    log(f"phase 21 on {card}:")
    reset_all_launches()
    sites = [geo_site("A"), geo_site("B")]
    steps, out = {}, {}
    try:
        connect_sites(sites)
        out["hll"] = geo_hll(sites, ref, seed, card, steps)
        geo_bloom(sites, seed, card, steps)
        idx = geo_bits(sites, seed, card, steps)["idx"]
        geo_lww(sites, seed, card, steps, idx)
        part = geo_partition_heal(sites, seed, card, steps)
        link = sum(l.stats["link_bytes"] for c in sites for l in c.geo.links.values())
        raw = sum(l.stats["raw_bytes"] for c in sites for l in c.geo.links.values())
        names = (out["hll"]["names"] + part["names"]
                 + ["bloom", "geo:day", "geo:pump:a", "geo:pump:b"])
        geo_rejoin(sites, names, seed, card, steps)
        counters = [{k: c.sketch.counters[k] for k in ("geo_planes", "geo_classic")}
                    for c in sites]
        card_state = all(on_card(c) for c in sites)
    finally:
        for c in sites:
            c.shutdown()
        shutil.rmtree(GEO_DIR, ignore_errors=True)
    launches = all_launches()
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    geo_metric(card, "geo_planes / geo_classic (A, B)", json.dumps(counters))
    geo_metric(card, "link bytes against raw journal bytes (both directions, before "
               "the rejoin)", f"{link} / {raw} = {link / max(raw, 1):.5f}")
    geo_metric(card, "seconds by step", json.dumps(steps))
    geo_metric(card, "wall seconds", out["wall_s"])
    geo_metric(card, "kernel launches", json.dumps(launches))
    geo_metric(card, "delta_merge launches", launches["delta_merge"])
    if not all(c["geo_planes"] > 0 and c["geo_classic"] == 0 for c in counters):
        raise AssertionError(f"phase 21: remote planes missed delta_merge: {counters}")
    if not launches["delta_merge"]:
        raise AssertionError(f"phase 21 never launched delta_merge: {launches}")
    if not card_state:
        raise AssertionError("phase 21: a site's state tensor is not on the card")
    out["link_bytes"], out["raw_bytes"] = link, raw
    return out


def rd_metric(card: str, what: str, value) -> None:
    """One phase-22 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 22 {what}: {value}")


def rd_client(port: int, flush_interval_s: float = 0.0):
    """A card client (cuda:0, ingest "segment", the redis hash family)
    whose durability tier writes to the embedded server on `port`."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(hll_hash="redis", ingest="segment")
    rcfg = cfg.use_redis()
    rcfg.address = f"redis://127.0.0.1:{port}"
    rcfg.timeout_ms = RD_TIMEOUT_MS
    cfg.flush_interval_s = flush_interval_s
    return RedissonTorch.create(cfg)


def rd_keys(i: int, seed: int) -> np.ndarray:
    """Sketch i's keys: the HLL path's 40,000 with its neighbouring overlap.
    Under the redis family the client hashes each uint64's 8 little-endian
    bytes, so these are the byte keys a server's PFADD gets."""
    return keys_for(i * STRIDE, KEYS, seed)


def rd_fill(c, names, seed: int):
    """256 sketches, the Bloom filter with 10M adds, one 2^27-bit day ->
    the day's set bits."""
    futs = [c.get_hyper_log_log(n).add_ints_async(rd_keys(i, seed))
            for i, n in enumerate(names)]
    [f.result() for f in futs]
    bloom_fill(c, "rd:bloom", seed)
    day = rp_day(seed)
    c.get_bit_set("rd:day").set_bits(day)
    return day


def rd_rows(c, names) -> np.ndarray:
    bank, rows = c.to_numpy_state()
    return np.stack([bank[rows[n]] for n in names]).astype(np.uint8)


def rd_flush_checks(c, rc, names, seed: int, card: str) -> dict:
    """Steps 3 and 4: every blob against the card's state, the server's own
    fold of RD_FOLD_CHECK sketches' keys and its PFCOUNT of every sketch."""
    from redisson_tpu_torch.interop import hyll
    from redisson_tpu_torch.interop.durability import bloom_config_key

    regs = rd_rows(c, names)
    blobs = rc.pipeline([("GET", n) for n in names])
    for i, blob in enumerate(blobs):
        if not np.array_equal(hyll.decode(blob), regs[i]):
            raise AssertionError(f"phase 22: the blob of {names[i]} is not the card's row")
        if hyll.blob_family(blob) != "redis":
            raise AssertionError("phase 22: a redis-family flush carries the m3 tag")
    cells = export_cells(c, "rd:bloom")
    bloom_blob = rc.execute("GET", "rd:bloom")
    if bloom_blob != np.packbits(cells).tobytes():
        raise AssertionError("phase 22: the Bloom blob is not packbits of the card's cells")
    cfg = rc.execute("HGETALL", bloom_config_key("rd:bloom"))
    cfg = {bytes(cfg[j]).decode(): bytes(cfg[j + 1]).decode() for j in range(0, len(cfg), 2)}
    want = {"size": str(BLOOM_M), "hashIterations": str(BLOOM_K),
            "expectedInsertions": str(BLOOM_N), "falseProbability": str(BLOOM_P)}
    if cfg != want:
        raise AssertionError(f"phase 22: the Bloom config hash is {cfg}, not {want}")
    ext = c._store.get("rd:day").meta["extent_bits"]
    day_blob = rc.execute("GET", "rd:day")
    day_cells = export_cells(c, "rd:day")[:ext]
    if len(day_blob) != (ext + 7) // 8 or day_blob != np.packbits(day_cells).tobytes():
        raise AssertionError(f"phase 22: the BitSet blob ({len(day_blob)} bytes) is not "
                             f"the packed {ext}-bit extent")
    t = time.perf_counter()
    picks = np.linspace(0, len(names) - 1, RD_FOLD_CHECK).astype(int)
    for i in picks:
        rc.execute("PFADD", f"rdsrv:{i}", *[k.tobytes() for k in rd_keys(int(i), seed)])
        if not np.array_equal(hyll.decode(rc.execute("GET", f"rdsrv:{i}")), regs[i]):
            raise AssertionError(f"phase 22: the server's PFADD of sketch {i}'s keys "
                                 "differs from the card's registers")
    rd_metric(card, f"server-side fold of {RD_FOLD_CHECK} x {KEYS} keys (pure Python) "
              "seconds", time.perf_counter() - t)
    srv = rc.pipeline([("PFCOUNT", n) for n in names])
    mine = [f.result() for f in [c.get_hyper_log_log(n).count_async() for n in names]]
    worst = 0.0
    for n, a, b, r in zip(names, srv, mine, regs):
        est = hyll.estimate(r)
        if a != int(round(est)):
            raise AssertionError(f"phase 22: the server's PFCOUNT of {n} is {a}, its "
                                 f"estimator over the blob gives {est}")
        # The card counts in float32: within rel 1e-5 of the float64
        # estimate, and half a unit for each side's rounding to an integer.
        if abs(b - est) > 1e-5 * est + 0.5:
            raise AssertionError(f"phase 22: {n} counts {b} on the card, {a} on the server")
        worst = max(worst, abs(b - a) / max(a, 1))
    rd_metric(card, "largest relative difference of card and server PFCOUNT", worst)
    return {"regs": regs, "cells": cells, "day_cells": day_cells, "ext": ext,
            "bytes": sum(len(b) for b in blobs) + len(bloom_blob) + len(day_blob)}


def rd_reload(port: int, names, state: dict, day, seed: int, card: str,
              union: int) -> float:
    """Step 5: a fresh card client loads every object and holds it against
    the first client's state -> load seconds."""
    import torch

    c = rd_client(port)
    try:
        t = time.perf_counter()
        for n in names:
            if not c.durability.load_hll(n):
                raise AssertionError(f"phase 22: no blob for {n}")
        if not (c.durability.load_bloom("rd:bloom")
                and c.durability.load_bitset("rd:day")):
            raise AssertionError("phase 22: the Bloom or BitSet blob is missing")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if not np.array_equal(rd_rows(c, names), state["regs"]):
            raise AssertionError("phase 22: reloaded registers differ")
        if not np.array_equal(export_cells(c, "rd:bloom"), state["cells"]):
            raise AssertionError("phase 22: reloaded Bloom cells differ")
        if not np.array_equal(export_cells(c, "rd:day")[:state["ext"]],
                              state["day_cells"]):
            raise AssertionError("phase 22: the reloaded bitmap differs")
        expect("phase 22 BITCOUNT after the reload", c.get_bit_set("rd:day").cardinality(),
               int(np.unique(day).size))
        bloom = c.get_bloom_filter("rd:bloom")
        hits = [bloom.contains_count_device_async(torch.from_numpy(
            bloom_keys(lo, BLOOM_BATCH, seed).view(np.int64)).to(c.device))
            for lo in range(0, BLOOM_KEYS, BLOOM_BATCH)]
        expect("phase 22 added keys contained after the reload",
               sum(f.result() for f in hits), BLOOM_KEYS)
        expect("phase 22 union PFCOUNT after the reload",
               c.get_hyper_log_log(names[0]).count_with(*names[1:]), union)
        if not on_card(c):
            raise AssertionError("phase 22: a reloaded state tensor is not on cuda:0")
    finally:
        c.shutdown()
    rd_metric(card, f"load seconds ({len(names)} HLL rows, the Bloom filter, the "
              "BitSet)", load_s)
    return load_s


def rd_periodic(port: int, rc, seed: int, card: str) -> float:
    """Step 6: a client with flush_interval_s = 0.2 loads sketch 0, PFADDs
    one more batch, and the periodic flusher carries it to the server; then
    two only_dirty flushes, the second writing nothing -> seconds until the
    server's blob held the batch."""
    from redisson_tpu_torch.interop import hyll

    c = rd_client(port, RD_FLUSH_S)
    try:
        if c.durability._timer is None:
            raise AssertionError("phase 22: flush_interval_s started no periodic flusher")
        c.durability.load_hll("rd:0")
        c.get_hyper_log_log("rd:0").add_ints(keys_for(1 << 40, RD_EXTRA_KEYS, seed))
        want = rd_rows(c, ["rd:0"])[0]
        t = time.perf_counter()
        while not np.array_equal(hyll.decode(rc.execute("GET", "rd:0")), want):
            if time.perf_counter() - t > RD_WAIT_S:
                raise AssertionError("phase 22: the periodic flusher never carried "
                                     "the last PFADD to the server")
            time.sleep(0.02)
        seen_s = time.perf_counter() - t
        c.durability.stop_periodic()
        c.durability.flush(only_dirty=True)
        expect("phase 22 objects written by a second only_dirty flush",
               c.durability.flush(only_dirty=True), 0)
    finally:
        c.shutdown()
    rd_metric(card, f"seconds until the periodic flusher ({RD_FLUSH_S} s) carried a "
              "PFADD to the server", seen_s)
    return seen_s


def redis_path(seed: int, card: str) -> dict:
    """Phase 22: the redis durability tier on the card against the port's
    embedded RESP server (hll_hash="redis"); the launch counters are reset
    at its start and read at its end."""
    import torch

    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
    from redisson_tpu_torch.interop.resp_client import SyncRespClient

    t_phase = time.perf_counter()
    log(f"phase 22 on {card}:")
    reset_all_launches()
    names = [f"rd:{i}" for i in range(RD_SKETCHES)]
    out = {}
    er = EmbeddedRedis(hll_hash="redis")
    rc = SyncRespClient(port=er.port, timeout=RD_TIMEOUT_MS / 1000.0)
    try:
        rc.connect()
        c = rd_client(er.port)
        try:
            t = time.perf_counter()
            day = rd_fill(c, names, seed)
            torch.cuda.synchronize()
            rd_metric(card, f"fill seconds ({RD_SKETCHES} x {KEYS} PFADD keys, "
                      f"{BLOOM_KEYS} Bloom adds, {DAY_SETS} SETBITs)",
                      time.perf_counter() - t)
            t = time.perf_counter()
            flushed = c.durability.flush()
            out["flush_s"] = time.perf_counter() - t
            # The pipeline's own seconds (the socket and the server); the
            # rest of the flush is the exports, copies and encodes.
            out["pipeline_s"] = c.durability.last_flush_s
            expect("phase 22 objects flushed", flushed, RD_SKETCHES + 2)
            state = rd_flush_checks(c, rc, names, seed, card)
            out["flush_bytes"] = state["bytes"]
            out["flush_mb_s"] = state["bytes"] / 1e6 / out["flush_s"]
            rd_metric(card, "flush seconds, of them the pipeline's (socket and "
                      "server), MB over the socket, MB/s",
                      f"{out['flush_s']} {out['pipeline_s']} {state['bytes'] / 1e6} "
                      f"{out['flush_mb_s']}")
            union = c.get_hyper_log_log(names[0]).count_with(*names[1:])
            cells = c._store.get("rd:bloom").state
            torch.cuda.synchronize()
            t = time.perf_counter()
            host = cells.cpu().numpy()
            out["d2h_s"] = time.perf_counter() - t
            t = time.perf_counter()
            np.packbits(host)
            out["pack_s"] = time.perf_counter() - t
            rd_metric(card, f"device-to-host copy of the Bloom's {cells.numel()} cells "
                      "seconds, then np.packbits seconds",
                      f"{out['d2h_s']} {out['pack_s']}")
            del host, cells
            if not on_card(c):
                raise AssertionError("phase 22: a state tensor of the flushing client "
                                     "is not on cuda:0")
        finally:
            c.shutdown()
        out["load_s"] = rd_reload(er.port, names, state, day, seed, card, union)
        out["periodic_s"] = rd_periodic(er.port, rc, seed, card)
    finally:
        rc.close()
        er.stop()
    launches = all_launches()
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    rd_metric(card, "kernel launches", json.dumps(launches))
    rd_metric(card, "wall seconds", out["wall_s"])
    missing = [k for k in ("seg_insert", "bits_insert_segmented", "popcount_partials",
                           "merge_stack") if not launches[k]]
    if missing:
        raise AssertionError(f"phase 22 never launched {missing}: {launches}")
    return out


# -- phase 23: the pod tier and the mesh data plane ----------------------------


def pd_metric(card: str, what: str, value) -> None:
    """One phase-23 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 23 {what}: {value}")


def pd_counts(c, names) -> list:
    return [f.result() for f in [c.get_hyper_log_log(n).count_async() for n in names]]


def pd_close(what: str, got, want) -> None:
    """PFCOUNT within rel 1e-5 (the float32 sum order of the estimator)."""
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if abs(g - w) > 1e-5 * max(w, 1)]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: {len(bad)} counts differ, e.g. {bad[:3]}")


def pd_placed(arrays, mesh, store) -> bool:
    """Each blocked array's blocks, each a tensor of its own on its mesh
    entry's card, and the store's objects on the mesh's home."""
    for arr in arrays:
        if ([b.device for b in arr.blocks] != list(mesh.devices)
                or not all(b.is_cuda for b in arr.blocks)
                or len({b.untyped_storage().data_ptr() for b in arr.blocks})
                != len(arr.blocks)):
            return False
    return all(store.get(n).state.device == mesh.home for n in store.keys())


def pd_on_card(c) -> bool:
    """The pod's blocks (the bank's and every sharded bit array's) and the
    delegate store, placed (`pd_placed`)."""
    be = c._pod_backend()
    return pd_placed([be.bank] + [o.state for o in be._bits.values()], be.mesh,
                     be.store)


def sync_cards() -> None:
    """Wait for every visible card (a pod's blocks may span several)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def pd_blocks(card: str, what: str, arr) -> None:
    """Each block of a pod array: its card and bytes."""
    pd_metric(card, f"{what} blocks (card, bytes)",
              json.dumps([[str(b.device), int(b.nbytes)] for b in arr.blocks]))


def pd_hll(c, ref, seed: int, card: str) -> dict:
    """Step 1: the HLL path at full width over 4 logical shards: 1024
    sketches x 40,000 keys into a 64 MiB bank of 256 rows per shard, then
    64 of them again as byte keys; the bank bit-identical to the single-card
    `sort` reference, per-sketch PFCOUNT, count-all and PFMERGE+count over
    1000 equal to it; reshard(2) and reshard(4) keep the bank bit for bit
    and PD_RESHARD_COUNTS sketches' counts (a cut of depth: each PFCOUNT
    is a launch chain)."""
    ref_res, ref_bank, ref_rows = ref
    names = [f"hll:{i}" for i in range(SKETCHES)]
    batches = [keys_for(i * STRIDE, KEYS, seed) for i in range(SKETCHES)]
    be = c._pod_backend()
    reset_all_launches()
    t = time.perf_counter()
    added = [f.result() for f in [c.get_hyper_log_log(n).add_ints_async(b)
                                  for n, b in zip(names, batches)]]
    sync_cards()
    add_s = time.perf_counter() - t
    pd_blocks(card, "bank", be.bank)
    if not all(added):
        raise AssertionError("phase 23: a first PFADD into an empty sketch reported "
                             "no change")
    bank, rows = c.to_numpy_state()
    if bank.shape != (SKETCHES, 16384) or be.mesh.size != PD_SHARDS:
        raise AssertionError(f"phase 23: bank {bank.shape} over {be.mesh.size} shards")
    same_bank(bank, rows, ref_bank, {n: ref_rows[n] for n in names}, "the pod bank")
    t = time.perf_counter()
    flags = [c.get_hyper_log_log(n).add_all([k.tobytes() for k in b])
             for n, b in zip(names[:PD_BYTE_SKETCHES], batches[:PD_BYTE_SKETCHES])]
    byte_s = time.perf_counter() - t
    if any(flags) or not np.array_equal(c.to_numpy_state()[0], bank):
        raise AssertionError("phase 23: the byte keys (pre-hashed on the card) raised a "
                             "register their u64 twins had not")
    counts = pd_counts(c, names)
    pd_close("phase 23 per-sketch PFCOUNT", counts, ref_res["counts"])
    t = time.perf_counter()
    count_all = c._executor.execute_sync("", "hll_count_all", None)
    all_s = time.perf_counter() - t
    pd_close("phase 23 count-all", [count_all], [ref_res["count_with"]])
    t = time.perf_counter()
    mc = c.get_hyper_log_log("union:mc").merge_with_and_count(*names[:MERGE_N])
    merge_ms = (time.perf_counter() - t) * 1e3
    pd_close(f"phase 23 PFMERGE+count over {MERGE_N}", [mc], [ref_res["merge_and_count"]])
    launches = all_launches()
    reshard_s = {}
    before = c.to_numpy_state()[0]
    for n in (2, PD_SHARDS):
        t = time.perf_counter()
        c._executor.execute_barrier(lambda n=n: be.reshard(n)).result()
        sync_cards()
        reshard_s[n] = time.perf_counter() - t
        if be.mesh.size != n:
            raise AssertionError(f"phase 23: reshard({n}) left {be.mesh.size} shards")
        if not np.array_equal(c.to_numpy_state()[0], before):
            raise AssertionError(f"phase 23: reshard({n}) changed the bank")
        pd_close(f"phase 23 PFCOUNT after reshard({n})",
                 pd_counts(c, names[:PD_RESHARD_COUNTS]), counts[:PD_RESHARD_COUNTS])
    if not pd_on_card(c):
        raise AssertionError("phase 23: a pod block is not a tensor of its own on its "
                             "entry's card")
    for k in ("seg_insert", "merge_stack"):
        if not launches[k]:
            raise AssertionError(f"phase 23 hll never launched {k}: {launches}")
    err = abs(count_all - EXACT_ALL) / EXACT_ALL
    pd_metric(card, f"PFADD keys/s ({SKETCHES} x {KEYS} u64 keys over {PD_SHARDS} "
              "shards)", SKETCHES * KEYS / add_s)
    pd_metric(card, f"byte-key PFADD keys/s ({PD_BYTE_SKETCHES} x {KEYS})",
              PD_BYTE_SKETCHES * KEYS / byte_s)
    pd_metric(card, "count-all ms, PFMERGE+count over 1000 ms",
              f"{all_s * 1e3} {merge_ms}")
    pd_metric(card, "reshard seconds (to 2, back to 4)", json.dumps(reshard_s))
    log(f"  pod hll: bank bit-identical to the sort reference ({SKETCHES} rows, "
        f"{PD_SHARDS} x {SKETCHES // PD_SHARDS}); count-all {count_all} (exact "
        f"{EXACT_ALL}, error {err:.5f}); PFMERGE+count over {MERGE_N} {mc}; counts kept "
        "through reshard(2) and reshard(4)")
    return {"launches": launches, "keys_per_s": SKETCHES * KEYS / add_s,
            "merge_ms": merge_ms, "reshard_s": reshard_s}


def pd_bloom(c, ref_bloom, seed: int, card: str) -> dict:
    """Step 2: BASELINE config 2's filter (m = 257,296,945, k = 7) sharded
    over 4 shards, 10M adds in 2M batches: cells and added flags equal to a
    single-card `scatter` filter fed the same keys (phase 7's), every added
    key contained, count() equal."""
    from redisson_tpu_torch.ops import bloom_math

    ref_cells, ref_added = ref_bloom
    reset_all_launches()
    t = time.perf_counter()
    f, added = bloom_fill(c, "pod:bloom", seed)
    sync_cards()
    fill_s = time.perf_counter() - t
    pd_blocks(card, "Bloom filter", c._pod_backend()._bits["pod:bloom"].state)
    hits = sum(f.contains_count_ints(bloom_keys(lo, BLOOM_BATCH, seed))
               for lo in range(0, BLOOM_KEYS, BLOOM_BATCH))
    count = f.count()
    launches = all_launches()
    cells = export_cells(c, "pod:bloom")
    if (f.get_size(), f.get_hash_iterations()) != (BLOOM_M, BLOOM_K):
        raise AssertionError("phase 23: the pod filter's geometry differs")
    if not np.array_equal(cells, ref_cells) or not np.array_equal(added, ref_added):
        raise AssertionError("phase 23: the pod Bloom's cells or added flags differ "
                             "from a single-card filter's")
    expect("phase 23 added keys contained", hits, BLOOM_KEYS)
    want = int(round(bloom_math.count_estimate(int(np.count_nonzero(ref_cells)),
                                               BLOOM_M, BLOOM_K)))
    expect("phase 23 pod Bloom count()", count, want)
    for k in ("bits_insert_segmented", "popcount_partials"):
        if not launches[k]:
            raise AssertionError(f"phase 23 bloom never launched {k}: {launches}")
    pd_metric(card, f"Bloom adds/s ({BLOOM_KEYS} keys over {PD_SHARDS} shards)",
              BLOOM_KEYS / fill_s)
    log(f"  pod bloom: cells and flags equal a single-card filter's; all {BLOOM_KEYS} "
        f"contained; count() {count}")
    c.delete("pod:bloom")
    return {"launches": launches, "adds_per_s": BLOOM_KEYS / fill_s}


def pd_bits(c, seed: int, card: str) -> dict:
    """Step 3: one 2^32-bit BitSet (4 GiB of cells, 2^30 per shard): SETBIT
    at each shard's first and last cell (2^32 - 1 among them) with GET of
    the old values, LENGTH 2^32, set_range(0, 2^31 + 2^20) inclusive and a
    BITCOUNT past 2^31 equal to the host's exact count; then BITOP OR and
    AND of two 2^27-bit days against numpy."""
    per = PD_BIG_BITS // PD_SHARDS
    edges = sorted({b for i in range(PD_SHARDS) for b in (i * per, (i + 1) * per - 1)})
    reset_all_launches()
    t = time.perf_counter()
    big = c.get_bit_set("pod:big")
    old = big.set_bits(edges)
    pd_blocks(card, "2^32-bit BitSet", c._pod_backend()._bits["pod:big"].state)
    again = big.set_bits(edges)
    if old.any() or not again.all() or not big.get_bits(edges).all():
        raise AssertionError("phase 23: SETBIT old values at the shard edges are wrong")
    expect("phase 23 LENGTH of the 2^32-bit BitSet", big.length(), PD_BIG_BITS)
    big.set_range(0, PD_RANGE_LAST + 1)
    total = big.cardinality()
    want = PD_RANGE_LAST + 1 + sum(1 for e in edges if e > PD_RANGE_LAST)
    expect("phase 23 BITCOUNT past 2^31 (int64 combine)", total, want)
    expect("phase 23 LENGTH after the range", big.length(), PD_BIG_BITS)
    big_s = time.perf_counter() - t
    c.delete("pod:big")
    days = day_ids(seed)[:2]
    t = time.perf_counter()
    for d, ids in enumerate(days):
        c.get_bit_set(f"pod:day{d}").set_bits(ids)
    por = c.get_bit_set("pod:or")
    por.or_("pod:day0", "pod:day1")
    pand = c.get_bit_set("pod:and")
    pand.or_("pod:day0")
    pand.and_("pod:day1")
    day_s = time.perf_counter() - t
    want_days = [np.zeros(DAY_BITS, np.uint8) for _ in days]
    for w, ids in zip(want_days, days):
        w[ids] = 1
    for name, w in (("pod:or", want_days[0] | want_days[1]),
                    ("pod:and", want_days[0] & want_days[1])):
        got = export_cells(c, name)
        if not np.array_equal(got[:DAY_BITS], w) or got[DAY_BITS:].any():
            raise AssertionError(f"phase 23: {name} differs from numpy")
        expect(f"phase 23 BITCOUNT of {name}", c.get_bit_set(name).cardinality(),
               int(w.sum()))
    launches = all_launches()
    for k in ("popcount_partials", "bitop_cells"):
        if not launches[k]:
            raise AssertionError(f"phase 23 bits never launched {k}: {launches}")
    pd_metric(card, "2^32-bit BitSet seconds (edges, LENGTH, 2^31-cell range, "
              "BITCOUNT)", big_s)
    pd_metric(card, f"two {DAY_BITS}-bit days, BITOP OR and AND seconds", day_s)
    log(f"  pod bits: BITCOUNT {total} of the 2^32-bit BitSet equals the host's "
        f"count, LENGTH 2^32; BITOP OR / AND of two days equal numpy")
    return {"launches": launches}


def pd_plane(cfg, data, card: str):
    """One data plane through phase 20's keys and layout: the RBatch of
    1024 + 64 {t} sketches, PD_PLANE_COUNTS PFCOUNTs (a cut of depth:
    every sketch's registers are compared), a PFMERGE over 1000 and its
    count, a cross-shard merge+count, the {t} countWith -> (the facade,
    results, registers by name)."""
    from redisson_tpu_torch.client import RedissonTorch

    names, batches, tags, tag_batches = data
    c = RedissonTorch.create(cfg)
    try:
        t = time.perf_counter()
        b = c.create_batch()
        for n, keys in zip(names + tags, batches + tag_batches):
            b.get_hyper_log_log(n).add_ints_async(keys)
        res = {"added": list(b.execute())}
        res["batch_s"] = time.perf_counter() - t
        res["counts"] = pd_counts(c, names[:PD_PLANE_COUNTS])
        t = time.perf_counter()
        c.get_hyper_log_log("union:cl").merge_with(*names[:MERGE_N])
        res["merge_ms"] = (time.perf_counter() - t) * 1e3
        res["merged"] = c.get_hyper_log_log("union:cl").count()
        res["merge_count"] = c.get_hyper_log_log("union:mc").merge_with_and_count(
            *names[MERGE_N:])
        res["tag_count"] = c.get_hyper_log_log(tags[0]).count_with(*tags[1:])
        regs = {n: c._dispatch.execute_sync(n, "hll_export", None)[0]
                for n in names + tags + ["union:cl", "union:mc"]}
    except BaseException:
        c.shutdown()
        raise
    return c, res, regs


def pd_free_rows(backend, shard: int) -> int:
    """Rows of `shard`'s preferred block that no sketch holds."""
    lo, hi = backend._sharded_bank.block(shard, backend._alloc.capacity)
    used = sum(1 for r in backend._alloc.rows.values() if lo <= r < hi)
    return hi - lo - used


def pd_mesh_migrate(c, data, seed: int, card: str) -> dict:
    """Step 5, last: shard 0's whole slot range migrates live to the shard
    whose preferred row block has the most free rows (so the relocation
    has room: a full block leaves rows in place, a placement hint) under
    two writers PFADDing into its sketches; every acknowledged PFADD
    present (a `sort` client fed the base keys and exactly the acknowledged
    batches), no future lost, rows relocated into the target's preferred
    range (across blocks, and across cards on several)."""
    import threading

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.ops.crc16 import key_slot

    names, batches = data[0], data[1]
    mgr = c.cluster
    backend = mgr.mesh_client._routing.sketch
    table = mgr.router.slot_table()
    src_slots = [s for s in range(16384) if table[s] == 0]
    hot = [n for n in names if table[key_slot(n)] == 0]
    free = {sid: pd_free_rows(backend, sid) for sid in range(1, PD_SHARDS)}
    target = max(free, key=free.get)
    lo, hi = backend._sharded_bank.block(target, backend._alloc.capacity)
    # Every sketch of the moving slots (the {t} and union rows too) whose
    # row lies outside the target's block; the writers make no new rows.
    movable = [n for n, r in backend._alloc.rows.items()
               if table[key_slot(n)] == 0 and not lo <= r < hi]
    acked, errors, done = [], [], threading.Event()
    start = threading.Barrier(3)

    def writer(w: int) -> None:
        start.wait(PD_WAIT_S)
        for i in range(CL_WRITE_MAX):
            if done.is_set() and i >= CL_WRITE_MIN:
                return
            name = hot[(w * 7 + i) % len(hot)]
            keys = keys_for((1 << 50) + (w * CL_WRITE_MAX + i) * CL_WRITE_KEYS,
                            CL_WRITE_KEYS, seed)
            try:
                c.get_hyper_log_log(name).add_ints(keys)
                acked.append((name, keys))
            except Exception as exc:  # noqa: BLE001 — a lost future fails below
                errors.append(repr(exc))

    threads = [threading.Thread(target=writer, args=(w,), daemon=True) for w in range(2)]
    for t in threads:
        t.start()
    start.wait(PD_WAIT_S)
    t0 = time.perf_counter()
    try:
        stats = mgr.migrate_slots(src_slots, target, timeout_s=PD_WAIT_S)
    finally:
        done.set()
    migrate_s = time.perf_counter() - t0
    for t in threads:
        t.join(PD_WAIT_S)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"phase 23: a writer's PFADD failed or hung: {errors[:3]}")
    post = mgr.router.slot_table()
    if any(post[s] != target for s in src_slots):
        raise AssertionError(f"phase 23: a migrated slot is not owned by shard {target}")
    placed = sum(1 for n in movable if lo <= backend._alloc.rows[n] < hi)
    expect("phase 23 rows relocated into the target's block",
           stats["bank_rows_relocated"], min(len(movable), free[target]))
    if placed < stats["bank_rows_relocated"]:
        raise AssertionError(f"phase 23: {placed} of the migrated rows lie in shard "
                             f"{target}'s block")
    ref = RedissonTorch.create(card_config("sort"))
    try:
        base = dict(zip(names, batches))
        futs = [ref.get_hyper_log_log(n).add_ints_async(base[n]) for n in hot]
        futs += [ref.get_hyper_log_log(n).add_ints_async(k) for n, k in acked]
        [f.result() for f in futs]
        bank, rows = ref.to_numpy_state()
    finally:
        ref.shutdown()
    got = {n: c._dispatch.execute_sync(n, "hll_export", None)[0] for n in hot}
    bad = [n for n in hot if not np.array_equal(got[n], bank[rows[n]])]
    if bad:
        raise AssertionError(f"phase 23: {len(bad)} migrated sketches lost an "
                             f"acknowledged PFADD, e.g. {bad[:3]}")
    pd_metric(card, "mesh migration of shard 0's range seconds", migrate_s)
    pd_metric(card, "mesh migration stats", json.dumps(stats))
    pd_metric(card, f"PFADDs acknowledged during it (2 writers, {CL_WRITE_KEYS} keys)",
              len(acked))
    log(f"  mesh migration: {len(src_slots)} slots ({len(hot)} sketches) shard 0 -> "
        f"{target} (free rows by block {free}) under 2 writers, {len(acked)} "
        f"acknowledged PFADDs all present; {stats['bank_rows_relocated']} rows "
        "relocated into its preferred range, across blocks")
    return {"migrate_s": migrate_s, "acked": len(acked), "stats": stats}


def pd_mesh(seed: int, card: str) -> dict:
    """Step 5: `use_cluster(num_shards=4, data_plane="mesh")` with phase
    20's keys and layout against the stacks plane on the same sequence
    (results and registers equal, as the JAX package's mode-parity test
    holds them); collective_merges > 0; mesh_occupancy() the live sketch
    count; then the live migration. The mesh plane's bank is one block per
    entry over min(4, cards) cards (four tensors of cuda:0 on one card);
    each block's card and bytes are printed."""
    import shutil

    from redisson_tpu_torch.config import Config

    data = cl_data(seed)

    def plane_config(plane: str):
        cfg = Config()
        cfg.use_cuda(ingest="segment")
        cfg.use_cluster(num_shards=PD_SHARDS, dir=os.path.join(PD_DIR, plane),
                        data_plane=plane)
        return cfg

    shutil.rmtree(PD_DIR, ignore_errors=True)
    stacks, s_res, s_regs = pd_plane(plane_config("stacks"), data, card)
    stacks.shutdown()
    reset_all_launches()
    mesh, m_res, m_regs = pd_plane(plane_config("mesh"), data, card)
    try:
        launches = all_launches()
        for k in ("added", "counts", "merged", "merge_count", "tag_count"):
            if m_res[k] != s_res[k]:
                raise AssertionError(f"phase 23: the mesh plane's {k} differs from the "
                                     "stacks plane's")
        bad = [n for n in s_regs if not np.array_equal(m_regs[n], s_regs[n])]
        if bad:
            raise AssertionError(f"phase 23: {len(bad)} mesh registers differ from the "
                                 f"stacks plane's, e.g. {bad[:3]}")
        mc = mesh.cluster.mesh_client
        be = mc._routing.sketch
        if be.counters["collective_merges"] < 1:
            raise AssertionError("phase 23: no merge took the mesh collective")
        bank, rows = mc.to_numpy_state()
        live = sum(1 for r in rows.values() if bank[r].any())
        expect("phase 23 mesh_occupancy()", be.mesh_occupancy(), live)
        expect("phase 23 live sketches", live, len(s_regs))
        if be.mesh.size != PD_SHARDS or not pd_placed([be.bank], be.mesh, be.store):
            raise AssertionError("phase 23: the mesh bank is not 4 blocks on their cards")
        if not launches["merge_stack"]:
            raise AssertionError(f"phase 23 mesh never launched merge_stack: {launches}")
        pd_blocks(card, "mesh bank", be.bank)
        info = mesh.cluster_info()
        pd_metric(card, "mesh RBatch seconds, stacks RBatch seconds",
                  f"{m_res['batch_s']} {s_res['batch_s']}")
        pd_metric(card, f"PFMERGE over {MERGE_N} ms: mesh collective, stacks host fold",
                  f"{m_res['merge_ms']} {s_res['merge_ms']}")
        pd_metric(card, "collective_merges, multi_shard_windows, cross_shard_merges",
                  f"{info['collective_merges']} {info['multi_shard_windows']} "
                  f"{info['cross_shard_merges']}")
        log(f"  mesh plane over {len(set(be.mesh.devices))} card(s): {len(s_regs)} "
            f"sketches' results and registers equal the stacks plane's; occupancy {live}")
        migration = pd_mesh_migrate(mesh, data, seed, card)
        launches = all_launches()
    finally:
        mesh.shutdown()
        shutil.rmtree(PD_DIR, ignore_errors=True)
    return {"launches": launches, "migration": migration,
            "merge_ms": m_res["merge_ms"], "batch_s": m_res["batch_s"]}


def pd_mesh_figures(mesh: dict) -> dict:
    """The mesh step's figures printed beside another run's."""
    return {"mesh_batch_s": mesh["batch_s"], "mesh_merge_ms": mesh["merge_ms"],
            "mesh_migrate_s": mesh["migration"]["migrate_s"]}


PD_ONE_CARD_TIMEOUT_S = 300
PD_WARM_ROWS = 80  # rows a block of the warm-up pod: past a 64-entry row list


def pd_warm() -> None:
    """A small pod on the phase's mesh, run once before the timed steps: a
    card's first launch of each kernel loads its module there, and its
    first peer copy opens the peer path, so each card's start-up stays
    out of the figures (on several cards, steps 1-3 are those cards' first
    work)."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_pod(num_shards=PD_SHARDS, bank_capacity=PD_SHARDS * PD_WARM_ROWS)
    c = RedissonTorch.create(cfg)
    try:
        be = c._pod_backend()
        names = [f"warm:{i}" for i in range(PD_SHARDS * PD_WARM_ROWS)]
        [f.result() for f in [c.get_hyper_log_log(n).add_ints_async(keys_for(i, 100, 0))
                              for i, n in enumerate(names)]]
        c.get_hyper_log_log(names[0]).add_all([b"warm"])
        c.get_hyper_log_log(names[0]).count()
        c.get_hyper_log_log(names[0]).count_with(*names[1:8])
        c.get_hyper_log_log(names[0]).merge_with_and_count(*names[1:])
        c._executor.execute_sync("", "hll_count_all", None)
        for n in (2, PD_SHARDS):
            c._executor.execute_barrier(lambda n=n: be.reshard(n)).result()
        bits = c.get_bit_set("warm:bits")
        bits.set_bits([0, 1 << 20])
        bits.cardinality()
        bits.length()
        dst = c.get_bit_set("warm:or")
        dst.or_("warm:bits")
        dst.and_("warm:bits")
        f = c.get_bloom_filter("warm:bloom")
        f.try_init(100_000, 0.01)
        f.add_ints(keys_for(0, 10_000, 0))
        f.contains_count_ints(keys_for(0, 10_000, 0))
        f.count()
    finally:
        c.shutdown()
    sync_cards()


def pod_one_card(seed: int) -> int:
    """`--pod-one-card`: phase 23's HLL step on a pod whose four entries
    are tensors of one card (run with CUDA_VISIBLE_DEVICES naming one
    card), held to its own `sort` reference, then the mesh plane's step 5
    there: the one-card figures the multi-card steps print beside their
    own. The last line is their JSON."""
    import torch
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"--pod-one-card sees {torch.cuda.device_count()} cards")
    card = card_line()
    ref = sort_reference(seed)
    pd_warm()
    cfg = Config()
    cfg.use_pod(num_shards=PD_SHARDS, bank_capacity=SKETCHES)
    c = RedissonTorch.create(cfg)
    try:
        got = pd_hll(c, ref, seed, card)
    finally:
        c.shutdown()
    figures = {k: got[k] for k in ("keys_per_s", "merge_ms", "reshard_s")}
    figures.update(pd_mesh_figures(pd_mesh(seed, card)))
    print(json.dumps(figures), flush=True)
    return 0


def pd_cards(seed: int, card: str, hll: dict) -> dict:
    """Step 4, with two cards or more: steps 1-3 ran over min(4, cards)
    cards (entry i on cuda:{i % cards}); the same HLL step runs again in a
    child process that sees one card (`--pod-one-card`), and the PFADD
    rate, PFMERGE+count ms and reshard seconds are printed side by side
    with every card's name and power limit."""
    import torch

    cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = (env.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--pod-one-card", "--seed", str(seed)],
        env=env, capture_output=True, text=True, timeout=PD_ONE_CARD_TIMEOUT_S)
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"  one card | {line}")
    if proc.returncode:
        raise AssertionError(f"phase 23: the one-card pod failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    one = json.loads(proc.stdout.strip().splitlines()[-1])
    where = f"{min(PD_SHARDS, cards)} of {cards} cards ({'; '.join(smi)})"
    pd_metric(card, f"PFADD keys/s, pod on {where} vs one card",
              f"{hll['keys_per_s']} {one['keys_per_s']}")
    pd_metric(card, f"PFMERGE+count over {MERGE_N} ms, pod on {where} vs one card",
              f"{hll['merge_ms']} {one['merge_ms']}")
    pd_metric(card, f"reshard seconds (to 2, back to 4), pod on {where} vs one card",
              f"{json.dumps(hll['reshard_s'])} {json.dumps(one['reshard_s'])}")
    return {"cards": cards, "one_card": one, "where": where}


def pod_path(seed: int, card: str, ref, ref_bloom) -> dict:
    """Phase 23: the pod tier (use_pod, 4 entries over the visible cards:
    four tensors of cuda:0 on one card) and the mesh data plane; each step
    resets the launch counters just before it and reads them just
    after."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    t_phase = time.perf_counter()
    log(f"phase 23 on {card}:")
    t = time.perf_counter()
    pd_warm()
    pd_metric(card, "warm-up pod seconds", time.perf_counter() - t)
    cfg = Config()
    cfg.use_pod(num_shards=PD_SHARDS, bank_capacity=SKETCHES)
    c = RedissonTorch.create(cfg)
    out, steps = {}, {}
    try:
        for name, fn in (("hll", lambda: pd_hll(c, ref, seed, card)),
                         ("bloom", lambda: pd_bloom(c, ref_bloom, seed, card)),
                         ("bits", lambda: pd_bits(c, seed, card))):
            t = time.perf_counter()
            out[name] = fn()
            steps[name] = round(time.perf_counter() - t, 3)
    finally:
        c.shutdown()
    import torch

    if torch.cuda.device_count() < 2:
        log(f"[{card}] phase 23 pod on several cards: not run for want of a second "
            f"card ({torch.cuda.device_count()} visible); steps 1-3 ran on four "
            "tensors of cuda:0")
    else:
        t = time.perf_counter()
        out["cards"] = pd_cards(seed, card, out["hll"])
        steps["cards"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["mesh"] = pd_mesh(seed, card)
    steps["mesh"] = round(time.perf_counter() - t, 3)
    what = f"mesh RBatch s, PFMERGE over {MERGE_N} ms, migration s: mesh plane on"
    mesh_fig = json.dumps(pd_mesh_figures(out["mesh"]))
    if "cards" in out:
        one = {k: v for k, v in out["cards"]["one_card"].items() if k.startswith("mesh_")}
        pd_metric(card, f"{what} {out['cards']['where']} vs one card",
                  f"{mesh_fig} {json.dumps(one)}")
    else:
        pd_metric(card, f"{what} 1 card", mesh_fig)
    pod_l = {}
    for step in ("hll", "bloom", "bits"):
        pod_l = add_launches(pod_l, out[step]["launches"])
    missing = [k for k in ("seg_insert", "merge_stack", "bits_insert_segmented",
                           "popcount_partials", "bitop_cells") if not pod_l[k]]
    if missing:
        raise AssertionError(f"phase 23 never launched {missing}: {pod_l}")
    out["launches"] = add_launches(pod_l, out["mesh"]["launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    pd_metric(card, "seconds by step", json.dumps(steps))
    pd_metric(card, "kernel launches", json.dumps(out["launches"]))
    pd_metric(card, "wall seconds", out["wall_s"])
    return out


def scatter_bloom(seed: int):
    """(cells, added) of the Bloom path's 10M adds on a single-card
    `scatter` client: phase 7's reference, made when phase 23 runs alone."""
    from redisson_tpu_torch.client import RedissonTorch

    ref = RedissonTorch.create(card_config("scatter"))
    try:
        _, added = bloom_fill(ref, "bloom", seed)
        return export_cells(ref, "bloom"), added
    finally:
        ref.shutdown()


# -- phase 24: the passthrough mode --------------------------------------------


def pt_metric(card: str, what: str, value) -> None:
    """One phase-24 number on its own line, beside the card it ran on."""
    log(f"[{card}] phase 24 {what}: {value}")


def pt_keys(i: int, seed: int) -> np.ndarray:
    return keys_for(i * PT_STRIDE, PT_KEYS, seed)


def pt_card_reference(seed: int):
    """A redis-family card client fed the phase's keys: (registers of the
    256 sketches, Bloom cells, contains of the probes, count()), made before
    the passthrough client's window."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    cfg = Config()
    cfg.use_cuda(hll_hash="redis", ingest="segment")
    c = RedissonTorch.create(cfg)
    try:
        names = [f"pt:{i}" for i in range(PT_SKETCHES)]
        futs = [c.get_hyper_log_log(n).add_ints_async(pt_keys(i, seed))
                for i, n in enumerate(names)]
        [f.result() for f in futs]
        regs = rd_rows(c, names)
        bf = c.get_bloom_filter("pt:bloom")
        bf.try_init(PT_BLOOM_N, PT_BLOOM_P)
        bf.add_ints(bloom_keys(0, PT_BLOOM_N, seed))
        probes = np.concatenate([bloom_keys(0, PT_PROBES, seed),
                                 bloom_keys(1 << 40, PT_PROBES, seed)])
        hits = bf.contains_ints(probes)
        return regs, export_cells(c, "pt:bloom"), probes, hits, bf.count()
    finally:
        c.shutdown()


def pt_structures(c) -> dict:
    """One round of the structures and coordination objects, each answer
    checked -> seconds per object."""
    import threading

    secs = {}

    def step(name, fn):
        t = time.perf_counter()
        fn()
        secs[name] = round(time.perf_counter() - t, 4)

    def rmap():
        m = c.get_map("pt:map")
        m.put_all({f"k{i}": i for i in range(100)})
        expect("phase 24 RMap get", m.get("k42"), 42)
        expect("phase 24 RMap size", m.size(), 100)

    def rqueue():
        q = c.get_blocking_queue("pt:queue")
        got = []
        t = threading.Thread(target=lambda: got.append(q.poll(timeout_s=PT_WAIT_S)))
        t.start()
        time.sleep(0.05)
        q.offer("item")
        t.join(PT_WAIT_S)
        expect("phase 24 RQueue blocking pop", got, ["item"])

    def locks():
        lk = c.get_lock("pt:lock")
        lk.lock()
        if not lk.is_locked():
            raise AssertionError("phase 24: RLock not held after lock()")
        lk.unlock()
        fl = c.get_fair_lock("pt:fair")
        if not fl.try_lock(1.0):
            raise AssertionError("phase 24: the fair lock was not acquired")
        fl.unlock()
        rw = c.get_read_write_lock("pt:rw")
        rw.read_lock().lock()
        rw.read_lock().unlock()
        rw.write_lock().lock()
        rw.write_lock().unlock()

    def semaphore_latch():
        s = c.get_semaphore("pt:sem")
        s.try_set_permits(2)
        if not (s.try_acquire() and s.try_acquire()) or s.try_acquire():
            raise AssertionError("phase 24: the semaphore handed out a wrong permit count")
        s.release()
        latch = c.get_count_down_latch("pt:latch")
        latch.try_set_count(1)
        latch.count_down()
        if not latch.await_(PT_WAIT_S):
            raise AssertionError("phase 24: the latch did not open")

    def topic():
        got, ev = [], threading.Event()
        tp = c.get_topic("pt:topic")
        tp.add_listener(lambda _ch, msg: (got.append(msg), ev.set()))
        tp.publish("hello")
        if not ev.wait(PT_WAIT_S) or got != ["hello"]:
            raise AssertionError(f"phase 24: the topic delivered {got}")

    def map_cache():
        mc = c.get_map_cache("pt:cache")
        mc.put("short", 1, ttl_s=0.2)
        mc.put("long", 2)
        time.sleep(0.3)
        mc.evict_expired()
        expect("phase 24 map cache after the TTL sweep",
               (mc.get("short"), mc.get("long")), (None, 2))

    def script():
        expect("phase 24 script", c.get_script().eval("return 6 * 7"), 42)

    for name, fn in (("map", rmap), ("blocking queue", rqueue), ("locks", locks),
                     ("semaphore and latch", semaphore_latch), ("topic", topic),
                     ("map cache", map_cache), ("script", script)):
        step(name, fn)
    return secs


def passthrough_path(seed: int, card: str) -> dict:
    """Phase 24: a config whose only section is redis against the port's
    EmbeddedRedis (redis's own HLL hash) in this process. Cuts, from
    BASELINE config 3 and phase 7: 4,000 keys per sketch (phase 20's wire
    cut: every key crosses the socket as a bulk string) and 100,000 Bloom
    adds (each a Lua-guarded SETBIT walk on the server, which is pure
    Python in one process). The mode holds nothing on the card:
    torch.cuda.memory_allocated() is the same before the client is made
    and after it shuts down."""
    import gc

    import torch

    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.interop import hyll
    from redisson_tpu_torch.interop.fake_server import EmbeddedRedis
    from redisson_tpu_torch.interop.resp_client import SyncRespClient

    t_phase = time.perf_counter()
    log(f"phase 24 on {card}:")
    regs, cells, probes, ref_hits, ref_count = pt_card_reference(seed)
    names = [f"pt:{i}" for i in range(PT_SKETCHES)]
    out = {}
    er = EmbeddedRedis(hll_hash="redis")
    rc = SyncRespClient(port=er.port, timeout=PT_TIMEOUT_MS / 1000.0)
    try:
        rc.connect()
        # The reference client's tensors may wait in reference cycles: free
        # them first, so the gate sees only the passthrough client.
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cfg = Config()
        r = cfg.use_redis()
        r.address = f"redis://127.0.0.1:{er.port}"
        r.timeout_ms = PT_TIMEOUT_MS
        c = RedissonTorch.create(cfg)
        try:
            if c.device is not None or c._store is not None:
                raise AssertionError("phase 24: the passthrough client holds a device")
            t = time.perf_counter()
            futs = [c.get_hyper_log_log(n).add_ints_async(pt_keys(i, seed))
                    for i, n in enumerate(names)]
            if not all(f.result() for f in futs):
                raise AssertionError("phase 24: a first PFADD reported no change")
            out["pfadd_s"] = time.perf_counter() - t
            counts = [c.get_hyper_log_log(n).count() for n in names]
            for i, (n, got) in enumerate(zip(names, counts)):
                if not np.array_equal(hyll.decode(rc.execute("GET", n)), regs[i]):
                    raise AssertionError(f"phase 24: the server's registers of {n} are "
                                         "not the card client's")
                want = int(round(hyll.estimate(regs[i])))
                if got != want:
                    raise AssertionError(f"phase 24: PFCOUNT of {n} is {got}, the "
                                         f"server fold of the card's registers {want}")
            bf = c.get_bloom_filter("pt:bloom")
            if not bf.try_init(PT_BLOOM_N, PT_BLOOM_P):
                raise AssertionError("phase 24: try_init of a fresh filter returned False")
            t = time.perf_counter()
            bf.add_ints(bloom_keys(0, PT_BLOOM_N, seed))
            out["bloom_add_s"] = time.perf_counter() - t
            t = time.perf_counter()
            hits = bf.contains_ints(probes)
            out["contains_s"] = time.perf_counter() - t
            if not np.array_equal(hits, ref_hits):
                raise AssertionError("phase 24: Bloom contains differ from the card's")
            expect("phase 24 Bloom count()", bf.count(), ref_count)
            blob = bytes(rc.execute("GET", "pt:bloom"))
            packed = np.packbits(cells).tobytes()
            if blob.rstrip(b"\0") != packed.rstrip(b"\0"):
                raise AssertionError("phase 24: the server's Bloom string is not the "
                                     "card's cells")
            out["structures"] = pt_structures(c)
        finally:
            c.shutdown()
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        expect("phase 24 card memory across the passthrough client's life", after, before)
    finally:
        rc.close()
        er.stop()
    out["wall_s"] = time.perf_counter() - t_phase
    pt_metric(card, f"server-side PFADD keys/s ({PT_SKETCHES} x {PT_KEYS})",
              PT_SKETCHES * PT_KEYS / out["pfadd_s"])
    pt_metric(card, f"Bloom adds/s ({PT_BLOOM_N}, Lua on the pure-Python server), "
              f"contains of {2 * PT_PROBES} seconds",
              f"{PT_BLOOM_N / out['bloom_add_s']} {out['contains_s']}")
    pt_metric(card, "structures and coordination seconds", json.dumps(out["structures"]))
    pt_metric(card, "card memory allocated before and after (bytes)", f"{before} {after}")
    pt_metric(card, "wall seconds", out["wall_s"])
    log(f"  passthrough: {PT_SKETCHES} server-side PFCOUNTs equal the card's fold, the "
        f"Bloom's contains and count equal the card's; nothing allocated on the card")
    return out


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


def phase_table(seed: int, card: str, deferred: list, out: dict) -> dict:
    """Phase name -> the call that runs it (reading earlier phases' results
    from `out`), in the order a whole run takes them."""
    return {
        "kernels": lambda: check_kernels(seed, deferred),
        "bits kernels": lambda: check_bits_kernels(seed, deferred),
        "delta kernels": lambda: check_delta_kernels(seed, deferred),
        "hll path": lambda: main_path(seed),
        "hll rates": lambda: rates(seed, card),
        "hll auto": lambda: auto_path(seed),
        "hll small vs cpu": lambda: small_vs_cpu(seed),
        "fpr probes": lambda: fpr_probes(seed),
        "bloom path": lambda: bloom_path(seed, out["fpr probes"]),
        "bloom rates": lambda: bloom_rates(seed, card, out["fpr probes"]),
        "bitset path": lambda: bitset_path(seed, card),
        "delta hll path": lambda: delta_hll_path(seed, out["hll path"][1]),
        "delta bloom path": lambda: delta_bloom_path(seed, out["bloom path"][1]),
        "delta bitset path": lambda: delta_bitset_path(seed),
        "mixed tape window": lambda: mixed_window(seed),
        "delta rates": lambda: delta_rates(seed, card),
        "batch path": lambda: batch_path(card),
        "structures": lambda: structures_path(out["batch path"][1], card),
        "durability": lambda: durability_path(seed, card),
        "serve": lambda: serve_path(seed, card, out["hll path"][1]),
        "replica": lambda: replica_path(seed, card),
        "cluster": lambda: cluster_path(seed, card),
        "geo": lambda: geo_path(seed, card, out["hll path"][1]),
        "redis": lambda: redis_path(seed, card),
        "pod": lambda: pod_path(seed, card, out["hll path"][1],
                                out["bloom path"][1]),
        "passthrough": lambda: passthrough_path(seed, card),
    }


#: what a phase run alone needs first: the phases whose results it reads
#: ("serve" reads only the unserved sort reference, made without phase 3)
PHASE_NEEDS = {"bloom path": ("fpr probes",), "bloom rates": ("fpr probes",),
               "delta hll path": ("hll path",),
               "delta bloom path": ("fpr probes", "bloom path"),
               "structures": ("batch path",)}


def no_jax_loaded() -> None:
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "redisson_tpu")
                    or m.startswith(("jax.", "redisson_tpu.")))
    if leaked:
        raise AssertionError(f"the port loaded JAX modules: {leaked[:5]}")


def run_phase(name: str, seed: int, card: str, phases: dict, out: dict) -> int:
    """`--phase NAME`: after the build, only the named phase (and what it
    reads), its launch counts, then the same last lines as a whole run
    without the kernels line."""
    import torch

    if name not in phases:
        print(f"chip_smoke: no phase {name!r}; phases: {', '.join(phases)}",
              file=sys.stderr)
        return 2
    if name in ("serve", "geo", "pod"):
        out["hll path"] = (None, sort_reference(seed))
    if name == "pod":
        out["bloom path"] = (None, scatter_bloom(seed))
    for dep in PHASE_NEEDS.get(name, ()):
        out[dep] = phases[dep]()
    t = time.perf_counter()
    out[name] = phases[name]()
    log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    if name == "serve":
        launches, served, _ = out[name]
        try:
            serve_profile(served, seed, card)
        finally:
            served.shutdown()
        log(f"phase serve launches: {json.dumps(launches)}")
    if name == "replica":
        log(f"phase replica launches: {json.dumps(out[name]['launches'])}")
    if name == "cluster":
        log(f"phase cluster launches: {json.dumps(out[name]['launches'])}")
    if name in ("geo", "redis", "pod"):
        log(f"phase {name} launches: {json.dumps(out[name]['launches'])}")
    if "batch path" in out:
        out["batch path"][1].shutdown()
    no_jax_loaded()
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace short HLL and Bloom windows with torch.profiler")
    ap.add_argument("--merge-pair", metavar="TREE",
                    help="only time the client's merge call of the package in TREE (a "
                         "checkout of this or another commit), for a paired comparison")
    ap.add_argument("--phase", metavar="NAME",
                    help="only build the kernels and run the phase NAME (a key of "
                         "phase_table, e.g. serve), with the phases whose results it "
                         "reads (PHASE_NEEDS)")
    ap.add_argument("--pod-one-card", action="store_true",
                    help="phase 23's HLL step on a one-card pod, for the multi-card "
                         "step's comparison (run with CUDA_VISIBLE_DEVICES naming one card)")
    ap.add_argument("--child-writer", metavar="DIR",
                    help="phase 15's writer role: reopen the persist directory DIR and "
                         "write acknowledged batches until killed")
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
    if args.child_writer:
        return child_writer(args.child_writer, args.seed)
    if args.pod_one_card:
        return pod_one_card(args.seed)

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
    out = {}
    phases = phase_table(args.seed, card, deferred, out)
    if args.phase:
        return run_phase(args.phase, args.seed, card, phases, out)
    for name, fn in phases.items():
        t = time.perf_counter()
        out[name] = fn()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    # Once torch.profiler has run in a process, every later launch costs the
    # host more: the device-only times come after every host-timed phase.
    t = time.perf_counter()
    for what, row, key, fn, src, reps in deferred:
        row[key], parts = device_ms(fn, [src.clone() for _ in range(reps + 1)],
                                    counted=(key.startswith("device_ms")
                                             and getattr(fn, "counted", True)))
        if CUDA_EVENTS in parts:  # says so in the kernels line too
            row[key.replace("_ms", "_src")] = "cuda events"
        log(f"{what}: device-only {row[key]:.5f} ms per call, by event: "
            + json.dumps(parts))
    del deferred
    log(f"phase device times: {time.perf_counter() - t:.1f} s")
    out["kernels"][1]["client_merge_window"] = merge_window(out["batch path"][1])
    serve_l, served, _ = out["serve"]
    try:
        serve_profile(served, args.seed, card)
    finally:
        served.shutdown()
    if args.profile:
        profile_path(args.seed)
    out["batch path"][1].shutdown()
    seg, mrg = out["kernels"]
    pop, bop, bseg = out["bits kernels"]
    dmerge, wmerge = out["delta kernels"]
    # Phase 15's recovery and the checks after it, and phase 16.
    dur_l = out["durability"]["recovery"]["launches"]
    # Phase 19: the follower's replay, the fleet's replica reads, the facades.
    rep_l = out["replica"]["launches"]
    # Phase 20: the cluster's PFADDs, merges, bits, migrations, the HA
    # cluster's writes, replay and failover, and the wire.
    cl_l = out["cluster"]["launches"]
    # Phase 21: both geo sites' local writes and remote applies.
    geo_l = out["geo"]["launches"]
    # Phase 22: the durability tier's fill, reads and reload.
    rd_l = out["redis"]["launches"]
    # Phase 23: the pod tier's per-shard launches and the mesh plane's.
    pd_l = out["pod"]["launches"]
    launches = add_launches(add_launches(out["hll path"][0], out["batch path"][0]),
                            add_launches(add_launches(dur_l, serve_l),
                                         add_launches(rep_l, cl_l)))
    launches = add_launches(add_launches(add_launches(launches, geo_l), rd_l), pd_l)
    bloom_l, bitset_l = out["bloom path"][0], out["bitset path"]
    delta_l = [out[p] for p in ("delta hll path", "delta bloom path",
                                "delta bitset path", "mixed tape window")] + [dur_l, geo_l,
                                                                           pd_l]

    no_jax_loaded()

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
             launches=(bloom_l["bits_insert_segmented"] + dur_l["bits_insert_segmented"]
                       + serve_l["bits_insert_segmented"]
                       + rep_l["bits_insert_segmented"]
                       + cl_l["bits_insert_segmented"]
                       + geo_l["bits_insert_segmented"]
                       + rd_l["bits_insert_segmented"]
                       + pd_l["bits_insert_segmented"]),
             **bseg),
        dict(name="popcount_partials", route="cuda", source=src + "popcount.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:172",
             launches=(bloom_l["popcount_partials"] + bitset_l["popcount_partials"]
                       + dur_l["popcount_partials"] + serve_l["popcount_partials"]
                       + rep_l["popcount_partials"] + cl_l["popcount_partials"]
                       + geo_l["popcount_partials"] + rd_l["popcount_partials"]
                       + pd_l["popcount_partials"]),
             **pop),
        dict(name="bitop_cells", route="cuda", source=src + "bitop.cu",
             replaces="redisson_tpu/ops/pallas_kernels.py:223",
             launches=(bitset_l["bitop_cells"] + dur_l["bitop_cells"]
                       + cl_l["bitop_cells"] + pd_l["bitop_cells"]), **bop),
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
