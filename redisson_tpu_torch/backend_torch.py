"""The sketch backend: executes op runs against the HLL bank and the store's
BitSet / Bloom cell tensors (counterpart of `redisson_tpu.backend_tpu`).

The dispatcher thread pads each coalesced key batch to a bucket, launches
the engine's kernels on the device (PyTorch returns before the device
finishes), commits the new state, and hands the results to the completer
thread, which waits for them and completes the op futures.

CUDA from threads: the dispatcher, the completer and the staging worker
each make the backend's device current before touching it, and results
reach the completer through a non-blocking copy into pinned memory plus a
CUDA event, never a device-wide synchronize.

The group-coalesced write kinds (`hll_add`, `bloom_add`, `bitset_set`)
share one steal group (`COALESCE_GROUPS`): a run may mix them across
targets. `_delta_dispatch` folds the groups the delta planner takes on the
host (`ingest/delta.py`, the host fold library `native.py`) and retires the
window through the `delta_merge` kernel in as few stacked launches as the
cell budget allows, or under `ingest="tape"` through one `window_merge`
launch (`ingest/tape.py`); the other groups go to `_classic_group_run`.
A Bloom filter may also be served from a packed host mirror (the Bloom
host mirror section), synced to the device before any device-side op.

`geo_merge` (a remote site's pre-folded delta plane, geo/) shares the
steal group: its groups skip the planner and retire through the same
`delta_merge` launches as local writes, never through a tape window
(`_geo_fold_group`); `_op_geo_merge` is the classic fallback (counted in
`geo_classic`), and `_op_geo_replace` / `_op_geo_delete` /
`_op_geo_flush` install the applier's LWW decisions.

Mesh data plane (cluster `data_plane="mesh"`): `attach_mesh` puts the
still-lazy bank onto a logical mesh (`parallel/mesh.ShardedBank`): the bank
is a `parallel.mesh.Sharded`, one block of rows per mesh entry on that
entry's device (four tensors of one card on one card), which every
`engine.hll_bank_*` function takes. Rows are allocated in the owning
logical shard's preferred row range, PFMERGE / countWith / the fused
merge+count run as the engine's mesh collectives (per-block merge_stack
folds, a max across blocks), device inserts run per block on each block's
card, and a tape window or delta chunk, which mixes bank rows with the
store's cells on home, gathers its rows to home for its one launch and
writes them back block by block. The tape stamps each entry's logical
shard in its shard column.
"""

from __future__ import annotations

import fnmatch
import functools
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np
import torch

from redisson_tpu_torch import config as config_mod
from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch import engine, native
from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.fault.taxonomy import classify
from redisson_tpu_torch.ingest import delta as delta_mod
from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ingest import tape as tape_mod
from redisson_tpu_torch.ingest.pipeline import StagingPipeline
from redisson_tpu_torch.ingest.planner import IngestPlanner, default_planner
from redisson_tpu_torch.ops import bitset as bitset_ops
from redisson_tpu_torch.ops import bloom as bloom_ops
from redisson_tpu_torch.ops import bloom_math
from redisson_tpu_torch.parallel import sharded
from redisson_tpu_torch.parallel.mesh import Sharded
from redisson_tpu_torch.store import ObjectType, SketchStore, WrongTypeError


class Completer:
    """Resolves op futures off the dispatcher thread, in submission order.

    The dispatcher only launches work; each run's results go to this single
    FIFO thread, which waits for them and completes the futures. The queue
    is bounded, so a free-running producer blocks once `maxsize`
    completions are pending (soft backpressure).
    """

    def __init__(self, device: torch.device, maxsize: int = 64):
        self._device = device
        self._q: "queue.Queue[Callable]" = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(
            target=self._loop, name="redisson-torch-completer", daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def _loop(self):
        device_mod.bind_thread(self._device)
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001
                # Completion closures own their futures and resolve them on
                # error; re-raising would only kill this thread.
                pass
            finally:
                self._q.task_done()

    def drain(self):
        """Block until every submitted completion has run."""
        self._q.join()

    def shutdown(self):
        self.drain()
        self._q.put(None)
        self._thread.join()


class Readback:
    """A device->host copy started now and waited for later: a non-blocking
    copy into pinned memory plus a CUDA event on the current stream (on the
    CPU, the tensor itself)."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t
            self.event = None

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _fail(ops: List[Op], exc: BaseException) -> None:
    for op in ops:
        if not op.future.done():
            op.future.set_exception(exc)


def _fire_d2h(kind: str, target: str) -> None:
    """The d2h_complete seam, fired on the completer before a readback is
    waited for (where a CUDA error of the run surfaces)."""
    fault_inject.fire("d2h_complete", kind=kind, target=target)


def _fire_d2h_ops(ops: List[Op]) -> None:
    _fire_d2h(ops[0].kind if ops else "", ops[0].target if ops else "")


def _trace_cache(ops: List[Op], hit: bool) -> None:
    """Stamp a read-cache hit or miss on the sampled trace spans riding
    `ops` (replayed or synthetic ops may lack the attribute)."""
    name = "cache_hit" if hit else "cache_miss"
    for op in ops:
        span = getattr(op, "span", None)
        if span is not None and span.t1 is None:
            span.event(name)
            span.annotations.setdefault("read_cache", "hit" if hit else "miss")


def _complete_all(ops: List[Op], materialize: Callable[[], object]) -> Callable:
    """Closure completing every op with materialize()'s value (or error)."""

    def run():
        try:
            _fire_d2h_ops(ops)
            value = materialize()
        except Exception as exc:  # noqa: BLE001 — device errors surface here
            # Post-dispatch: the run already launched, so a transient error
            # here means its commit state is unknown. classify maps it to
            # StateUncertainFault and the executor's fault listener routes
            # the targets to the rebuild path.
            _fail(ops, classify(exc, seam="d2h_complete"))
            return
        for op in ops:
            if not op.future.done():
                op.future.set_result(value)

    return run


def _estimate(rb: Readback) -> int:
    return int(round(float(rb.wait())))


def complete_changed_rows(completer: Completer, ops: List[Op],
                          rows: List[int], parts) -> None:
    """Complete a coalesced insert run with per-target PFADD semantics: the
    kernels return changed-rows vectors, and each op's bool is its own
    target's lane."""
    flag = None
    if parts:
        flag = Readback(functools.reduce(torch.logical_or, parts))

    def run():
        try:
            _fire_d2h_ops(ops)
            host = None if flag is None else flag.wait().numpy()
        except Exception as exc:  # noqa: BLE001
            _fail(ops, classify(exc, seam="d2h_complete"))
            return
        for op, r in zip(ops, rows):
            if not op.future.done():
                op.future.set_result(False if host is None else bool(host[r]))

    completer.submit(run)


class EpochReadCache:
    """Epoch-stamped memo for device-read results: every target carries a
    write epoch, and a read result (PFCOUNT) is valid exactly while its
    target's epoch is unchanged. Lookups happen on the dispatcher, `put` on
    the completer (stamped with the epoch captured at dispatch, so a racing
    write can never make a stale value servable); a small lock covers both.
    """

    _MISS = object()

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max(0, int(max_entries))
        self._lock = threading.Lock()
        self._data: "OrderedDict" = OrderedDict()  # (target, kind, extra) -> (epoch, value)
        self.hits = 0
        self.misses = 0

    def get(self, target: str, kind: str, epoch: int, extra=None):
        """Cached value at `epoch`, else the miss marker (see `is_hit`)."""
        if self.max_entries == 0:
            return self._MISS
        key = (target, kind, extra)
        with self._lock:
            ent = self._data.get(key)
            if ent is not None and ent[0] == epoch:
                self._data.move_to_end(key)
                self.hits += 1
                return ent[1]
            self.misses += 1
            return self._MISS

    def is_hit(self, value) -> bool:
        return value is not self._MISS

    def put(self, target: str, kind: str, epoch: int, value, extra=None) -> None:
        if self.max_entries == 0:
            return
        key = (target, kind, extra)
        with self._lock:
            ent = self._data.get(key)
            if ent is not None and ent[0] > epoch:
                return  # a fresher write already stamped this slot
            self._data[key] = (epoch, value)
            self._data.move_to_end(key)
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)

    def invalidate(self, target: str) -> None:
        with self._lock:
            for k in [k for k in self._data if k[0] == target]:
                del self._data[k]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def content_bytes(self) -> int:
        """Bytes held by cached values (the memstat 'cache' meter): arrays
        and tensors count their nbytes, scalars 8."""
        with self._lock:
            values = [v for _, v in self._data.values()]
        total = 0
        for v in values:
            nb = getattr(v, "nbytes", None)
            total += int(nb) if nb is not None else 8
        return total


class RowAllocator:
    """name -> bank-row bookkeeping: free-list reuse, elastic grow-on-full,
    per-name mutation counters. `grow` reallocates the bank at the requested
    capacity and returns the actual capacity."""

    __slots__ = ("rows", "free", "next", "versions", "capacity", "_grow")

    def __init__(self, capacity: int, grow: Callable[[int], int]):
        self.rows: dict = {}
        self.free: list = []
        self.next = 0
        self.versions: dict = {}
        self.capacity = capacity
        self._grow = grow

    def row_of(self, name: str, prefer=None) -> int:
        row = self.rows.get(name)
        if row is not None:
            return row
        if prefer is not None:
            row = self.claim_range(*prefer)
            if row is not None:
                self.rows[name] = row
                return row
        if self.free:
            row = self.free.pop()
        else:
            if self.next >= self.capacity:
                self.capacity = self._grow(self.capacity * 2)
            row = self.next
            self.next += 1
        self.rows[name] = row
        return row

    def claim_range(self, lo: int, hi: int) -> Optional[int]:
        """Allocate a free row inside [lo, hi), or None when the range is
        full (mesh plane row placement: a shard's preferred row block;
        callers fall back to allocation anywhere on None)."""
        for i, r in enumerate(self.free):
            if lo <= r < hi:
                return self.free.pop(i)
        if lo <= self.next < hi:
            row = self.next
            self.next += 1
            return row
        if self.next < lo <= hi - 1 and hi <= self.capacity:
            # Skip the watermark forward into the block; the skipped rows
            # stay allocatable through the free list.
            self.free.extend(range(self.next, lo))
            self.next = lo + 1
            return lo
        return None

    def release(self, name: str) -> Optional[int]:
        """Free the name's row for reuse; returns it (None if absent)."""
        row = self.rows.pop(name, None)
        if row is not None:
            self.free.append(row)
            self.versions.pop(name, None)
        return row

    def bump(self, name: str) -> None:
        self.versions[name] = self.versions.get(name, 0) + 1

    def clear(self) -> None:
        self.rows.clear()
        self.free.clear()
        self.versions.clear()
        self.next = 0


class LinkProfile:
    """One measurement of the host->device link and of the host fold.

    On a card behind PCIe, raw keys (8 B/key) belong on the device, where
    hashing runs at memory speed; behind a slow link, folding on the host
    and shipping a 16 KB sketch wins. This probe decides which, once per
    device: a round trip (upload, a device reduce, a scalar back) of an
    incompressible 8 MB buffer against a 4 KB one, whose difference cancels
    the fixed sync cost, and the host fold library's ns per key.
    """

    def __init__(self, device: torch.device):
        rng = np.random.default_rng(0)
        pin = device.type == "cuda"
        small = torch.from_numpy(rng.integers(0, 256, 1 << 12, np.uint8))
        big = torch.from_numpy(rng.integers(0, 256, 1 << 23, np.uint8))
        if pin:
            small, big = small.pin_memory(), big.pin_memory()

        def roundtrip(buf):
            t0 = time.perf_counter()
            int(buf.to(device, non_blocking=pin).sum(dtype=torch.int64))
            return time.perf_counter() - t0

        roundtrip(small), roundtrip(big)  # warm the path and the allocator
        t_small = min(roundtrip(small) for _ in range(2))
        t_big = min(roundtrip(big) for _ in range(2))
        self.transfer_ns_per_byte = max(
            (t_big - t_small) * 1e9 / (big.numel() - small.numel()), 0.001)
        self.fold_ns_per_key = float("inf")
        if native.available():
            keys = np.arange(1 << 19, dtype=np.uint64)
            regs = np.zeros(delta_mod.HLL_M, np.uint8)
            native.hll_fold_u64(keys, regs, 0)  # warm
            t0 = time.perf_counter()
            native.hll_fold_u64(keys, regs, 0)
            self.fold_ns_per_key = (time.perf_counter() - t0) * 1e9 / keys.shape[0]

    @property
    def prefer_hostfold(self) -> bool:
        return self.fold_ns_per_key < self.transfer_ns_per_byte * 8


_LINK_PROFILES: dict = {}
_LINK_LOCK = threading.Lock()


def link_profile(device: torch.device) -> LinkProfile:
    with _LINK_LOCK:
        prof = _LINK_PROFILES.get(device)
        if prof is None:
            prof = _LINK_PROFILES[device] = LinkProfile(device)
        return prof


# Below this many keys per-run fixed costs (launches, the 16 KB sketch
# transfer) dominate either way, and the raw-key path is kept.
HOSTFOLD_MIN_KEYS = 1 << 16


def hostfold_policy(ingest: str, nkeys: int, device: torch.device) -> bool:
    """Whether a Bloom batch adopts the host mirror: always under
    "hostfold", under "auto" for a large batch when the link profile says
    so, never without the fold library or under any other forced ingest
    (the JAX policy also lets a forced device insert adopt the mirror; here
    a forced device insert stays on the device, as the HLL path's does)."""
    if not native.available():
        return False
    if ingest == "hostfold":
        return True
    if ingest != "auto" or nkeys < HOSTFOLD_MIN_KEYS:
        return False
    return link_profile(device).prefer_hostfold


def _as_i64(packed: np.ndarray) -> np.ndarray:
    """The [n, 2] uint32 (lo, hi) key layout viewed as n int64 keys."""
    return np.ascontiguousarray(packed).view(np.int64).reshape(-1)


def _format_runs(ops: List[Op]):
    """Split a coalesced run into consecutive same-format groups (packed vs
    bytes), preserving op order so positional result slicing stays valid."""
    runs: List = []
    for op in ops:
        fmt = "packed" if "packed" in op.payload else "bytes"
        if runs and runs[-1][0] == fmt:
            runs[-1][1].append(op)
        else:
            runs.append((fmt, [op]))
    return runs


def _segments(arrays: List[np.ndarray], small: int) -> List[np.ndarray]:
    """Group key arrays for dispatch: runs of small arrays concatenate into
    one bucket-bound buffer, large arrays pass through untouched."""
    out, pending, pending_rows = [], [], 0
    for a in arrays:
        if a.shape[0] >= small:
            if pending:
                out.append(np.concatenate(pending))
                pending, pending_rows = [], 0
            out.append(a)
        else:
            pending.append(a)
            pending_rows += a.shape[0]
            if pending_rows >= small:
                out.append(np.concatenate(pending))
                pending, pending_rows = [], 0
    if pending:
        out.append(pending[0] if len(pending) == 1 else np.concatenate(pending))
    return out


def _lanes_of(op: Op) -> int:
    p = op.payload
    for key in ("idx", "packed", "data"):
        if key in p:
            return p[key].shape[0]
    return 0


class TorchBackend:
    """Op interpreter over a shared HLL bank: every named HLL is a row of
    ONE [S, m] int32 tensor on `store.device`, so countWith/mergeWith over
    hundreds of sketches is one row-max over a row vector. hll_add coalesces across
    targets (one device call carries keys for many sketches through a
    per-key row vector)."""

    GLOBAL_COALESCE = frozenset({"hll_add", "bloom_add", "bitset_set",
                                 "geo_merge"})

    #: the executor's steal alias: the three delta kinds share one gate
    #: group, so one window may hold hll_add, bloom_add and bitset_set runs
    #: of many targets and retire them in one merge launch; geo_merge (a
    #: remote site's pre-folded plane, geo/) shares it, so remote
    #: convergence rides the same launch as local writes
    COALESCE_GROUPS = {"hll_add": "delta", "bloom_add": "delta",
                       "bitset_set": "delta", "geo_merge": "delta"}

    #: cell budget (padded T x padded L uint8 cells) of one merge launch; a
    #: window whose planes exceed it splits into several launches
    DELTA_STACK_CELLS = 1 << 26

    #: the device index math (ops/bloom._mod_u64) is exact only for
    #: m <= 2^31 or a power-of-two m, so the models size-check eagerly
    BLOOM_STRICT_MOD = True

    #: run() commits all observable state (bank writes, row versions) on the
    #: dispatcher thread before returning; only result readback trails on
    #: the completer, so the executor may pipeline runs.
    DISPATCH_TIME_STATE = True

    def __init__(self, store: SketchStore, hll_impl: str = "scatter",
                 seed: int = 0, ingest: str = "auto", bank_capacity: int = 256,
                 hll_hash: str = "murmur3",
                 planner: Optional[IngestPlanner] = None,
                 read_cache_entries: int = 1024):
        config_mod.check_ingest(ingest)
        if hll_impl not in config_mod.HLL_IMPLS:
            raise ValueError(f"unknown hll_impl: {hll_impl!r}")
        if hll_hash not in config_mod.HLL_HASHES:
            raise ValueError(f"unknown hll_hash family: {hll_hash!r}")
        self.family = "m3" if hll_hash == "murmur3" else "redis"
        if ingest in config_mod.HOST_INGEST:
            if self.family == "redis":
                raise ValueError(
                    f"hll_hash='redis' is incompatible with ingest={ingest!r} "
                    "(the host fold implements the murmur3 family); use "
                    "ingest='device' or 'auto'")
            if not native.available():
                # A forced host-side path that cannot run must not quietly
                # become the raw-key path it was chosen to avoid.
                raise RuntimeError(
                    f"ingest={ingest!r} needs the host fold library "
                    "(redisson_tpu_torch/csrc/host_fold.cpp failed to build "
                    "or load); use ingest='auto' to fall back")
        self.store = store
        self.device = store.device
        self.hll_impl = hll_impl
        self.seed = seed
        self.ingest = ingest
        self.planner = planner or default_planner(self.device)
        # Staging of chunk N+1 overlaps dispatch of chunk N; on a card the
        # H2D copies run on their own stream.
        self._pipeline = StagingPipeline(depth=2)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.completer = Completer(self.device)
        self.bank: Optional[torch.Tensor] = None  # lazy [S, m] int32
        self._alloc = RowAllocator(max(1, bank_capacity), self._grow_bank)
        # name -> packed host replica of a Bloom filter (host mirror section)
        self._bloom_mirrors: dict = {}
        # Per-name write epochs: the read cache's whole invalidation protocol.
        self._epochs: dict = {}
        self.read_cache = EpochReadCache(read_cache_entries)
        # Delta-ingest counters, cumulative (read through ingest_stats()).
        self.counters = {
            "link_bytes": 0,      # delta bytes shipped host -> device
            "raw_bytes": 0,       # bytes the raw-key path would have shipped
            "delta_fold_s": 0.0,  # host fold wall time (dispatcher side)
            "merge_launches": 0,  # delta_merge / window_merge launches
            "delta_runs": 0,      # windows retired through delta_merge
            "delta_keys": 0,      # keys folded into delta planes
            "tape_runs": 0,       # windows retired through window_merge
            "window_launches": 0,  # device calls issued retiring windows
            "launch_us": 0.0,     # host wall time spent issuing them
            "delta_scratch_bytes": 0,  # in-flight delta plane bytes (meter)
            "geo_planes": 0,      # remote site planes through delta_merge
            "geo_classic": 0,     # remote planes absorbed by the fallback
            "collective_merges": 0,    # PFMERGE / count runs via mesh collectives
            "multi_shard_windows": 0,  # tape windows spanning > 1 shard
        }
        self._scratch_lock = threading.Lock()
        # memstat ledger (MemLedger-shaped) or None: the bank's size is
        # reported on every creation, growth, install and flushall.
        self.accounting = None
        # Mesh data plane: attach_mesh installs the ShardedBank geometry
        # before the lazy bank exists; None in every other mode.
        self.mesh = None
        self._sharded_bank = None
        self._shard_of = None

    # row-map views
    @property
    def _rows(self) -> dict:
        return self._alloc.rows

    @property
    def _row_versions(self) -> dict:
        return self._alloc.versions

    @property
    def bank_capacity(self) -> int:
        return self._alloc.capacity

    @bank_capacity.setter
    def bank_capacity(self, v: int) -> None:
        self._alloc.capacity = v

    def attach_mesh(self, mesh, num_shards: int, shard_of=None) -> None:
        """Put the (still lazy) HLL bank onto a logical mesh: its row
        blocks are the mesh entries' shards, and each logical shard has a
        preferred row block so its sketches stay in one entry's rows.
        `shard_of` maps a target name to its logical shard (the tape's
        shard column, the per-shard memstat attribution). Must be called
        before the first bank-touching op (the client wires it right after
        construction, before the executor starts). The mesh's home is the
        backend's device: the store, the tape's windows and the
        collectives' combines live there."""
        from redisson_tpu_torch.parallel.mesh import ShardedBank

        if self.bank is not None:
            raise RuntimeError("attach_mesh: bank already materialized")
        if mesh.home != self.device:
            raise ValueError(f"attach_mesh: mesh home {mesh.home}, backend on "
                             f"{self.device}")
        sb = ShardedBank(mesh, self._alloc.capacity, num_shards)
        self.mesh = mesh
        self._sharded_bank = sb
        self._shard_of = shard_of
        self._alloc.capacity = sb.capacity

    def mesh_relocate(self, names, target_shard: int) -> int:
        """Device-side bank-row relocation for mesh-mode slot migration:
        move each name's registers into the adopting shard's preferred row
        range (copy the row, across blocks and cards where they differ;
        zero the old one; remap the allocator). Runs on
        the dispatcher (executor.execute_barrier): the caller's journaled
        flip fence orders it against in-flight windows. A full target block
        leaves rows in place (placement is a hint; the collectives select
        by row index, so results are unchanged). Returns rows moved."""
        sb = self._sharded_bank
        if sb is None or self.bank is None:
            return 0
        lo, hi = sb.block(int(target_shard), self._alloc.capacity)
        moved = 0
        for name in names:
            row = self._alloc.rows.get(name)
            if row is None or lo <= row < hi:
                continue
            new = self._alloc.claim_range(lo, hi)
            if new is None:
                break
            self.bank = sharded.copy_row(self.bank, row, new)
            self.bank = engine.hll_bank_zero_row(self.bank, row)
            self._alloc.rows[name] = new
            self._alloc.free.append(row)
            self._bump(name)
            moved += 1
        if moved:
            self._account_bank()
        return moved

    def mesh_occupancy(self) -> int:
        """Mesh-wide non-empty bank row count (the DBSIZE analogue for the
        sharded bank); 0 off-mesh or before the bank exists."""
        if self.mesh is None or self.bank is None:
            return 0
        return int(engine.hll_bank_occupancy_collective(self.bank,
                                                         mesh=self.mesh))

    def _grow_bank(self, new_cap: int) -> int:
        """RowAllocator grow hook: reallocate the bank at `new_cap` rows
        (rounded to a multiple of the mesh size in mesh mode, where the
        blocks follow the new capacity as JAX's re-placement does)."""
        sb = self._sharded_bank
        if sb is not None:
            new_cap = sb.round_capacity(new_cap)
            sb.capacity = new_cap
        self.bank = engine.hll_bank_grow(self._ensure_bank(), new_cap)
        self._account_bank()
        return new_cap

    def _ensure_bank(self):
        """The bank, made on first use: a tensor, or the mesh plane's
        `Sharded` of zero blocks."""
        if self.bank is None:
            sb = self._sharded_bank
            if sb is not None:
                self.bank = sharded.make_bank(sb.mesh, sb.capacity)
            else:
                self.bank = engine.hll_bank_make(self.bank_capacity,
                                                 device=self.device)
            self._account_bank()
        return self.bank

    def _account_bank(self) -> None:
        """Report the bank's bytes to the memstat ledger. Rows are written
        in place, so only creation, growth, an installed bank, a mesh row
        relocation and flushall change them, and each of those calls here.
        In mesh mode the bank is reported per logical shard: each allocated
        row's bytes go to the shard owning its name, so memory_stats()
        rollups stay exact per shard."""
        acct = self.accounting
        if acct is None:
            return
        nbytes = int(self.bank.nbytes) if self.bank is not None else 0
        if self._sharded_bank is None:
            acct.set_bank_bytes(nbytes)
            return
        row_bytes = nbytes // max(self._alloc.capacity, 1) if nbytes else 0
        shard_of = self._shard_of
        by_shard: dict = {}
        for name in self._alloc.rows:
            shard = int(shard_of(name)) if shard_of is not None else 0
            by_shard[shard] = by_shard.get(shard, 0) + row_bytes
        acct.set_bank_shard_bytes(
            by_shard, unassigned=nbytes - row_bytes * len(self._alloc.rows))

    def scratch_bytes(self) -> dict:
        """Scratch byte meters (the memstat 'scratch' category): the Bloom
        host mirrors and the delta planes in flight."""
        mirrors = 0
        for m in list(self._bloom_mirrors.values()):
            bits = m.get("bits") if isinstance(m, dict) else None
            mirrors += int(getattr(bits, "nbytes", 0) or 0)
        with self._scratch_lock:
            delta = self.counters["delta_scratch_bytes"]
        return {"bloom_mirrors": mirrors, "delta_scratch": delta}

    def _plan_ingest(self, nkeys: int, allow_delta: bool = False) -> str:
        """One run's HLL insert: 'delta' | 'tape' | 'hostfold' or a device
        insert ('scatter' | 'sort' | 'segment').

        Forced values short-circuit; 'auto' asks the planner, whose measured
        device costs pay the link's 8 B/key, against a host-fold candidate
        priced from the same link profile (fold ns/key plus the 16 KB plane
        upload) when the fold library, the murmur3 family and a large enough
        batch allow one. `allow_delta` marks calls from the delta dispatch:
        there the candidate is 'delta' (the stacked merge), and 'tape' joins
        once the delta path has measured its launch train."""
        if self.ingest == "hostfold":
            return "hostfold"
        if self.ingest in ("delta", "tape"):
            return self.ingest if allow_delta else self.hll_impl
        if self.ingest in ("scatter", "sort", "segment"):
            return self.ingest
        if self.ingest == "device":
            return self.hll_impl
        extra = None
        overhead = 0.0
        if (self.family != "redis" and native.available()
                and nkeys >= HOSTFOLD_MIN_KEYS):
            prof = link_profile(self.device)
            overhead = prof.transfer_ns_per_byte * 8
            plane = (prof.fold_ns_per_key
                     + prof.transfer_ns_per_byte * delta_mod.HLL_M / max(nkeys, 1))
            extra = {"delta" if allow_delta else "hostfold": plane}
            if allow_delta:
                credit = self._tape_credit_ns()
                if credit > 0.0:
                    extra["tape"] = max(plane - credit, 0.0)
        return self.planner.plan("hll", nkeys, extra_costs=extra,
                                 device_overhead=overhead).path

    def _plan_bits(self, nkeys: int, m: int, plane_bytes: int = 0,
                   raw_per_key: int = 8, allow_delta: bool = False) -> str:
        """Set-bits strategy of a Bloom / BitSet write: 'scatter' |
        'segment', or 'delta' | 'tape' from the delta dispatch. A forced
        'segment' carries over from the config, forced 'delta' / 'tape'
        apply to delta-dispatch calls, every other forced value keeps the
        scatter (the Bloom host mirror is decided by its own policy), and
        'auto' asks the planner: with `allow_delta` a delta candidate is
        priced from the link profile (the host fold plus the plane upload,
        at most 5 B per touched byte sparse) against device paths that each
        ship `raw_per_key` bytes. Filters of 2^31 cells or more are never
        planned onto 'segment': its int32 codes cannot hold their
        one-past-the-end sentinel."""
        if self.ingest == "segment":
            return "segment"
        if self.ingest in ("delta", "tape"):
            return self.ingest if allow_delta else "scatter"
        if self.ingest != "auto":
            return "scatter"
        exclude = ("segment",) if m > ingest_kernels.MAX_SEGMENT_CELLS else ()
        extra = None
        overhead = 0.0
        if allow_delta and plane_bytes and nkeys >= HOSTFOLD_MIN_KEYS:
            prof = link_profile(self.device)
            overhead = prof.transfer_ns_per_byte * raw_per_key
            ship = min(plane_bytes, nkeys * delta_mod.SPARSE_ENTRY_BYTES)
            extra = {"delta": prof.fold_ns_per_key
                     + prof.transfer_ns_per_byte * ship / max(nkeys, 1)}
            # The tape ships the whole power-of-two plane but saves the
            # delta path's launch train: priced from observed launches only.
            credit = self._tape_credit_ns()
            if credit > 0.0:
                pad = 1 << max(0, int(plane_bytes - 1).bit_length())
                extra["tape"] = max(
                    prof.fold_ns_per_key
                    + prof.transfer_ns_per_byte * pad / max(nkeys, 1)
                    - credit, 0.0)
        return self.planner.plan("bits", nkeys, exclude=exclude,
                                 extra_costs=extra,
                                 device_overhead=overhead).path

    def _tape_credit_ns(self) -> float:
        """Observed per-key saving of the tape: (delta launches per window
        - 1) x the measured host cost per launch, over the mean folded keys
        per window. Zero until the delta path has measured itself, so
        'auto' never picks the tape on an unmeasured promise."""
        c = self.counters
        runs = c["delta_runs"]
        if not runs or not c["window_launches"] or not c["delta_keys"]:
            return 0.0
        per_launch_us = c["launch_us"] / c["window_launches"]
        # Tape windows count one launch each: leave them out of the train.
        delta_launches = c["window_launches"] - c["tape_runs"]
        extra_launches = delta_launches / runs - 1.0
        if extra_launches <= 0.0:
            return 0.0
        keys_per_window = c["delta_keys"] / max(runs + c["tape_runs"], 1)
        return extra_launches * per_launch_us * 1e3 / max(keys_per_window, 1.0)

    # -- state carry-over ---------------------------------------------------

    def from_jax_state(self, bank_np: np.ndarray, rows: dict,
                       objects: Optional[dict] = None) -> None:
        """Install a bank (numpy [S, m] int32) and its name -> row map, as
        taken from the JAX backend (`TpuBackend.bank`, `TpuBackend._rows`),
        and, given `objects`, replace the store's BitSet / Bloom objects
        with them: name -> (otype, cells as numpy uint8, meta, ...), what
        the JAX backend's `bits_export` returns. Run on the dispatcher
        (`execute_barrier`) when the executor is live."""
        if objects is None:
            # The store stays: push pending mirror bits down before the
            # mirrors go.
            for name in list(self._bloom_mirrors):
                if self.store.get(name) is not None:
                    self._bloom_device_sync(name)
        self._bloom_mirrors.clear()
        if objects is not None:
            self.store.flushall()
            for name, (otype, cells, meta, *_rest) in objects.items():
                self._install_bits(str(name), otype, cells, meta)
        bank_np = np.ascontiguousarray(bank_np, np.int32)
        sb = self._sharded_bank
        if sb is not None:
            # Mesh plane: placed in blocks, the rows padded to a multiple
            # of the mesh size.
            sb.capacity = sb.round_capacity(bank_np.shape[0])
            self.bank = sb.place(bank_np, sb.capacity)
        else:
            self.bank = torch.from_numpy(bank_np.copy()).to(self.device)
        alloc = self._alloc
        alloc.clear()
        alloc.capacity = len(self.bank)
        alloc.rows.update({str(n): int(r) for n, r in rows.items()})
        alloc.next = max(alloc.rows.values(), default=-1) + 1
        used = set(alloc.rows.values())
        alloc.free = [r for r in range(alloc.next) if r not in used]
        for name in alloc.rows:
            self._bump(name)
        self.read_cache.clear()
        self._account_bank()

    def to_numpy_state(self):
        """(bank as numpy [S, m] int32, name -> row map): the reverse of
        `from_jax_state` (a blocked bank's blocks concatenated)."""
        bank = self._ensure_bank()
        host = (bank.to_numpy() if isinstance(bank, Sharded)
                else bank.cpu().numpy().copy())
        return host, dict(self._rows)

    def to_numpy_objects(self) -> dict:
        """name -> (otype, cells as numpy uint8, meta) for every BitSet and
        Bloom object: the reverse of `from_jax_state`'s `objects`."""
        return {name: (obj.otype, obj.state.cpu().numpy().copy(), dict(obj.meta))
                for name in self.store.keys()
                if (obj := self.store.get(name)) is not None}

    # -- dispatch -----------------------------------------------------------

    def run(self, kind: str, target: str, ops: List[Op]) -> None:
        device_mod.bind_thread(self.device)
        if kind in self.COALESCE_GROUPS:
            # A group-coalesced run may span kinds and targets: the delta
            # dispatch splits it into host-folded planes and classic groups.
            self._delta_dispatch(target, ops)
            return
        handler = getattr(self, "_op_" + kind, None)
        if handler is None:
            raise ValueError(f"unknown op kind: {kind}")
        handler(target, ops)

    def handles(self, kind: str) -> bool:
        return hasattr(self, "_op_" + kind)

    def _classic_group_run(self, ops: List[Op]) -> None:
        """Retire a group-coalesced run: hll_add's handler is multi-target;
        the bloom/bitset handlers are single-target, so those dispatch per
        target with per-target failure isolation (one bad name must not
        fail a stolen run)."""
        hll_ops = [op for op in ops if op.kind == "hll_add"]
        groups: "OrderedDict[tuple, List[Op]]" = OrderedDict()
        if hll_ops:
            groups[("hll_add", hll_ops[0].target)] = hll_ops
        for op in ops:
            if op.kind != "hll_add":
                groups.setdefault((op.kind, op.target), []).append(op)
        for (kind, tname), tops in groups.items():
            try:
                getattr(self, "_op_" + kind)(tname, tops)
            except Exception as exc:  # noqa: BLE001 — never strand futures
                _fail(tops, classify(exc, seam="kernel_launch"))

    # -- delta ingest (host-folded planes, one stacked merge) ---------------
    #
    # The three group-coalesced write kinds share one retire path: each
    # (target, kind) group of a window folds on the host into one byte
    # plane (ingest/delta.py), the planes cross the link instead of the key
    # batches, and every plane becomes a row of one [T, L] uint8 stack
    # merged by the delta_merge kernel (or, under "tape", the whole window
    # by one window_merge). State commits on this thread; per-op results
    # resolve on the completer.

    #: planner results that retire through the delta window
    _DELTA_PATHS = frozenset({"delta", "tape"})

    def _delta_eligible(self, op: Op) -> bool:
        if self.ingest not in ("auto", "delta", "tape"):
            return False
        if op.kind == "hll_add" and self.family == "redis":
            return False  # the host fold implements the murmur3 family
        return delta_mod.foldable(op.kind, op.payload)

    def _delta_planned(self, kind: str, tname: str,
                       tops: List[Op]) -> Optional[str]:
        """Per-target gate of the delta window: the target must be
        type-clean (WRONGTYPE and uninitialized filters surface through the
        classic handlers, which isolate them per target) and the planner
        must pick 'delta' or 'tape'. Returns that path, or None for the
        classic path."""
        if kind == "geo_merge":
            return self._geo_planned(tname, tops[0].payload["inner"])
        nkeys = sum(op.nkeys or delta_mod.payload_nkeys(kind, op.payload)
                    for op in tops)
        if kind == "hll_add":
            if tname not in self._rows and self.store.get(tname) is not None:
                return None  # the name holds a BitSet / Bloom: WRONGTYPE
            path = self._plan_ingest(nkeys, allow_delta=True)
            return path if path in self._DELTA_PATHS else None
        if tname in self._rows:
            return None  # the name holds an HLL: WRONGTYPE
        obj = self.store.get(tname)
        if kind == "bloom_add":
            if (obj is None or obj.otype != ObjectType.BLOOM
                    or obj.meta.get("blocked")):
                return None
            # A valid host mirror folds with no link traffic at all: under
            # 'auto' that beats shipping any plane; forced delta / tape keep
            # the device copy current instead.
            if self.ingest not in ("delta", "tape") and self._bloom_use_host(
                    tname, obj, nkeys):
                return None
            m = obj.meta["size"]
            path = self._plan_bits(nkeys, m, plane_bytes=(m + 7) // 8,
                                   raw_per_key=8, allow_delta=True)
            return path if path in self._DELTA_PATHS else None
        # bitset_set: the plane covers the allocation after growth
        if obj is not None and obj.otype != ObjectType.BITSET:
            return None
        nbits = obj.state.shape[0] if obj is not None else 1024
        mx = self._max_index(tops)
        if mx >= nbits:
            nbits = max(1024, 1 << int(mx).bit_length())
        path = self._plan_bits(nkeys, nbits, plane_bytes=(nbits + 7) // 8,
                               raw_per_key=4, allow_delta=True)
        return path if path in self._DELTA_PATHS else None

    def _geo_planned(self, tname: str, inner: str) -> Optional[str]:
        """The geo gate: remote planes arrive folded (shipping them is sunk
        cost), so no planner is consulted, only the type gates; never
        'tape' (its per-op results, newly bits and pre-merge SETBIT reads,
        do not apply to remote planes)."""
        if inner == "hll_add":
            if tname not in self._rows and self.store.get(tname) is not None:
                return None  # the name holds a BitSet / Bloom: WRONGTYPE
            return "delta"
        if tname in self._rows:
            return None  # the name holds an HLL: WRONGTYPE
        obj = self.store.get(tname)
        if inner == "bloom_add":
            if obj is not None and (obj.otype != ObjectType.BLOOM
                                    or obj.meta.get("blocked")):
                return None
            return "delta"
        if obj is not None and obj.otype != ObjectType.BITSET:
            return None
        return "delta"

    def _delta_dispatch(self, target: str, ops: List[Op]) -> None:
        """Split a coalesced run (across kinds and targets) into (target,
        kind) groups and route each whole group through the delta window or
        the classic handlers: a target's ops never split across the two."""
        groups: "OrderedDict[tuple, List[Op]]" = OrderedDict()
        for op in ops:
            groups.setdefault((op.target, op.kind), []).append(op)
        delta_groups, classic = [], []
        use_tape = self.ingest == "tape"
        for (tname, kind), tops in groups.items():
            path = (self._delta_planned(kind, tname, tops)
                    if all(self._delta_eligible(op) for op in tops) else None)
            if path:
                delta_groups.append((tname, kind, tops))
                use_tape = use_tape or path == "tape"
            else:
                classic.extend(tops)
        if delta_groups:
            # Remote planes never ride a tape window, and no target may
            # hold two rows of one stack (the later writeback would drop
            # the earlier row's bits): a geo plane whose target also has a
            # local group in this run retires in a window of its own,
            # after the local one, against the state that one committed.
            local = [g for g in delta_groups if g[1] != "geo_merge"]
            geo = [g for g in delta_groups if g[1] == "geo_merge"]
            if use_tape:
                first, later = local, geo
            else:
                mine = {g[0] for g in local}
                first = local + [g for g in geo if g[0] not in mine]
                later = [g for g in geo if g[0] in mine]
            if first:
                self._delta_window(first, tape=use_tape)
            if later:
                self._delta_window(later, tape=False)
        if classic:
            self._classic_group_run(classic)

    @staticmethod
    def _pad_cells(cells: int) -> int:
        """The lane count a plane pads to in a stack: a power of two, at
        least the engine's smallest bucket."""
        return max(engine.MIN_BUCKET, 1 << max(0, int(cells - 1).bit_length()))

    def _delta_window(self, groups, tape: bool = False) -> None:
        """Fold every (target, kind) group into its plane, then retire the
        window: under `tape` in one window_merge launch unless the window
        overflows the cell budget, else in as few stacked delta_merge
        launches as the budget allows (normally one)."""
        t0 = time.perf_counter()
        planes, specs = [], []
        for tname, kind, tops in groups:
            try:
                plane, spec = self._delta_fold_group(tname, kind, tops,
                                                     tape=tape)
            except Exception as exc:  # noqa: BLE001 — per-target isolation
                _fail(tops, exc)
                continue
            planes.append(plane)
            specs.append(spec)
        self.counters["delta_fold_s"] += time.perf_counter() - t0
        if not planes:
            return
        for p in planes:
            self.counters["raw_bytes"] += p.raw_bytes
            self.counters["delta_keys"] += p.nkeys
        if tape:
            t2 = 1 << max(0, (len(planes) - 1).bit_length())
            lanes = max(self._pad_cells(p.cells) for p in planes)
            if t2 * lanes <= self.DELTA_STACK_CELLS:
                self.counters["tape_runs"] += 1
                try:
                    self._tape_retire(planes, specs)
                except Exception as exc:  # noqa: BLE001
                    # The one launch is the unit of failure; nothing was
                    # committed before it.
                    exc = classify(exc, seam="kernel_launch")
                    for spec in specs:
                        _fail(spec["ops"], exc)
                return
            # Over the budget: the chunked path. The folds skipped the
            # SETBIT pre-merge packs (the tape's own pack carries them).
            for p, spec in zip(planes, specs):
                if p.kind == "bitset_set" and spec.get("old_packed") is None:
                    spec["old_packed"] = Readback(engine.bitset_pack(
                        self.store.get(p.target).state))
                    self.counters["window_launches"] += 1
        for p in planes:
            self.counters["link_bytes"] += p.link_bytes
        self.counters["delta_runs"] += 1
        # Chunks under the cell budget; sorting by cell count keeps small
        # planes from padding to a large neighbour's lanes.
        order = sorted(range(len(planes)), key=lambda i: planes[i].cells)
        chunks: List[List[int]] = []
        cur: List[int] = []
        for i in order:
            lmax = self._pad_cells(max(
                [planes[j].cells for j in cur] + [planes[i].cells]))
            t2 = 1 << len(cur).bit_length()  # power-of-two ceil of len + 1
            if cur and t2 * lmax > self.DELTA_STACK_CELLS:
                chunks.append(cur)
                cur = [i]
            else:
                cur.append(i)
        if cur:
            chunks.append(cur)
        for chunk in chunks:
            try:
                self._delta_merge_chunk([planes[i] for i in chunk],
                                        [specs[i] for i in chunk])
            except Exception as exc:  # noqa: BLE001 — per-chunk isolation
                exc = classify(exc, seam="kernel_launch")
                for i in chunk:
                    _fail(specs[i]["ops"], exc)

    def _delta_fold_group(self, tname: str, kind: str, tops: List[Op],
                          tape: bool = False):
        """Fold one (target, kind) group into its DeltaPlane and completion
        spec, on the host. The only device work it queues is a SETBIT
        group's pre-merge pack (skipped under `tape`: the tape's pack of
        every row carries the same bits)."""
        if kind == "geo_merge":
            return self._geo_fold_group(tname, tops)
        payloads = [op.payload for op in tops]
        nkeys = sum(delta_mod.payload_nkeys(kind, p) for p in payloads)
        raw = sum(delta_mod.payload_raw_bytes(kind, p) for p in payloads)
        if kind == "hll_add":
            self._hll_row(tname)  # allocate the bank row (may grow the bank)
            plane = delta_mod.fold_hll(payloads, self.seed)
            dp = delta_mod.encode(kind, tname, plane, cells=delta_mod.HLL_M,
                                  packed=False, nkeys=nkeys, raw_bytes=raw)
            return dp, {"kind": kind, "ops": tops}
        if kind == "bloom_add":
            obj, m, k = self._bloom_meta(tname)
            # Bring the device current (pending mirror bits would be missing
            # from the old row), then refresh the mirror to equal the device
            # filter: the plane is then exactly the bits this batch sets.
            self._bloom_device_sync(tname)
            obj = self.store.get(tname, ObjectType.BLOOM)
            mir = self._bloom_mirror(tname, obj, m)
            scratch = mir["bits"].copy()
            newly = []
            for p in payloads:
                # In-order folds: a key's newly flag sees the keys before it
                # in the batch, as in _bloom_host_add.
                if "packed" in p:
                    res = native.bloom_fold_u64(p["packed"], scratch, k, m,
                                                self.seed)
                else:
                    res = native.bloom_fold_rows(p["data"], p["lengths"],
                                                 scratch, k, m, self.seed)
                newly.append(res.view(np.bool_))
            plane = scratch & ~mir["bits"]
            dp = delta_mod.encode(kind, tname, plane, cells=m, packed=True,
                                  nkeys=nkeys, raw_bytes=raw)
            return dp, {"kind": kind, "ops": tops, "newly": newly,
                        "scratch": scratch, "mirror": mir}
        # bitset_set
        obj = self._bitset(tname, nbits=1024)
        mx = self._max_index(tops)
        obj = self._grow_for(obj, mx if mx >= 0 else 0)
        if mx >= 0:
            self._extend(obj, mx)
        nbits = obj.state.shape[0]
        plane = delta_mod.fold_bitset(payloads, nbits)
        # SETBIT results are the pre-merge bits: pack the state now; the
        # completer slices each key's bit from the packed copy.
        old_packed = None
        if not tape:
            old_packed = Readback(engine.bitset_pack(obj.state))
            self.counters["window_launches"] += 1
        dp = delta_mod.encode(kind, tname, plane, cells=nbits, packed=True,
                              nkeys=nkeys, raw_bytes=raw)
        return dp, {"kind": kind, "ops": tops, "old_packed": old_packed}

    # -- geo remote planes (cross-site convergence, geo/) -------------------
    #
    # A geo_merge payload is a plane another site already folded:
    # {"inner": hll_add | bloom_add | bitset_set, "cells", a dense "plane"
    # or a sparse "idx" / "val" / "plane_bytes", "meta", "stamp"}. The fold
    # below only combines one target's planes (element-wise max / OR) and
    # re-encodes them as an ordinary DeltaPlane of the INNER kind, so
    # _delta_merge_chunk's gather and writeback serve remote applies
    # unchanged: one delta_merge launch per window however many remote ops
    # the planes summarize.

    @staticmethod
    def _geo_plane(payload) -> np.ndarray:
        """A geo payload's dense byte plane (the link ships sparse (idx,
        val) pairs when few bytes are set)."""
        if "plane" in payload:
            return np.asarray(payload["plane"], np.uint8)
        plane = np.zeros((int(payload["plane_bytes"]),), np.uint8)
        idx = np.asarray(payload["idx"], np.int64)
        if idx.size:
            np.maximum.at(plane, idx, np.asarray(payload["val"], np.uint8))
        return plane

    def _geo_bloom_ensure(self, target: str, meta: dict):
        """The local twin of a remote Bloom filter, made on first sight
        (the origin's init parameters ship with every plane)."""
        self._check_not_hll(target, ObjectType.BLOOM)
        obj = self.store.get(target, ObjectType.BLOOM)
        if obj is not None:
            return obj
        m = int(meta.get("size", 0))
        if m <= 0:
            raise RuntimeError(
                f"geo bloom plane for uninitialized filter '{target}' "
                "carries no size meta")
        obj = self.store.get_or_create(
            target, ObjectType.BLOOM, lambda: bitset_ops.make(m), dict(meta))
        self._touch(target)
        return obj

    def _geo_fold_group(self, tname: str, tops: List[Op]):
        """Fold one target's remote planes into a DeltaPlane and a geo spec
        for the stacked merge (the geo_merge half of _delta_fold_group)."""
        payloads = [op.payload for op in tops]
        inner = payloads[0]["inner"]
        nkeys = sum(int(p.get("nkeys", 0)) for p in payloads)
        raw = sum(int(p.get("raw", 0)) for p in payloads)
        self.counters["geo_planes"] += len(payloads)
        spec = {"kind": "geo_merge", "geo": True, "ops": tops}
        if inner == "hll_add":
            self._hll_row(tname)  # allocate the bank row (may grow the bank)
            plane = np.zeros((delta_mod.HLL_M,), np.uint8)
            for p in payloads:
                np.maximum(plane, self._geo_plane(p), out=plane)
            dp = delta_mod.encode("hll_add", tname, plane,
                                  cells=delta_mod.HLL_M, packed=False,
                                  nkeys=nkeys, raw_bytes=raw)
            return dp, spec
        if inner == "bloom_add":
            obj = self._geo_bloom_ensure(tname, payloads[0].get("meta") or {})
            m = obj.meta["size"]
            # Pending host-mirror bits reach the device before the merge
            # replaces the cells (the writeback drops the mirror, so bits
            # still parked there would be lost).
            self._bloom_device_sync(tname)
            plane = np.zeros(((m + 7) >> 3,), np.uint8)
            for p in payloads:
                if int(p["cells"]) != m:
                    raise RuntimeError(
                        f"geo bloom plane for '{tname}' sized {p['cells']} "
                        f"bits vs local filter {m} — sites must init bloom "
                        "filters with identical parameters")
                np.bitwise_or(plane, self._geo_plane(p), out=plane)
            dp = delta_mod.encode("bloom_add", tname, plane, cells=m,
                                  packed=True, nkeys=nkeys, raw_bytes=raw)
            return dp, spec
        # bitset_set: the plane covers the allocation after growth
        obj = self._bitset(tname, nbits=1024)
        mx = max(int(p["cells"]) for p in payloads) - 1
        obj = self._grow_for(obj, max(mx, 0))
        ext = max(int((p.get("meta") or {}).get("max_idx", -1))
                  for p in payloads)
        if ext >= 0:
            self._extend(obj, ext)
        nbits = obj.state.shape[0]
        plane = np.zeros(((nbits + 7) >> 3,), np.uint8)
        for p in payloads:
            src = self._geo_plane(p)
            np.bitwise_or(plane[:src.shape[0]], src, out=plane[:src.shape[0]])
        dp = delta_mod.encode("bitset_set", tname, plane, cells=nbits,
                              packed=True, nkeys=nkeys, raw_bytes=raw)
        return dp, spec

    def _delta_merge_chunk(self, planes, specs) -> None:
        """Retire one chunk of planes in one stacked merge: the [T, L] uint8
        stack of old rows (HLL rows gathered from the bank, store cells) and
        the delta stack (sparse planes expanded, packed ones unpacked on the
        device), one delta_merge launch in place, every row written back.
        A chunk is its own unit of failure: the kernel_launch seam fires per
        chunk, and state commits only after its launch."""
        fault_inject.fire("kernel_launch", kind="delta_merge",
                          target=planes[0].target if planes else "")
        t0 = time.perf_counter()
        launches = 0
        lanes = max(self._pad_cells(p.cells) for p in planes)
        t = len(planes)
        t2 = 1 << max(0, (t - 1).bit_length())
        old = torch.zeros((t2, lanes), dtype=torch.uint8, device=self.device)
        delta = torch.zeros((t2, lanes), dtype=torch.uint8, device=self.device)
        hll_ix = [i for i, p in enumerate(planes) if p.kind == "hll_add"]
        rows_pad = None
        if hll_ix:
            rows_pad = engine.pad_rows_repeat(np.array(
                [self._rows[planes[i].target] for i in hll_ix], np.int32))
            gathered = engine.hll_bank_rows_u8(self._ensure_bank(), rows_pad)
            launches += 1
            old[hll_ix, : delta_mod.HLL_M] = gathered[: len(hll_ix)]
        for i, p in enumerate(planes):
            if p.kind != "hll_add":
                old[i, : p.cells] = self.store.get(p.target).state
            if p.sparse:
                plane = engine.delta_scatter_bytes(
                    self._to_device(p.idx), self._to_device(p.val), p.plane_bytes)
                launches += 1
            else:
                plane = self._to_device(p.dense)
            if p.packed:
                plane = engine.delta_unpack(plane, p.cells)
                launches += 1
            delta[i, : p.cells] = plane
        merged, changed = engine.delta_merge_stack(old, delta)
        del delta, plane  # free the window's temporaries before the next
        self.counters["merge_launches"] += 1
        launches += 1
        # HLL rows go back in one write through the same padded row vector
        # as the gather: its repeats rewrite the first row with its own
        # merged registers.
        if hll_ix:
            sel = hll_ix + [hll_ix[0]] * (rows_pad.shape[0] - len(hll_ix))
            self.bank = engine.hll_bank_set_rows(
                self.bank, merged[sel, : delta_mod.HLL_M], rows_pad)
            launches += 1
            for i in hll_ix:
                self._bump(planes[i].target)
        for i, p in enumerate(planes):
            if p.kind != "hll_add":
                self._commit_store_row(p, specs[i], merged[i])
        self.counters["window_launches"] += launches
        self.counters["launch_us"] += (time.perf_counter() - t0) * 1e6
        flag = Readback(changed)
        entries = list(zip(range(t), planes, specs))

        def run():
            try:
                _fire_d2h("delta", planes[0].target)
                host_changed = flag.wait().numpy()
                host_old = {i: spec["old_packed"].wait().numpy()
                            for i, p, spec in entries
                            if spec.get("old_packed") is not None}
            except Exception as exc:  # noqa: BLE001
                exc = classify(exc, seam="d2h_complete")
                for _i, _p, spec in entries:
                    _fail(spec["ops"], exc)
                return
            self._complete_entries(entries, host_changed, host_old)

        self._submit_with_scratch(run, planes)

    def _submit_with_scratch(self, run, planes) -> None:
        """Hand a window's completion to the completer, charging its delta
        planes to the scratch meter until it has run (failed or not)."""
        inflight = sum(int(p.plane_bytes) for p in planes)
        with self._scratch_lock:
            self.counters["delta_scratch_bytes"] += inflight

        def run_and_release():
            try:
                run()
            finally:
                with self._scratch_lock:
                    self.counters["delta_scratch_bytes"] -= inflight

        self.completer.submit(run_and_release)

    def _commit_store_row(self, p, spec, merged_row: torch.Tensor) -> None:
        """Install a merged BitSet / Bloom row (a copy: the stack is a
        window temporary). A Bloom mirror then equals the device filter:
        mirror + this batch, the fold's scratch. Remote bits merged on the
        device only: the mirror is dropped (rebuilt from the device on next
        use) rather than guessed at."""
        self.store.swap(p.target, merged_row[: p.cells].clone())
        self._touch(p.target)
        if spec.get("geo"):
            self._bloom_mirrors.pop(p.target, None)
        elif p.kind == "bloom_add":
            spec["mirror"]["bits"] = spec["scratch"]
            spec["mirror"]["synced_dev"] = self.store.get(p.target).version

    @staticmethod
    def _complete_entries(entries, host_changed, host_old) -> None:
        """Resolve a retired window's ops: PFADD -> did the target's row
        rise; Bloom add -> the fold's per-key newly flags; SETBIT -> each
        key's pre-merge bit from the packed old row; a remote plane -> True
        (it carries no per-key result: the applier needs the ack only)."""
        for i, p, spec in entries:
            if spec.get("geo"):
                values = [True] * len(spec["ops"])
            elif p.kind == "hll_add":
                values = [bool(host_changed[i])] * len(spec["ops"])
            elif p.kind == "bloom_add":
                values = spec["newly"]
            else:
                old = host_old[i]
                values = []
                for op in spec["ops"]:
                    idx = np.asarray(op.payload["idx"], np.int64)
                    values.append(((old[idx >> 3] >> (7 - (idx & 7))) & 1
                                   ).astype(bool))
            for op, value in zip(spec["ops"], values):
                if not op.future.done():
                    op.future.set_result(value)

    def _tape_retire(self, planes, specs) -> None:
        """Retire a whole window with one window_merge launch: encode every
        plane into the command tape (ingest/tape.py) and run
        engine.tape_apply, which gathers the old rows, packs their pre-merge
        bits for SETBIT results, merges every row by its op code and writes
        the HLL rows back to the bank. The kernel_launch seam fires before
        anything is encoded or committed, so a fault there fails the window
        whole with no partial state."""
        fault_inject.fire("kernel_launch", kind="tape",
                          target=planes[0].target if planes else "")
        t0 = time.perf_counter()
        spec_by = {id(p): s for p, s in zip(planes, specs)}
        tp = tape_mod.encode_window(planes, self._hll_row, self._shard_of)
        self.counters["link_bytes"] += tp.link_bytes
        if tp.n_shards > 1:
            # Mesh data plane: this one launch retires a window whose
            # entries span several logical shards (the tape's shard column).
            self.counters["multi_shard_windows"] += 1
        n_hll = tp.n_hll
        # The window retires on the store's device (a mesh bank's home):
        # its HLL rows are host ints, gathered from the bank there.
        wire = self._to_device(tp.wire)
        table = self._to_device(tp.table)
        bank = self._ensure_bank() if n_hll else None
        store_planes = tp.planes[n_hll:]
        store_old = [self.store.get(p.target).state for p in store_planes]
        want_old = any(p.kind == "bitset_set" for p in store_planes)
        new_bank, merged, changed, old_packed = engine.tape_apply(
            bank, wire, table, tp.hll_rows, store_old, n_hll=n_hll,
            lanes=tp.lanes, want_old=want_old)
        self.counters["merge_launches"] += 1
        self.counters["window_launches"] += 1
        if n_hll:
            self.bank = new_bank
            for p in tp.planes[:n_hll]:
                self._bump(p.target)
        for j, p in enumerate(store_planes):
            self._commit_store_row(p, spec_by[id(p)], merged[n_hll + j])
        self.counters["launch_us"] += (time.perf_counter() - t0) * 1e6
        flag = Readback(changed)
        old_host = Readback(old_packed) if want_old else None
        entries = [(i, p, spec_by[id(p)]) for i, p in enumerate(tp.planes)]

        def run():
            try:
                _fire_d2h("tape", planes[0].target)
                host_changed = flag.wait().numpy()
                host_old = old_host.wait().numpy() if old_host else None
            except Exception as exc:  # noqa: BLE001
                exc = classify(exc, seam="d2h_complete")
                for _i, _p, spec in entries:
                    _fail(spec["ops"], exc)
                return
            self._complete_entries(entries, host_changed, host_old)

        self._submit_with_scratch(run, planes)

    def ingest_stats(self) -> dict:
        """The delta-ingest counters plus the derived link bytes per key and
        the observed dispatch cost per window (launches, host us)."""
        out = dict(self.counters)
        out["delta_bytes_per_key"] = (
            self.counters["link_bytes"] / max(self.counters["delta_keys"], 1))
        windows = self.counters["delta_runs"] + self.counters["tape_runs"]
        out["launches_per_window"] = (
            self.counters["window_launches"] / max(windows, 1))
        out["launch_us_per_window"] = (
            self.counters["launch_us"] / max(windows, 1))
        return out

    # -- helpers ------------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _coalesce_bytes(self, ops: List[Op]):
        """Concatenate byte-key payloads -> (data, lengths, spans)."""
        w = max(op.payload["data"].shape[1] for op in ops)
        total = sum(op.payload["data"].shape[0] for op in ops)
        data = np.zeros((total, w), np.uint8)
        lengths = np.zeros((total,), np.int32)
        spans = []
        pos = 0
        for op in ops:
            d = op.payload["data"]
            n = d.shape[0]
            data[pos: pos + n, : d.shape[1]] = d
            lengths[pos: pos + n] = op.payload["lengths"]
            spans.append((pos, pos + n))
            pos += n
        return data, lengths, spans

    def _slice_results(self, ops: List[Op], outs, spans, post=None,
                       on_result=None) -> Callable:
        """Completion closure: read back the per-chunk device vectors, then
        slice per-op bool results in submission order. `post` maps the
        concatenated host vector first; `on_result` sees each (op, value)
        before its future resolves (the read-cache fill)."""
        rbs = [Readback(o) for o in outs]

        def run():
            try:
                _fire_d2h_ops(ops)
                parts = [rb.wait().numpy()[:n] for rb, n in zip(rbs, spans)]
                flat = np.concatenate(parts) if parts else np.zeros((0,), bool)
                if post is not None:
                    flat = post(flat)
            except Exception as exc:  # noqa: BLE001
                _fail(ops, classify(exc, seam="d2h_complete"))
                return
            pos = 0
            for op in ops:
                n = _lanes_of(op)
                if not op.future.done():
                    value = flat[pos: pos + n].astype(bool)
                    if on_result is not None:
                        on_result(op, value)
                    op.future.set_result(value)
                pos += n

        return run

    def _staged_keys(self, keys: torch.Tensor, ready) -> torch.Tensor:
        """Order the current stream after a staged chunk's H2D copy."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            keys.record_stream(stream)
        return keys

    def _stage_chunk(self, item):
        """Pipeline stage: pad one chunk of int64 keys to its bucket inside
        pinned memory and start its H2D copy on the copy stream."""
        row, chunk = item
        n = chunk.shape[0]
        b = engine.bucket_size(n)
        if self.device.type != "cuda":
            padded, _ = engine.pad_rows(chunk)
            return row, torch.from_numpy(padded), n, None
        device_mod.bind_thread(self.device)
        host = torch.empty((b,), dtype=torch.int64, pin_memory=True)
        view = host.numpy()
        view[:n] = chunk
        view[n:] = 0
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return row, dev, n, ready

    # -- HLL (bank-backed) --------------------------------------------------

    def _hll_row(self, name: str, create: bool = True):
        """name -> bank row (WRONGTYPE if the store holds the name as
        another kind)."""
        row = self._alloc.rows.get(name)
        if row is not None:
            return row
        other = self.store.get(name)
        if other is not None:
            raise WrongTypeError(
                f"key '{name}' holds {other.otype}, operation needs hll")
        if not create:
            return None
        self._ensure_bank()
        prefer = None
        sb = self._sharded_bank
        if sb is not None and self._shard_of is not None:
            # Mesh plane: try the owning shard's preferred row block first,
            # so the row lands in that shard's block (a full block spills
            # anywhere: placement is a hint, not a domain).
            prefer = sb.block(int(self._shard_of(name)), self._alloc.capacity)
        return self._alloc.row_of(name, prefer=prefer)

    def _bump(self, name: str) -> None:
        self._alloc.bump(name)
        self._touch(name)

    def _epoch(self, name: str) -> int:
        return self._epochs.get(name, 0)

    def _touch(self, name: str) -> None:
        """A write made `name`'s state diverge from any cached read."""
        self._epochs[name] = self._epochs.get(name, 0) + 1

    def notify_restored(self, name: str) -> None:
        """A checkpoint or snapshot restore replaced `name`'s state under
        the op path: bump its epoch so cached reads go stale, drop its
        cached reads outright, and discard a Bloom host mirror built against
        the old filter. Replayed journal ops need none of this: they enter
        through run() like live traffic."""
        self._bloom_mirrors.pop(name, None)
        self._touch(name)
        self.read_cache.invalidate(name)

    def snapshot_cut(self) -> dict:
        """A consistent copy of every sketch for a snapshot, taken on the
        dispatcher inside a barrier. Cell tensors and the bank are written
        in place by later runs (the segment-OR, SETBIT, delta_merge), so a
        kept handle would reach the disk holding state from past the cut:
        each BitSet / Bloom tensor and the bank are cloned on the current
        stream instead, after pending Bloom mirror bits are pushed down.
        Returns {"objects": name -> (otype, cells clone, meta, version),
        "bank": bank clone or None, "rows": name -> (row, version)}."""
        objects = {}
        for name in self.store.keys():
            obj = self.store.get(name)
            if obj is None:
                continue
            if obj.otype == ObjectType.BLOOM:
                self._bloom_device_sync(name)
                obj = self.store.get(name)
            objects[name] = (obj.otype, obj.state.clone(), dict(obj.meta),
                             obj.version)
        rows = {name: (row, self._row_versions.get(name, 0))
                for name, row in self._rows.items()}
        bank = self.bank.clone() if rows and self.bank is not None else None
        return {"objects": objects, "bank": bank, "rows": rows}

    def bank_names(self) -> List[str]:
        """Names of the HLLs held as bank rows (the checkpoint, snapshot and
        redis durability surface exports each through hll_export)."""
        return list(self._rows)

    def row_version(self, name: str) -> int:
        """A bank row's version (bumped on every write to it): the redis
        durability tier's `flush(only_dirty=True)` skips rows whose version
        has not moved since their last flush."""
        return self._row_versions.get(name, 0)

    def names(self, pattern: str = "*") -> List[str]:
        out = dict.fromkeys(self.store.keys(pattern))
        for n in self._rows:
            if pattern in (None, "*") or fnmatch.fnmatchcase(n, pattern):
                out[n] = None
        return list(out)

    def _op_hll_add(self, target: str, ops: List[Op]) -> None:
        # A coalesced run may span formats and targets; PFADD is a
        # commutative max-fold, so grouping by format is safe. Targets are
        # validated (rows allocated, growing the bank) up front: a
        # WRONGTYPE name fails only its own ops.
        valid = []
        for op in ops:
            try:
                self._hll_row(op.target)
            except WrongTypeError as exc:
                op.future.set_exception(exc)
                continue
            valid.append(op)
        ops = valid
        packed_ops = [op for op in ops if "packed" in op.payload]
        int_ops = [op for op in ops if "hi" in op.payload]
        byte_ops = [op for op in ops if "data" in op.payload]
        device_ops = [op for op in ops if "device_packed" in op.payload]
        host_ops = packed_ops + int_ops + byte_ops
        if host_ops:
            path = self._plan_ingest(sum(op.nkeys or self._payload_nkeys(op)
                                         for op in host_ops))
            if path == "hostfold":
                self._hll_add_hostfold(host_ops)
            else:
                for group in (packed_ops, int_ops, byte_ops):
                    if group:
                        self._hll_add_group(group, path)
        if device_ops:
            self._hll_add_device(device_ops, self._plan_ingest(
                sum(self._device_nkeys(op) for op in device_ops)))
        for op in ops:
            if not ({"packed", "hi", "data", "device_packed"}
                    & op.payload.keys()):
                op.future.set_exception(ValueError(
                    f"unknown hll_add payload keys: {sorted(op.payload)}"))

    def _complete_changed(self, ops: List[Op], parts) -> None:
        complete_changed_rows(
            self.completer, ops, [self._rows[op.target] for op in ops], parts)

    @staticmethod
    def _device_nkeys(op: Op) -> int:
        keys = op.payload["device_packed"]
        if isinstance(keys, torch.Tensor):
            return int(keys.shape[0])
        return _as_i64(np.asarray(keys)).shape[0]

    @staticmethod
    def _payload_nkeys(op: Op) -> int:
        for key in ("packed", "hi", "data"):
            if key in op.payload:
                return op.payload[key].shape[0]
        return 0

    def _hll_add_hostfold(self, ops: List[Op]) -> None:
        """Fold each target's keys into 16 KB of host registers (the host
        fold library), ship the folded sketches, and absorb them into their
        bank rows in one max-scatter. `changed` keeps its meaning: any
        register of the target raised by this run."""
        folds: dict = {}  # target -> host registers
        for op in ops:
            regs = folds.get(op.target)
            if regs is None:
                regs = folds[op.target] = np.zeros(delta_mod.HLL_M, np.uint8)
            p = op.payload
            if "packed" in p:
                native.hll_fold_u64(p["packed"], regs, self.seed)
            elif "hi" in p:
                keys = ((np.asarray(p["hi"], np.uint64) << np.uint64(32))
                        | np.asarray(p["lo"], np.uint64))
                native.hll_fold_u64(keys, regs, self.seed)
            else:
                native.hll_fold_rows(p["data"], p["lengths"], regs, self.seed)
        names = list(folds)
        # The sketch count pads to a power of two; zero rows absorb as
        # no-ops under max.
        rows = engine.pad_rows_repeat(
            np.array([self._rows[n] for n in names], np.int32))
        stack = np.zeros((rows.shape[0], delta_mod.HLL_M), np.uint8)
        for i, n in enumerate(names):
            stack[i] = folds[n]
        self.bank, changed = engine.hll_bank_absorb_rows(
            self._ensure_bank(), self._to_device(stack), rows)
        for n in names:
            self._bump(n)
        lane_of = {n: i for i, n in enumerate(names)}
        complete_changed_rows(self.completer, ops,
                              [lane_of[op.target] for op in ops], [changed])

    def _one_row(self, ops: List[Op]):
        """The row when every op targets one sketch, else None."""
        targets = {op.target for op in ops}
        if len(targets) == 1:
            return self._rows[next(iter(targets))]
        return None

    def _hll_add_group(self, ops: List[Op], impl: str = "scatter") -> None:
        # Kernels are only launched here; the `changed` flags resolve on the
        # completer. Single-target chunks use the scalar-row kernels (the
        # `impl` insert). Multi-target runs carry a per-key row vector: byte
        # keys through the `impl` insert's multi-target form (under
        # 'segment' one kernel launch per chunk), small int ops through the
        # flat scatter, as in JAX. (hi, lo) int keys take the scalar-row
        # kernels for one target and the `impl` multi-target form otherwise.
        parts = []
        if "packed" in ops[0].payload:
            # A large op's keys go through the staging pipeline chunk by
            # chunk (pad into pinned memory + H2D on the worker while this
            # thread launches the previous chunk); small ops gather into
            # shared buckets with a row vector.
            small: List[Op] = []
            chunks = []
            for op in ops:
                keys = _as_i64(op.payload["packed"])
                if keys.shape[0] < engine.MIN_BUCKET:
                    small.append(op)
                    continue
                row = self._rows[op.target]
                chunks.extend((row, keys[s:e])
                              for s, e in engine.chunk_spans(keys.shape[0]))
            if chunks:
                def dispatch(_i, staged):
                    row, keys, count, ready = staged
                    self.bank, changed = engine.hll_bank_add_packed(
                        self._ensure_bank(), self._staged_keys(keys, ready),
                        count, row, self.seed, self.family, impl)
                    return changed

                parts.extend(self._pipeline.run(chunks, self._stage_chunk,
                                                dispatch))
            if small:
                keys = np.concatenate([_as_i64(op.payload["packed"])
                                       for op in small])
                rowv = np.concatenate(
                    [np.full(op.payload["packed"].shape[0],
                             self._rows[op.target], np.int32) for op in small])
                for s, e in engine.chunk_spans(keys.shape[0]):
                    pkeys, count = engine.pad_rows(keys[s:e])
                    prow, _ = engine.pad_ints(rowv[s:e])
                    self.bank, changed = engine.hll_bank_add_packed_rows(
                        self._ensure_bank(), self._to_device(pkeys),
                        self._to_device(prow), count, self.seed, self.family)
                    parts.append(changed)
        elif "hi" in ops[0].payload:
            one = self._one_row(ops)
            # uint32 lanes widen to int64 on the host (torch's uint32 has
            # few ops).
            hi = np.concatenate([op.payload["hi"] for op in ops]).astype(np.int64)
            lo = np.concatenate([op.payload["lo"] for op in ops]).astype(np.int64)
            rowv = None if one is not None else np.concatenate(
                [np.full(op.payload["hi"].shape[0], self._rows[op.target],
                         np.int32) for op in ops])
            for s, e in engine.chunk_spans(hi.shape[0]):
                phi, pvalid = engine.pad_ints(hi[s:e])
                plo, _ = engine.pad_ints(lo[s:e])
                args = (self._to_device(phi), self._to_device(plo))
                valid = self._to_device(pvalid)
                if one is not None:
                    self.bank, changed = engine.hll_bank_add_u64(
                        self._ensure_bank(), *args, valid, one, self.seed,
                        self.family, impl)
                else:
                    prow, _ = engine.pad_ints(rowv[s:e])
                    self.bank, changed = engine.hll_bank_add_u64_rows(
                        self._ensure_bank(), *args, self._to_device(prow),
                        valid, self.seed, self.family, impl)
                parts.append(changed)
        else:
            one = self._one_row(ops)
            data, lengths, spans = self._coalesce_bytes(ops)
            rowv = None
            if one is None:
                rowv = np.zeros((data.shape[0],), np.int32)
                for op, (s, e) in zip(ops, spans):
                    rowv[s:e] = self._rows[op.target]
            for s, e in engine.chunk_spans(data.shape[0]):
                pdata, plengths, pvalid = engine.pad_bytes(data[s:e], lengths[s:e])
                args = (self._to_device(pdata), self._to_device(plengths))
                valid = self._to_device(pvalid)
                if one is not None:
                    self.bank, changed = engine.hll_bank_add_bytes(
                        self._ensure_bank(), *args, valid, one, self.seed,
                        self.family, impl)
                else:
                    prow, _ = engine.pad_ints(rowv[s:e])
                    self.bank, changed = engine.hll_bank_add_bytes_rows(
                        self._ensure_bank(), *args, self._to_device(prow),
                        valid, self.seed, self.family, impl)
                parts.append(changed)
        for op in ops:
            self._bump(op.target)
        self._complete_changed(ops, parts)

    def _hll_add_device(self, ops: List[Op], impl: str) -> None:
        """Keys already on the device (int64 [n]): one launch chain per
        chunk at its padded shape, no host copy and no transfer. A journal
        replay hands the same keys back as a host array (int64 [n], or the
        JAX package's [n, 2] uint32 layout): it is copied to the device."""
        parts = []
        for op in ops:
            row = self._rows[op.target]
            keys = op.payload["device_packed"]
            if not isinstance(keys, torch.Tensor):
                keys = self._to_device(_as_i64(np.asarray(keys)))
            keys = keys.to(self.device)
            for s, e in engine.chunk_spans(int(keys.shape[0])):
                chunk = keys[s:e]
                n = e - s
                b = engine.bucket_size(n)
                if n != b:
                    chunk = torch.cat([chunk, chunk.new_zeros(b - n)])
                self.bank, changed = engine.hll_bank_add_packed(
                    self._ensure_bank(), chunk, n, row, self.seed,
                    self.family, impl)
                parts.append(changed)
            self._bump(op.target)
        self._complete_changed(ops, parts)

    def _op_hll_count(self, target: str, ops: List[Op]) -> None:
        row = self._hll_row(target, create=False)
        if row is None:
            # Absent targets are never cached: creation does not bump the
            # epoch, so a cached 0 could outlive the first insert.
            for op in ops:
                op.future.set_result(0)
            return
        self._cached_read(target, "hll_count", ops,
                          lambda: engine.hll_bank_count(self.bank, row),
                          lambda est: int(round(float(est))))

    def _cached_read(self, target: str, kind: str, ops: List[Op], launch,
                     combine) -> None:
        """A read memoized per write epoch (PFCOUNT, BITCOUNT, length, Bloom
        count): `launch()` starts the device work, `combine(host tensor)`
        finishes it on the completer."""
        epoch = self._epoch(target)
        cached = self.read_cache.get(target, kind, epoch)
        if self.read_cache.is_hit(cached):
            # No kernel, no readback, but still resolved through the
            # completer so per-target results stay FIFO.
            _trace_cache(ops, hit=True)
            self.completer.submit(_complete_all(ops, lambda v=cached: v))
            return
        _trace_cache(ops, hit=False)
        rb = Readback(launch())

        def materialize():
            out = combine(rb.wait())
            # Stamped with the dispatch-time epoch: a write that raced in
            # since then bumped the live epoch, so this entry can't serve.
            self.read_cache.put(target, kind, epoch, out)
            return out

        self.completer.submit(_complete_all(ops, materialize))

    def _op_hll_export(self, target: str, ops: List[Op]) -> None:
        """(registers uint8[m], version) of one sketch; None if absent."""
        row = self._hll_row(target, create=False)
        if row is None:
            for op in ops:
                op.future.set_result(None)
            return
        snapshot = Readback(engine.hll_bank_row(self.bank, row))
        version = self._row_versions.get(target, 0)
        self.completer.submit(_complete_all(
            ops, lambda: (snapshot.wait().numpy().astype(np.uint8), version)))

    def _op_hll_import(self, target: str, ops: List[Op]) -> None:
        """Overwrite (or create) an HLL bank row from host registers."""
        for op in ops:
            regs = np.asarray(op.payload["regs"]).astype(np.int32)
            row = self._hll_row(target)
            self.bank = engine.hll_bank_set_row(self.bank, self._to_device(regs), row)
            self._bump(target)
            op.future.set_result(True)

    def _count_rows(self, target: str, extra_names) -> Optional[np.ndarray]:
        rows = []
        for n in (target, *extra_names):
            row = self._hll_row(n, create=False)
            if row is not None:
                rows.append(row)
        return np.array(rows, np.int32) if rows else None

    def _op_hll_count_with(self, target: str, ops: List[Op]) -> None:
        # Union count across sketches: one row-max (merge_stack over the
        # row vector) + estimator; never mutates. Mesh plane: the fold runs
        # as the collective (per-shard folds, a max across shards).
        for op in ops:
            rows = self._count_rows(target, op.payload["names"])
            if rows is None:
                op.future.set_result(0)
                continue
            if self.mesh is not None:
                self.counters["collective_merges"] += 1
                est = engine.hll_bank_count_rows_collective(self.bank, rows,
                                                            mesh=self.mesh)
            else:
                est = engine.hll_bank_count_rows(self.bank, rows)
            est = Readback(est)
            self.completer.submit(_complete_all([op], lambda est=est: _estimate(est)))

    def _merge_rows(self, target: str, names) -> tuple:
        """(target_row, padded source-row vector incl. target) for the
        PFMERGE family; missing sources are skipped."""
        trow = self._hll_row(target)
        rows = [trow] + [r for n in names
                         if (r := self._hll_row(n, create=False)) is not None]
        return trow, np.array(rows, np.int32)

    def _op_hll_merge_with(self, target: str, ops: List[Op]) -> None:
        # PFMERGE: fold the sources into the target row, in place (the
        # target is in the gathered set, so its registers take part).
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            if self.mesh is not None:
                # Collective PFMERGE: per-shard folds, a max across shards,
                # the target row's owner writes the merged registers.
                self.counters["collective_merges"] += 1
                self.bank = engine.hll_bank_merge_rows_collective(
                    self.bank, rows, trow, mesh=self.mesh)
            else:
                self.bank = engine.hll_bank_merge_rows(self.bank, rows, trow)
            self._bump(target)
            op.future.set_result(None)

    def _op_hll_merge_count(self, target: str, ops: List[Op]) -> None:
        # Fused PFMERGE + PFCOUNT: one readback instead of two.
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            if self.mesh is not None:
                self.counters["collective_merges"] += 1
                self.bank, est = engine.hll_bank_merge_count_rows_collective(
                    self.bank, rows, trow, mesh=self.mesh)
            else:
                self.bank, est = engine.hll_bank_merge_count_rows(
                    self.bank, rows, trow)
            self._bump(target)
            est = Readback(est)
            self.completer.submit(_complete_all([op], lambda est=est: _estimate(est)))

    # -- BitSet -------------------------------------------------------------

    def _check_not_hll(self, name: str, otype: str) -> None:
        if name in self._rows:
            raise WrongTypeError(f"key '{name}' holds hll, operation needs {otype}")

    def _bitset(self, name: str, nbits: int = None):
        self._check_not_hll(name, ObjectType.BITSET)
        obj = self.store.get(name, ObjectType.BITSET)
        if obj is None:
            if nbits is None:
                raise KeyError(f"bitset '{name}' does not exist")
            obj = self.store.get_or_create(
                name, ObjectType.BITSET, lambda: bitset_ops.make(nbits),
                {"nbits": nbits})
        return obj

    @staticmethod
    def _extend(obj, max_index: int) -> None:
        """Track the WRITTEN extent in Redis byte granularity: SETBIT extends
        the string to the byte holding the index, and size() / NOT act on
        that extent, not the power-of-two allocation."""
        ext = ((int(max_index) // 8) + 1) * 8
        if ext > obj.meta.get("extent_bits", 0):
            obj.meta["extent_bits"] = ext

    def _grow_for(self, obj, max_index: int):
        """Redis SETBIT grows the string; grow in powers of two."""
        nbits = obj.state.shape[0]
        if max_index < nbits:
            return obj
        new_bits = max(1024, 1 << int(max_index).bit_length())
        grown = bitset_ops.make(new_bits, device=self.device)
        grown[:nbits] = obj.state
        obj.meta["nbits"] = new_bits
        self.store.swap(obj.name, grown)
        return self.store.get(obj.name)

    @staticmethod
    def _max_index(ops: List[Op]) -> int:
        """Largest bit index of the run, from the host-side `max_idx` the
        models stamp into the payload (a host reduce for payloads without
        it); -1 for an all-empty run."""
        mx = -1
        for op in ops:
            m = op.payload.get("max_idx")
            if m is None:
                arr = op.payload["idx"]
                m = int(arr.max()) if arr.size else -1
            mx = max(mx, int(m))
        return mx

    def _bitset_mutate(self, target: str, ops: List[Op], kernel) -> None:
        # The kernels update the cell tensor in place; each chunk is still
        # swapped in, so the object's version counts chunks as in JAX.
        idx = np.concatenate([op.payload["idx"] for op in ops]).astype(np.int64)
        mx = self._max_index(ops)
        obj = self._bitset(target, nbits=1024)
        obj = self._grow_for(obj, mx if mx >= 0 else 0)
        if mx >= 0:
            self._extend(obj, mx)
        outs, spans = [], []
        for s, e in engine.chunk_spans(idx.shape[0]):
            pidx, valid = engine.pad_ints(idx[s:e])
            new, old = kernel(obj.state, self._to_device(pidx), self._to_device(valid))
            self.store.swap(target, new)
            outs.append(old)
            spans.append(e - s)
        self._touch(target)
        self.completer.submit(self._slice_results(ops, outs, spans))

    def _op_bitset_set(self, target: str, ops: List[Op]) -> None:
        self._bitset_mutate(target, ops, engine.bitset_set)

    def _op_bitset_clear(self, target: str, ops: List[Op]) -> None:
        self._check_not_hll(target, ObjectType.BITSET)
        if self.store.get(target, ObjectType.BITSET) is None:
            for op in ops:
                op.future.set_result(np.zeros((op.payload["idx"].shape[0],), bool))
            return
        self._bitset_mutate(target, ops, engine.bitset_clear)

    def _op_bitset_get(self, target: str, ops: List[Op]) -> None:
        self._check_not_hll(target, ObjectType.BITSET)
        obj = self.store.get(target, ObjectType.BITSET)
        if obj is None:
            for op in ops:
                op.future.set_result(np.zeros((op.payload["idx"].shape[0],), bool))
            return
        idx = np.concatenate([op.payload["idx"] for op in ops]).astype(np.int64)
        nbits = obj.state.shape[0]
        clipped = np.clip(idx, 0, nbits - 1)
        outs, spans = [], []
        for s, e in engine.chunk_spans(clipped.shape[0]):
            pidx, valid = engine.pad_ints(clipped[s:e])
            outs.append(engine.bitset_get(obj.state, self._to_device(pidx),
                                          self._to_device(valid)))
            spans.append(e - s)
        self.completer.submit(self._slice_results(
            ops, outs, spans, post=lambda flat: np.where(idx < nbits, flat, 0)))

    def _op_bitset_cardinality(self, target: str, ops: List[Op]) -> None:
        self._check_not_hll(target, ObjectType.BITSET)
        obj = self.store.get(target, ObjectType.BITSET)
        if obj is None:
            for op in ops:
                op.future.set_result(0)
            return
        # int32 partials come back; the exact combine is in host ints (an
        # int32 total wraps past 2^31 set bits).
        self._cached_read(
            target, "bitset_cardinality", ops,
            lambda: engine.bitset_cardinality_partials(obj.state),
            bitset_ops.combine_partials)

    def _op_bitset_length(self, target: str, ops: List[Op]) -> None:
        self._check_not_hll(target, ObjectType.BITSET)
        obj = self.store.get(target, ObjectType.BITSET)
        if obj is None:
            for op in ops:
                op.future.set_result(0)
            return
        self._cached_read(
            target, "bitset_length", ops,
            lambda: engine.bitset_length_partials(obj.state),
            bitset_ops.combine_length)

    def _op_bitset_size(self, target: str, ops: List[Op]) -> None:
        """STRLEN * 8: the written byte extent (0 for a never-written
        object), never the power-of-two allocation."""
        self._check_not_hll(target, ObjectType.BITSET)
        obj = self.store.get(target, ObjectType.BITSET)
        val = 0 if obj is None else obj.meta.get("extent_bits", 0)
        for op in ops:
            op.future.set_result(val)

    def _op_bitset_set_range(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            start, end, value = (op.payload["start"], op.payload["end"],
                                 op.payload["value"])
            obj = self._bitset(target, nbits=1024)
            if end > 0:
                obj = self._grow_for(obj, end - 1)
                if value:
                    # A range clear does not extend the written extent (the
                    # wire tier clamps it to the current string); single-bit
                    # clears do, as SETBIT does.
                    self._extend(obj, end - 1)
            self.store.swap(target, bitset_ops.set_range(obj.state, start, end, value))
            self._touch(target)
            op.future.set_result(None)

    def _op_bitset_op(self, target: str, ops: List[Op]) -> None:
        """BITOP AND/OR/XOR/NOT into the target; the target is an operand."""
        for op in ops:
            kind = op.payload["op"]
            arrays, src_objs = [], []
            for n in op.payload["names"]:
                # An HLL lives in the bank, not the store: without this check
                # it would read as absent instead of WRONGTYPE.
                self._check_not_hll(n, ObjectType.BITSET)
                o = self.store.get(n, ObjectType.BITSET)
                if o is not None:
                    arrays.append(o.state)
                    src_objs.append(o)
            if kind == "not":
                obj = self.store.get(target, ObjectType.BITSET)
                if obj is not None:
                    ext = obj.meta.get("extent_bits", 0)
                    if ext:  # NOT of a never-written string is a no-op
                        # In place over the written extent.
                        self.store.swap(target, engine.bitset_not_masked(obj.state, ext))
                        self._touch(target)
                op.future.set_result(None)
                continue
            obj = self._bitset(target, nbits=1024)
            arrays = [obj.state] + arrays
            width = max(a.shape[0] for a in arrays)
            if len(arrays) == 1:
                # No existing source: the destination stays as it is.
                acc = arrays[0]
            else:
                stack = torch.zeros((len(arrays), width), dtype=torch.uint8,
                                    device=self.device)
                for r, a in enumerate(arrays):
                    stack[r, : a.shape[0]] = a
                acc = engine.bitset_bitop(stack, kind)
            obj.meta["nbits"] = width
            # The result's written extent is the widest operand's.
            obj.meta["extent_bits"] = max(
                [obj.meta.get("extent_bits", 0)]
                + [o.meta.get("extent_bits", 0) for o in src_objs])
            self.store.swap(target, acc)
            self._touch(target)
            op.future.set_result(None)

    # -- Bloom --------------------------------------------------------------

    def _op_bloom_init(self, target: str, ops: List[Op]) -> None:
        """tryInit: create config + cells if absent; False if the filter
        exists already."""
        self._check_not_hll(target, ObjectType.BLOOM)
        for op in ops:
            n, p = op.payload["expected_insertions"], op.payload["false_probability"]
            blocked = bool(op.payload.get("blocked"))
            m = bloom_ops.optimal_num_of_bits(n, p)
            k = bloom_ops.optimal_num_of_hash_functions(n, m)
            if blocked:
                m = bloom_ops.blocked_geometry(m)
            bloom_ops.check_size(m)
            if self.store.get(target, ObjectType.BLOOM) is not None:
                op.future.set_result(False)
                continue
            self.store.get_or_create(
                target, ObjectType.BLOOM, lambda: bitset_ops.make(m),
                {"size": m, "hash_iterations": k, "expected_insertions": n,
                 "false_probability": p, "blocked": blocked})
            self._touch(target)
            op.future.set_result(True)

    def _bloom_meta(self, target: str):
        self._check_not_hll(target, ObjectType.BLOOM)
        obj = self.store.get(target, ObjectType.BLOOM)
        if obj is None:
            raise RuntimeError(f"bloom filter '{target}' is not initialized")
        return obj, obj.meta["size"], obj.meta["hash_iterations"]

    # -- Bloom host mirror ----------------------------------------------------
    #
    # A filter may be dual-resident: a packed host replica (the "mirror")
    # takes host folds and answers membership with no link traffic, and the
    # device copy is brought current (one packed upload and an OR) only
    # when a device-side op needs it. Invariants:
    #   * mirror valid   <=> mir["synced_dev"] == obj.version (no device
    #     write since the mirror was built or synced);
    #   * device current <=> mir["host_v"] == mir["absorbed_v"] (no host
    #     fold waiting to be absorbed).
    # Every device-side Bloom op syncs first, so when a device write bumps
    # the version no host bits are pending. Classic layout only.

    def _bloom_use_host(self, target: str, obj, nkeys: int) -> bool:
        if self.ingest == "device" or obj.meta.get("blocked"):
            return False
        if not native.available():
            return False
        mir = self._bloom_mirrors.get(target)
        if mir is not None and mir["synced_dev"] == obj.version:
            return True  # sticky: a valid mirror keeps serving host ops
        if self.ingest == "hostfold":
            return True
        return hostfold_policy(self.ingest, nkeys, self.device)

    def _bloom_mirror(self, target: str, obj, m: int) -> dict:
        """The current host replica, rebuilt when a device write made it
        stale: zeros for a never-written filter, else the device cells
        packed on the device and pulled once (m/8 bytes)."""
        mir = self._bloom_mirrors.get(target)
        if mir is not None and mir["synced_dev"] == obj.version:
            return mir
        if mir is not None and mir["host_v"] != mir["absorbed_v"]:
            # Pending host bits under a stale mirror: push them down first
            # (ORing true bits is always safe), then rebuild from the device.
            self._bloom_device_sync(target)
            obj = self.store.get(target, ObjectType.BLOOM)
        nbytes = (m + 7) // 8
        if obj.version == 0:
            bits = np.zeros(nbytes, np.uint8)
        else:
            bits = engine.bitset_pack(obj.state)[:nbytes].cpu().numpy().copy()
        mir = {"bits": bits, "synced_dev": obj.version,
               "host_v": 0, "absorbed_v": 0}
        self._bloom_mirrors[target] = mir
        return mir

    def _bloom_device_sync(self, target: str) -> None:
        """Absorb pending mirror bits into the device filter (one packed
        upload and an in-place OR). Device-side Bloom ops and the
        `bloom_sync` op call this."""
        mir = self._bloom_mirrors.get(target)
        if mir is None or mir["host_v"] == mir["absorbed_v"]:
            return
        obj = self.store.get(target, ObjectType.BLOOM)
        was_valid = mir["synced_dev"] == obj.version
        self.store.swap(target, engine.bitset_absorb_packed(
            obj.state, self._to_device(mir["bits"])))
        self._touch(target)
        mir["absorbed_v"] = mir["host_v"]
        if was_valid:
            mir["synced_dev"] = obj.version  # device == mirror now
        # else the mirror was already missing device writes: it stays stale
        # and the next host-side op rebuilds it from the device.

    def _op_bloom_sync(self, target: str, ops: List[Op]) -> None:
        """Barrier: make the device filter hold every host-mirror write (a
        no-op when nothing is pending or the name is no Bloom filter)."""
        obj = self.store.get(target)
        if obj is not None and obj.otype == ObjectType.BLOOM:
            self._bloom_device_sync(target)
        for op in ops:
            op.future.set_result(None)

    def _bloom_host_add(self, target: str, obj, m: int, k: int,
                        ops: List[Op]) -> None:
        mir = self._bloom_mirror(target, obj, m)
        for op in ops:
            p = op.payload
            if "packed" in p:
                newly = native.bloom_fold_u64(p["packed"], mir["bits"], k, m,
                                              self.seed)
            else:
                newly = native.bloom_fold_rows(p["data"], p["lengths"],
                                               mir["bits"], k, m, self.seed)
            # Through the completer: per-target results stay in order.
            self.completer.submit(_complete_all(
                [op], lambda v=newly.view(np.bool_): v))
        mir["host_v"] += 1
        self._touch(target)

    def _bloom_host_contains(self, target: str, obj, m: int, k: int,
                             ops: List[Op], count_only: bool = False,
                             on_result=None) -> None:
        mir = self._bloom_mirror(target, obj, m)
        for op in ops:
            p = op.payload
            if "packed" in p:
                hits = native.bloom_contains_u64(p["packed"], mir["bits"], k,
                                                 m, self.seed)
            else:
                hits = native.bloom_contains_rows(p["data"], p["lengths"],
                                                  mir["bits"], k, m, self.seed)
            res = int(hits.sum()) if count_only else hits.view(np.bool_)
            if on_result is not None:
                on_result(op, res)
            self.completer.submit(_complete_all([op], lambda v=res: v))

    @staticmethod
    def _bloom_kernels(obj):
        """(add_packed, contains_packed, add_bytes, contains_bytes) for the
        filter's layout (classic or blocked, ops/bloom.py BLOCK_BITS)."""
        if obj.meta.get("blocked"):
            return (engine.blocked_bloom_add_packed,
                    engine.blocked_bloom_contains_packed,
                    engine.blocked_bloom_add_bytes,
                    engine.blocked_bloom_contains_bytes)
        return (engine.bloom_add_packed, engine.bloom_contains_packed,
                engine.bloom_add_bytes, engine.bloom_contains_bytes)

    def _bloom_run(self, target: str, ops: List[Op], mutate: bool,
                   on_result=None) -> None:
        """Shared Bloom dispatch, in op order (results slice by position):
        packed runs gather small arrays and stream chunks through the
        staging pipeline; byte runs coalesce and pad per chunk."""
        obj, m, k = self._bloom_meta(target)
        add_packed, contains_packed, add_bytes, contains_bytes = (
            self._bloom_kernels(obj))
        if mutate and not obj.meta.get("blocked"):
            # Classic adds take the planner's set-bits strategy (scatter or
            # the segment-OR kernel); blocked adds keep their scatter.
            impl = self._plan_bits(
                sum(op.nkeys or _lanes_of(op) for op in ops), m)
            add_packed = functools.partial(add_packed, impl=impl)
            add_bytes = functools.partial(add_bytes, impl=impl)
        outs, spans = [], []

        def emit(res, n):
            if mutate:
                new, res = res
                self.store.swap(target, new)  # the same tensor: inserts are in place
            outs.append(res)
            spans.append(n)

        for fmt, group in _format_runs(ops):
            if fmt == "packed":
                fn = add_packed if mutate else contains_packed
                chunks = [(None, a[s:e]) for a in _segments(
                    [_as_i64(op.payload["packed"]) for op in group],
                    engine.MIN_BUCKET) for s, e in engine.chunk_spans(a.shape[0])]

                def dispatch(_i, staged, fn=fn):
                    _, keys, count, ready = staged
                    emit(fn(obj.state, self._staged_keys(keys, ready), count,
                            k, m, self.seed), count)

                self._pipeline.run(chunks, self._stage_chunk, dispatch)
            else:
                fn = add_bytes if mutate else contains_bytes
                data, lengths, _ = self._coalesce_bytes(group)
                for s, e in engine.chunk_spans(data.shape[0]):
                    pdata, plengths, valid = engine.pad_bytes(data[s:e], lengths[s:e])
                    emit(fn(obj.state, self._to_device(pdata),
                            self._to_device(plengths), self._to_device(valid),
                            k, m, self.seed), e - s)
        if mutate:
            self._touch(target)
        self.completer.submit(
            self._slice_results(ops, outs, spans, on_result=on_result))

    def _op_bloom_add(self, target: str, ops: List[Op]) -> None:
        obj, m, k = self._bloom_meta(target)
        if self._bloom_use_host(target, obj,
                                sum(op.nkeys or _lanes_of(op) for op in ops)):
            self._bloom_host_add(target, obj, m, k, ops)
            return
        self._bloom_device_sync(target)
        self._bloom_run(target, ops, mutate=True)

    # Probe payloads above this many keys are not memoized: digesting them
    # would rival the membership kernels themselves.
    _CONTAINS_CACHE_MAX = 4096

    @classmethod
    def _probe_digest(cls, op: Op):
        """Fingerprint of a small host probe payload, or None for device
        payloads and large ones (those skip the read cache)."""
        import hashlib

        p = op.payload
        if "device_packed" in p:
            return None
        h = hashlib.blake2b(digest_size=16)
        if "packed" in p:
            arr = p["packed"]
            if arr.shape[0] > cls._CONTAINS_CACHE_MAX:
                return None
            h.update(b"p")
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            data, lengths = p["data"], p["lengths"]
            if data.shape[0] > cls._CONTAINS_CACHE_MAX:
                return None
            h.update(b"b")
            h.update(np.ascontiguousarray(data).tobytes())
            h.update(np.ascontiguousarray(lengths).tobytes())
        return h.digest()

    def _op_bloom_contains(self, target: str, ops: List[Op]) -> None:
        obj, m, k = self._bloom_meta(target)
        use_host = self._bloom_use_host(
            target, obj, sum(op.nkeys or _lanes_of(op) for op in ops))
        if not use_host:
            # Sync before reading the epoch: an absorb bumps it, and the
            # cache entries filled below must stay servable after.
            self._bloom_device_sync(target)
        epoch = self._epoch(target)
        pending: List[Op] = []
        digests = {}
        for op in ops:
            dig = self._probe_digest(op)
            if dig is not None:
                hit = self.read_cache.get(target, "bloom_contains", epoch, extra=dig)
                if self.read_cache.is_hit(hit):
                    # Served through the completer, so per-target results
                    # stay in submission order.
                    _trace_cache([op], hit=True)
                    self.completer.submit(_complete_all([op], lambda v=hit: v.copy()))
                    continue
                digests[id(op)] = dig
            _trace_cache([op], hit=False)
            pending.append(op)
        if not pending:
            return

        def remember(op: Op, value) -> None:
            dig = digests.get(id(op))
            if dig is not None:
                self.read_cache.put(target, "bloom_contains", epoch,
                                    np.array(value, copy=True), extra=dig)

        if use_host:
            self._bloom_host_contains(target, obj, m, k, pending,
                                      on_result=remember)
            return
        self._bloom_run(target, pending, mutate=False, on_result=remember)

    def _op_bloom_contains_count(self, target: str, ops: List[Op]) -> None:
        """Hit count per op, for host keys or keys already on the device
        (int64 tensor): chunks reduce on the device, one scalar comes back."""
        obj, m, k = self._bloom_meta(target)
        host_ops = [op for op in ops if "device_packed" not in op.payload]
        if host_ops and self._bloom_use_host(
                target, obj, sum(op.nkeys or _lanes_of(op) for op in host_ops)):
            self._bloom_host_contains(target, obj, m, k, host_ops,
                                      count_only=True)
            ops = [op for op in ops if "device_packed" in op.payload]
            if not ops:
                return
        self._bloom_device_sync(target)
        obj = self.store.get(target, ObjectType.BLOOM)
        count_fn = (engine.blocked_bloom_contains_count_packed
                    if obj.meta.get("blocked")
                    else engine.bloom_contains_count_packed)
        for op in ops:
            if "device_packed" in op.payload:
                keys = op.payload["device_packed"].to(self.device)
            else:
                keys = self._to_device(_as_i64(op.payload["packed"]))
            parts = [count_fn(obj.state, keys[s:e], e - s, k, m, self.seed)
                     for s, e in engine.chunk_spans(int(keys.shape[0]))]
            if not parts:
                op.future.set_result(0)
                continue
            total = Readback(functools.reduce(torch.add, parts))
            self.completer.submit(_complete_all([op], lambda t=total: int(t.wait())))

    def _op_bloom_meta(self, target: str, ops: List[Op]) -> None:
        obj, _, _ = self._bloom_meta(target)
        meta = dict(obj.meta)
        for op in ops:
            op.future.set_result(meta)

    def _op_bloom_count(self, target: str, ops: List[Op]) -> None:
        """count(): -m/k ln(1 - BITCOUNT/m), BITCOUNT from a valid host
        mirror, else read from the device (the popcount kernel on a
        card)."""
        obj, m, k = self._bloom_meta(target)
        mir = self._bloom_mirrors.get(target)
        if mir is not None and mir["synced_dev"] == obj.version:
            # The valid mirror holds every bit: a host popcount, no device.
            epoch = self._epoch(target)
            value = self.read_cache.get(target, "bloom_count", epoch)
            _trace_cache(ops, hit=self.read_cache.is_hit(value))
            if not self.read_cache.is_hit(value):
                value = int(round(bloom_math.count_estimate(
                    native.popcount(mir["bits"]), m, k)))
                self.read_cache.put(target, "bloom_count", epoch, value)
            self.completer.submit(_complete_all(ops, lambda v=value: v))
            return
        self._bloom_device_sync(target)
        obj = self.store.get(target, ObjectType.BLOOM)
        self._cached_read(
            target, "bloom_count", ops,
            lambda: engine.bitset_cardinality_partials(obj.state),
            lambda partials: int(round(bloom_math.count_estimate(
                bitset_ops.combine_partials(partials), m, k))))

    def _install_bits(self, name: str, otype: str, cells, meta) -> None:
        """Create or overwrite a store BitSet / Bloom from host cells."""
        self._check_not_hll(name, otype)
        host = np.asarray(cells).astype(np.uint8)
        meta = dict(meta or {})
        if otype == ObjectType.BITSET:
            meta.setdefault("nbits", host.shape[0])
            meta.setdefault("extent_bits", host.shape[0])
        arr = torch.from_numpy(host.copy()).to(self.device)
        obj = self.store.get_or_create(name, otype, lambda: arr, meta)
        self.store.swap(name, arr)
        obj.meta.update(meta)
        # The whole object was replaced: no earlier read may be served, and
        # a host mirror of the old filter is void.
        self._bloom_mirrors.pop(name, None)
        self._touch(name)
        self.read_cache.invalidate(name)

    def _op_bits_export(self, target: str, ops: List[Op]) -> None:
        """(otype, host cells, meta, version) of a BitSet / Bloom, else None."""
        obj = self.store.get(target)
        if obj is None or obj.otype not in (ObjectType.BITSET, ObjectType.BLOOM):
            for op in ops:
                op.future.set_result(None)
            return
        if obj.otype == ObjectType.BLOOM:
            self._bloom_device_sync(target)
            obj = self.store.get(target)
        snapshot = Readback(obj.state.clone())
        otype, meta, version = obj.otype, dict(obj.meta), obj.version
        self.completer.submit(_complete_all(
            ops, lambda: (otype, snapshot.wait().numpy().astype(np.uint8),
                          meta, version)))

    def _op_bits_import(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            self._install_bits(target, op.payload["otype"], op.payload["array"],
                               op.payload.get("meta"))
            op.future.set_result(True)

    # -- generic ------------------------------------------------------------

    def _delete_one(self, name: str) -> bool:
        """Drop one sketch (its bank row, or its store object and Bloom
        mirror); whether it existed."""
        row = self._alloc.release(name)
        if row is not None:
            self.bank = engine.hll_bank_zero_row(self.bank, row)
            res = True
        else:
            self._bloom_mirrors.pop(name, None)
            res = self.store.delete(name)
        self._touch(name)
        self.read_cache.invalidate(name)
        return res

    def _op_delete(self, target: str, ops: List[Op]) -> None:
        res = self._delete_one(target)
        for op in ops:
            op.future.set_result(res)

    def _op_exists(self, target: str, ops: List[Op]) -> None:
        res = target in self._rows or self.store.exists(target)
        for op in ops:
            op.future.set_result(res)

    def _op_rename(self, target: str, ops: List[Op]) -> None:
        """RENAME/RENAMENX (bank rows move by remapping). Atomic: the whole
        check+move runs on the dispatcher."""
        for op in ops:
            new = op.payload["newkey"]
            # A missing source errors regardless of the destination and
            # leaves the destination intact.
            if target not in self._rows and not self.store.exists(target):
                op.future.set_exception(KeyError(f"no such key '{target}'"))
                continue
            if op.payload.get("nx") and (
                    new in self._rows or self.store.exists(new)):
                op.future.set_result(False)
                continue
            # RENAME overwrites the destination.
            row = self._alloc.release(new)
            if row is not None:
                self.bank = engine.hll_bank_zero_row(self.bank, row)
            self.store.delete(new)
            self._bloom_mirrors.pop(new, None)
            if target in self._rows:
                self._alloc.rows[new] = self._alloc.rows.pop(target)
                self._alloc.versions[new] = (
                    self._alloc.versions.pop(target, 0) + 1)
            else:
                self.store.rename(target, new)
                mir = self._bloom_mirrors.pop(target, None)
                if mir is not None:
                    self._bloom_mirrors[new] = mir
            for name in (target, new):
                self._touch(name)
                self.read_cache.invalidate(name)
            op.future.set_result(True)

    def _op_flushall(self, target: str, ops: List[Op]) -> None:
        # The bank is dropped, not zeroed: reallocated on the next HLL touch.
        self._alloc.clear()
        self.bank = None
        self._bloom_mirrors.clear()
        self._epochs.clear()
        self.read_cache.clear()
        self.store.flushall()
        self._account_bank()
        for op in ops:
            op.future.set_result(None)

    # -- geo remote apply (cross-site replication, geo/) --------------------

    def _op_geo_merge(self, target: str, ops: List[Op]) -> None:
        """The classic absorb of remote planes: ingest configs without the
        delta window, and targets its gate refused (blocked Blooms,
        WRONGTYPE probes). Each plane is maxed into the target on the
        device, one op at a time; the stacked _geo_fold_group path is the
        hot one."""
        self.counters["geo_classic"] += len(ops)
        for op in ops:
            try:
                self._geo_merge_one(target, op.payload)
            except Exception as exc:  # noqa: BLE001 — per-op isolation
                op.future.set_exception(classify(exc, seam="kernel_launch"))
                continue
            op.future.set_result(True)

    def _geo_merge_one(self, target: str, payload: dict) -> None:
        inner = payload["inner"]
        plane = self._to_device(self._geo_plane(payload))
        if inner == "hll_add":
            row = self._hll_row(target)  # WRONGTYPE if a store object
            bank = self._ensure_bank()
            regs = torch.maximum(engine.hll_bank_row(bank, row).to(plane.device),
                                 plane.to(torch.int32))
            self.bank = engine.hll_bank_set_row(bank, regs, row)
            self._bump(target)
            return
        if inner == "bloom_add":
            obj = self._geo_bloom_ensure(target, payload.get("meta") or {})
            m = obj.meta["size"]
            if int(payload["cells"]) != m:
                raise RuntimeError(
                    f"geo bloom plane for '{target}' sized "
                    f"{payload['cells']} bits vs local filter {m}")
            self._bloom_device_sync(target)
            obj = self.store.get(target, ObjectType.BLOOM)
            self.store.swap(target, torch.maximum(
                obj.state, engine.delta_unpack(plane, m)))
            self._bloom_mirrors.pop(target, None)
            self._touch(target)
            return
        # bitset_set
        obj = self._bitset(target, nbits=1024)
        cells = int(payload["cells"])
        obj = self._grow_for(obj, max(cells - 1, 0))
        ext = int((payload.get("meta") or {}).get("max_idx", -1))
        if ext >= 0:
            self._extend(obj, ext)
        merged = obj.state.clone()
        unp = engine.delta_unpack(plane, plane.shape[0] * 8)
        n = min(unp.shape[0], merged.shape[0])
        torch.maximum(merged[:n], unp[:n], out=merged[:n])
        self.store.swap(target, merged)
        self._touch(target)

    def _op_geo_replace(self, target: str, ops: List[Op]) -> None:
        """Stamped full-state overwrite, the LWW half of the geo contract
        (BitSet clears, rename destinations, snapshot repair). The applier
        decided that the stamp wins before dispatching; this handler only
        installs the state."""
        for op in ops:
            try:
                payload = op.payload
                inner = payload["inner"]
                plane = self._geo_plane(payload)
                if inner == "hll_add":
                    row = self._hll_row(target)
                    self.bank = engine.hll_bank_set_row(
                        self._ensure_bank(),
                        self._to_device(plane.astype(np.int32)), row)
                    self._bump(target)
                    self.read_cache.invalidate(target)
                else:
                    otype = (ObjectType.BLOOM if inner == "bloom_add"
                             else ObjectType.BITSET)
                    cells = int(payload["cells"])
                    meta = dict(payload.get("meta") or {})
                    meta.pop("max_idx", None)
                    self._install_bits(target, otype,
                                       np.unpackbits(plane)[:cells], meta)
            except Exception as exc:  # noqa: BLE001 — per-op isolation
                op.future.set_exception(classify(exc, seam="kernel_launch"))
                continue
            op.future.set_result(True)

    def _op_geo_delete(self, target: str, ops: List[Op]) -> None:
        """Stamped tombstone delete: in state, _op_delete; the (origin_seq,
        site) stamp in the payload is for the journal (crash replay) and
        the applier's LWW bookkeeping."""
        self._op_delete(target, ops)

    def _op_geo_flush(self, target: str, ops: List[Op]) -> None:
        """Stamped keyspace flush: deletes the concrete key list the applier
        resolved against its LWW floors (keys with writes newer than the
        flush stamp survive), so replay is deterministic."""
        for op in ops:
            op.future.set_result(sum(
                self._delete_one(name) for name in op.payload.get("keys", ())))

    def _op_keys(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            op.future.set_result(self.names((op.payload or {}).get("pattern", "*")))

