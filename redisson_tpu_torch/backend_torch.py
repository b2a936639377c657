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

The group-coalesced write kinds (`GLOBAL_COALESCE`) retire through
`_classic_group_run`, as the JAX backend's runs do whenever the delta
planner does not take them. The delta/tape ingest dispatch, the Bloom host
mirror (it needs the native fold library) and the mesh collectives arrive
with their slices; until then the Bloom handlers behave as the JAX
backend's do without the native library: every op runs on the device.
"""

from __future__ import annotations

import fnmatch
import functools
import queue
import threading
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np
import torch

from redisson_tpu_torch import config as config_mod
from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch import engine
from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.ingest import kernels as ingest_kernels
from redisson_tpu_torch.ingest.pipeline import StagingPipeline
from redisson_tpu_torch.ingest.planner import IngestPlanner, default_planner
from redisson_tpu_torch.ops import bitset as bitset_ops
from redisson_tpu_torch.ops import bloom as bloom_ops
from redisson_tpu_torch.ops import bloom_math
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


def _complete_all(ops: List[Op], materialize: Callable[[], object]) -> Callable:
    """Closure completing every op with materialize()'s value (or error)."""

    def run():
        try:
            value = materialize()
        except Exception as exc:  # noqa: BLE001 — device errors surface here
            for op in ops:
                if not op.future.done():
                    op.future.set_exception(exc)
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
            host = None if flag is None else flag.wait().numpy()
        except Exception as exc:  # noqa: BLE001
            for op in ops:
                if not op.future.done():
                    op.future.set_exception(exc)
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

    def row_of(self, name: str) -> int:
        row = self.rows.get(name)
        if row is not None:
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


def _op_lanes(op: Op) -> int:
    p = op.payload
    for key in ("idx", "packed", "data"):
        if key in p:
            return p[key].shape[0]
    return 0


class TorchBackend:
    """Op interpreter over a shared HLL bank: every named HLL is a row of
    ONE [S, m] int32 tensor on `store.device`, so countWith/mergeWith over
    hundreds of sketches is one gather + row-max. hll_add coalesces across
    targets (one device call carries keys for many sketches through a
    per-key row vector)."""

    GLOBAL_COALESCE = frozenset({"hll_add", "bloom_add", "bitset_set"})

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
        # Per-name write epochs: the read cache's whole invalidation protocol.
        self._epochs: dict = {}
        self.read_cache = EpochReadCache(read_cache_entries)

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

    def _grow_bank(self, new_cap: int) -> int:
        """RowAllocator grow hook: reallocate the bank at `new_cap` rows."""
        self.bank = engine.hll_bank_grow(self._ensure_bank(), new_cap)
        return new_cap

    def _ensure_bank(self) -> torch.Tensor:
        if self.bank is None:
            self.bank = engine.hll_bank_make(self.bank_capacity,
                                             device=self.device)
        return self.bank

    def _plan_ingest(self, nkeys: int) -> str:
        """One run's HLL insert: 'scatter' | 'sort' | 'segment'."""
        if self.ingest in ("scatter", "sort", "segment"):
            return self.ingest
        if self.ingest == "device":
            return self.hll_impl
        return self.planner.plan("hll", nkeys).path

    def _plan_bits(self, nkeys: int, m: int) -> str:
        """Set-bits strategy of a classic Bloom add: 'scatter' | 'segment'.
        A forced 'segment' carries over from the config, every other forced
        value keeps the scatter, and 'auto' asks the planner. Filters of
        2^31 cells or more are never planned onto 'segment': its int32
        codes cannot hold their one-past-the-end sentinel."""
        if self.ingest == "segment":
            return "segment"
        if self.ingest != "auto":
            return "scatter"
        exclude = ("segment",) if m > ingest_kernels.MAX_SEGMENT_CELLS else ()
        return self.planner.plan("bits", nkeys, exclude=exclude).path

    # -- state carry-over ---------------------------------------------------

    def from_jax_state(self, bank_np: np.ndarray, rows: dict,
                       objects: Optional[dict] = None) -> None:
        """Install a bank (numpy [S, m] int32) and its name -> row map, as
        taken from the JAX backend (`TpuBackend.bank`, `TpuBackend._rows`),
        and, given `objects`, replace the store's BitSet / Bloom objects
        with them: name -> (otype, cells as numpy uint8, meta, ...), what
        the JAX backend's `bits_export` returns. Run on the dispatcher
        (`execute_barrier`) when the executor is live."""
        if objects is not None:
            self.store.flushall()
            for name, (otype, cells, meta, *_rest) in objects.items():
                self._install_bits(str(name), otype, cells, meta)
        bank_np = np.ascontiguousarray(bank_np, np.int32)
        self.bank = torch.from_numpy(bank_np.copy()).to(self.device)
        alloc = self._alloc
        alloc.clear()
        alloc.capacity = bank_np.shape[0]
        alloc.rows.update({str(n): int(r) for n, r in rows.items()})
        alloc.next = max(alloc.rows.values(), default=-1) + 1
        used = set(alloc.rows.values())
        alloc.free = [r for r in range(alloc.next) if r not in used]
        for name in alloc.rows:
            self._bump(name)
        self.read_cache.clear()

    def to_numpy_state(self):
        """(bank as numpy [S, m] int32, name -> row map): the reverse of
        `from_jax_state`."""
        bank = self._ensure_bank()
        return bank.cpu().numpy().copy(), dict(self._rows)

    def to_numpy_objects(self) -> dict:
        """name -> (otype, cells as numpy uint8, meta) for every BitSet and
        Bloom object: the reverse of `from_jax_state`'s `objects`."""
        return {name: (obj.otype, obj.state.cpu().numpy().copy(), dict(obj.meta))
                for name in self.store.keys()
                if (obj := self.store.get(name)) is not None}

    # -- dispatch -----------------------------------------------------------

    def run(self, kind: str, target: str, ops: List[Op]) -> None:
        device_mod.bind_thread(self.device)
        if kind in self.GLOBAL_COALESCE:
            # A stolen run spans targets; the delta/tape slice will plan
            # groups of it onto the fused merge before this fallback.
            self._classic_group_run(ops)
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
                for op in tops:
                    if not op.future.done():
                        op.future.set_exception(exc)

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
                parts = [rb.wait().numpy()[:n] for rb, n in zip(rbs, spans)]
                flat = np.concatenate(parts) if parts else np.zeros((0,), bool)
                if post is not None:
                    flat = post(flat)
            except Exception as exc:  # noqa: BLE001
                for op in ops:
                    if not op.future.done():
                        op.future.set_exception(exc)
                return
            pos = 0
            for op in ops:
                n = _op_lanes(op)
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
        return self._alloc.row_of(name)

    def _bump(self, name: str) -> None:
        self._alloc.bump(name)
        self._touch(name)

    def _epoch(self, name: str) -> int:
        return self._epochs.get(name, 0)

    def _touch(self, name: str) -> None:
        """A write made `name`'s state diverge from any cached read."""
        self._epochs[name] = self._epochs.get(name, 0) + 1

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
        byte_ops = [op for op in ops if "data" in op.payload]
        device_ops = [op for op in ops if "device_packed" in op.payload]
        host_ops = packed_ops + byte_ops
        if host_ops:
            path = self._plan_ingest(sum(op.nkeys or self._payload_nkeys(op)
                                         for op in host_ops))
            for group in (packed_ops, byte_ops):
                if group:
                    self._hll_add_group(group, path)
        if device_ops:
            self._hll_add_device(device_ops, self._plan_ingest(
                sum(int(op.payload["device_packed"].shape[0])
                    for op in device_ops)))
        for op in ops:
            if not ({"packed", "data", "device_packed"} & op.payload.keys()):
                op.future.set_exception(ValueError(
                    f"unknown hll_add payload keys: {sorted(op.payload)}"))

    def _complete_changed(self, ops: List[Op], parts) -> None:
        complete_changed_rows(
            self.completer, ops, [self._rows[op.target] for op in ops], parts)

    @staticmethod
    def _payload_nkeys(op: Op) -> int:
        for key in ("packed", "data"):
            if key in op.payload:
                return op.payload[key].shape[0]
        return 0

    def _one_row(self, ops: List[Op]):
        """The row when every op targets one sketch, else None."""
        targets = {op.target for op in ops}
        if len(targets) == 1:
            return self._rows[next(iter(targets))]
        return None

    def _hll_add_group(self, ops: List[Op], impl: str = "scatter") -> None:
        # Kernels are only launched here; the `changed` flags resolve on the
        # completer. Single-target chunks use the scalar-row kernels (the
        # `impl` insert); multi-target runs carry a per-key row vector
        # through the flat scatter.
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
                        valid, self.seed, self.family)
                parts.append(changed)
        for op in ops:
            self._bump(op.target)
        self._complete_changed(ops, parts)

    def _hll_add_device(self, ops: List[Op], impl: str) -> None:
        """Keys already on the device (int64 [n]): one launch chain per
        chunk at its padded shape, no host copy and no transfer."""
        parts = []
        for op in ops:
            row = self._rows[op.target]
            keys = op.payload["device_packed"].to(self.device)
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
            self.completer.submit(_complete_all(ops, lambda v=cached: v))
            return
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
        # Union count across sketches: one gather + row-max + estimator
        # over the padded row vector; never mutates.
        for op in ops:
            rows = self._count_rows(target, op.payload["names"])
            if rows is None:
                op.future.set_result(0)
                continue
            est = Readback(engine.hll_bank_count_rows(
                self.bank, engine.pad_rows_repeat(rows)))
            self.completer.submit(_complete_all([op], lambda est=est: _estimate(est)))

    def _merge_rows(self, target: str, names) -> tuple:
        """(target_row, padded source-row vector incl. target) for the
        PFMERGE family; missing sources are skipped."""
        trow = self._hll_row(target)
        rows = [trow] + [r for n in names
                         if (r := self._hll_row(n, create=False)) is not None]
        return trow, engine.pad_rows_repeat(np.array(rows, np.int32))

    def _op_hll_merge_with(self, target: str, ops: List[Op]) -> None:
        # PFMERGE: fold the sources into the target row, in place (the
        # target is in the gathered set, so its registers take part).
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            self.bank = engine.hll_bank_merge_rows(self.bank, rows, trow)
            self._bump(target)
            op.future.set_result(None)

    def _op_hll_merge_count(self, target: str, ops: List[Op]) -> None:
        # Fused PFMERGE + PFCOUNT: one readback instead of two.
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            self.bank, est = engine.hll_bank_merge_count_rows(self.bank, rows, trow)
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
                sum(op.nkeys or _op_lanes(op) for op in ops), m)
            add_packed = functools.partial(add_packed, impl=impl)
            add_bytes = functools.partial(add_bytes, impl=impl)
        outs, spans = [], []

        def emit(res, n):
            if mutate:
                new, res = res
                self.store.swap(target, new)  # a fresh tensor under segment
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
        self._bloom_meta(target)
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
                    self.completer.submit(_complete_all([op], lambda v=hit: v.copy()))
                    continue
                digests[id(op)] = dig
            pending.append(op)
        if not pending:
            return

        def remember(op: Op, value) -> None:
            dig = digests.get(id(op))
            if dig is not None:
                self.read_cache.put(target, "bloom_contains", epoch,
                                    np.array(value, copy=True), extra=dig)

        self._bloom_run(target, pending, mutate=False, on_result=remember)

    def _op_bloom_contains_count(self, target: str, ops: List[Op]) -> None:
        """Hit count per op, for host keys or keys already on the device
        (int64 tensor): chunks reduce on the device, one scalar comes back."""
        obj, m, k = self._bloom_meta(target)
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
        """count(): -m/k ln(1 - BITCOUNT/m), BITCOUNT read from the device
        (the popcount kernel on a card)."""
        obj, m, k = self._bloom_meta(target)
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
        # The whole object was replaced: no earlier read may be served.
        self._touch(name)
        self.read_cache.invalidate(name)

    def _op_bits_export(self, target: str, ops: List[Op]) -> None:
        """(otype, host cells, meta, version) of a BitSet / Bloom, else None."""
        obj = self.store.get(target)
        if obj is None or obj.otype not in (ObjectType.BITSET, ObjectType.BLOOM):
            for op in ops:
                op.future.set_result(None)
            return
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

    def _op_delete(self, target: str, ops: List[Op]) -> None:
        row = self._alloc.release(target)
        if row is not None:
            self.bank = engine.hll_bank_zero_row(self.bank, row)
            res = True
        else:
            res = self.store.delete(target)
        self._touch(target)
        self.read_cache.invalidate(target)
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
            if target in self._rows:
                self._alloc.rows[new] = self._alloc.rows.pop(target)
                self._alloc.versions[new] = (
                    self._alloc.versions.pop(target, 0) + 1)
            else:
                self.store.rename(target, new)
            for name in (target, new):
                self._touch(name)
                self.read_cache.invalidate(name)
            op.future.set_result(True)

    def _op_flushall(self, target: str, ops: List[Op]) -> None:
        # The bank is dropped, not zeroed: reallocated on the next HLL touch.
        self._alloc.clear()
        self.bank = None
        self._epochs.clear()
        self.read_cache.clear()
        self.store.flushall()
        for op in ops:
            op.future.set_result(None)

    def _op_keys(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            op.future.set_result(self.names((op.payload or {}).get("pattern", "*")))

