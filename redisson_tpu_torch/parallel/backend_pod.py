"""Pod backend: HLL objects live as rows of a mesh-sharded sketch bank
(counterpart of `redisson_tpu.parallel.backend_pod`).

The cluster-mode analogue (`cluster/ClusterConnectionManager.java`): object
names are assigned rows in an [S, m] bank sharded over the logical mesh
(`parallel/mesh.py`): a `mesh.Sharded` whose block of S/D rows lives on
each entry's own device; placement is by allocation order (contiguous rows
-> balanced shards). BitSets and Bloom filters are mesh-sharded bit arrays
(`parallel/sharded_bits.py`) that one logical array spans, a block of
cells per entry; every other kind delegates to a single-device
TorchBackend on the mesh's home (entry 0's device), as JAX's delegate
sits on device 0. Cross-block results (PFMERGE partials, old-bit sums,
insert flags) meet on home by peer copy.

Cross-object coalescing: hll_add is GLOBAL_COALESCE, so one run carries
inserts for thousands of sketches (each key tagged with its target row)
and each chunk is one sharded insert: per shard, one multi-target
`seg_insert` launch over that shard's rows.

Byte keys hash on the bank's device with `ops.hashing.murmur3_x64_128`
and enter the bank pre-hashed: the same h1 the single-device path
computes for the same bytes, so pod and single-device estimates agree bit
for bit (JAX hashes them on the host with its native batch murmur3, which
the port's host library does not have).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch import engine
from redisson_tpu_torch.backend_torch import (
    Readback, RowAllocator, TorchBackend, _as_i64, _complete_all,
    _format_runs, _segments, complete_changed_rows)
from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.fault import inject as fault_inject
from redisson_tpu_torch.ingest.pipeline import StagingPipeline
from redisson_tpu_torch.ops import bloom as bloom_ops
from redisson_tpu_torch.ops import bloom_math, hashing
from redisson_tpu_torch.parallel import sharded, sharded_bits
from redisson_tpu_torch.parallel.mesh import bank_sharding, get_mesh
from redisson_tpu_torch.store import ObjectType, SketchStore, WrongTypeError


class _PodBits:
    """One mesh-sharded bit object (BitSet or Bloom): the pod-tier analogue
    of a stored object, whose state is a range-sharded cell array."""

    __slots__ = ("name", "otype", "state", "meta", "version")

    def __init__(self, name: str, otype: str, state, meta: dict):
        self.name = name
        self.otype = otype
        self.state = state
        self.meta = meta
        self.version = 0

    @property
    def logical_n(self) -> int:
        return self.meta["size"] if self.otype == ObjectType.BLOOM else self.meta["nbits"]


class PodBackend:
    GLOBAL_COALESCE = frozenset({"hll_add"})
    BLOOM_STRICT_MOD = True  # same index-math precondition as one device
    # Like the single-device tier: bank / store swaps and version bumps all
    # happen on the dispatcher inside run(); only result readback is
    # deferred to the completer.
    DISPATCH_TIME_STATE = True

    def __init__(self, cfg):
        self._device_spec = cfg.device
        self.mesh = get_mesh(cfg.num_shards, device=cfg.device)
        self.device = self.mesh.home
        self.seed = cfg.hash_seed
        self.family = "m3"
        cap = cfg.bank_capacity
        ndev = self.mesh.size
        if cap % ndev:
            cap += ndev - cap % ndev
        # Shared row bookkeeping (free-list reuse, grow-on-full, versions).
        self._alloc = RowAllocator(cap, self._grow_hook)
        self.bank = sharded.make_bank(self.mesh, cap)
        # Mesh-sharded bit objects: not in the delegate's store.
        self._bits: dict = {}
        # Non-HLL kinds delegate to a single-device backend. It SHARES this
        # allocator, so its WRONGTYPE guards see the pod's bank rows too.
        self.store = SketchStore(self.device)
        self._delegate = TorchBackend(
            self.store, hll_impl=cfg.hll_impl, seed=cfg.hash_seed,
            ingest=cfg.ingest, read_cache_entries=cfg.read_cache_entries)
        self._delegate._alloc = self._alloc
        # Host staging of chunk N+1 overlaps the dispatch of chunk N.
        self._pipeline = StagingPipeline(depth=2)
        # memstat ledger or None: the bank's bytes on every (re)allocation.
        self.accounting = None

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

    @property
    def completer(self):
        """The delegate's completer: client.shutdown() drains pod-mode
        completions exactly like single-device mode."""
        return self._delegate.completer

    @property
    def read_cache(self):
        return self._delegate.read_cache

    def ingest_stats(self) -> dict:
        return self._delegate.ingest_stats()

    def scratch_bytes(self) -> dict:
        return self._delegate.scratch_bytes()

    def _account_bank(self) -> None:
        """Report the bank's bytes to the memstat ledger (creation, growth,
        reshard, flushall and state installs call this)."""
        if self.accounting is not None:
            self.accounting.set_bank_bytes(int(self.bank.nbytes))

    # -- routing ------------------------------------------------------------

    def row_of(self, name: str) -> int:
        row = self._alloc.rows.get(name)
        if row is not None:
            return row
        if self.store.get(name) is not None:
            # The single-device keyspace rule: a name the delegate's store
            # holds (BitSet / Bloom / ...) cannot double as a bank HLL.
            raise WrongTypeError(
                f"key '{name}' holds {self.store.get(name).otype}, "
                "operation needs hll")
        if name in self._bits:
            raise WrongTypeError(
                f"key '{name}' holds {self._bits[name].otype}, "
                "operation needs hll")
        return self._alloc.row_of(name)

    def _grow_hook(self, new_capacity: int) -> int:
        """RowAllocator grow hook: double the bank, rounded to a multiple
        of the mesh size (elastic capacity)."""
        ndev = self.mesh.size
        if new_capacity % ndev:
            new_capacity += ndev - new_capacity % ndev
        self.bank = sharded.grow_bank(self.bank, new_capacity, self.mesh)
        self._account_bank()
        return new_capacity

    def reshard(self, num_shards: int) -> None:
        """Move the bank and every sharded bit array onto a mesh of
        `num_shards` entries (the topology-change path: master failover or
        shard add / remove in the reference)."""
        new_mesh = get_mesh(num_shards, device=self._device_spec)
        cap = self.bank_capacity
        ndev = new_mesh.size
        if cap % ndev:
            cap += ndev - cap % ndev
        bank = self.bank
        if cap != self.bank_capacity:
            # Pad rows for the NEW mesh: the rounded capacity need not
            # divide the old entry count.
            bank = sharded.grow_bank(bank, cap, new_mesh)
        self.bank = sharded.migrate_bank(bank, new_mesh)
        for obj in self._bits.values():
            obj.state = sharded_bits.migrate_bits(obj.state, new_mesh)
        self.mesh = new_mesh
        self.bank_capacity = cap
        self._account_bank()

    def on_device_loss(self, survivor_shards: int) -> None:
        """Failure-driven reshard: carry ALL sharded state (HLL bank and bit
        arrays) onto the survivor mesh and keep serving. Recovery when
        capacity returns is another reshard() back up. Callers run this on
        the dispatcher or quiesced, as reshard()."""
        self.reshard(survivor_shards)

    def run(self, kind: str, target: str, ops: List[Op]) -> None:
        device_mod.bind_thread(self.device)
        handler = getattr(self, "_op_" + kind, None)
        if handler is not None:
            # Fault seam of the mesh-sharded dispatch (bank insert / merge,
            # sharded bits); kinds the delegate serves keep its own seams.
            fault_inject.fire("mesh_collective", kind=kind, target=target)
            handler(target, ops)
            return
        self._delegate.run(kind, target, ops)

    def notify_restored(self, name: str) -> None:
        """Checkpoint / rebuild restore hook, forwarded to the delegate
        (its Bloom mirrors and read cache)."""
        self._delegate.notify_restored(name)

    def handles(self, kind: str) -> bool:
        return hasattr(self, "_op_" + kind) or self._delegate.handles(kind)

    def names(self, pattern: str = "*") -> List[str]:
        """Bank-resident names, sharded bit objects and the delegate
        store's names (RKeys)."""
        import fnmatch

        out = dict.fromkeys(self.store.keys(pattern))
        for n in list(self._rows) + list(self._bits):
            if pattern in (None, "*") or fnmatch.fnmatchcase(n, pattern):
                out[n] = None
        return list(out)

    # -- lifecycle ops see bank-resident HLLs and sharded bits too -----------

    def _op_delete(self, target: str, ops: List[Op]) -> None:
        row = self._alloc.release(target)
        if row is not None:
            self.bank = sharded.zero_row(self.bank, row)
            for op in ops:
                op.future.set_result(True)
            return
        if self._bits.pop(target, None) is not None:
            for op in ops:
                op.future.set_result(True)
            return
        self._delegate.run("delete", target, ops)

    def _op_exists(self, target: str, ops: List[Op]) -> None:
        if target in self._rows or target in self._bits:
            for op in ops:
                op.future.set_result(True)
            return
        self._delegate.run("exists", target, ops)

    def _op_rename(self, target: str, ops: List[Op]) -> None:
        """RENAME / RENAMENX over bank rows, sharded bits and the delegate
        store (the delegate's own handler would zero ITS bank)."""
        delegate = self._delegate
        for op in ops:
            new = op.payload["newkey"]
            # A missing source errors regardless of NX and leaves the
            # destination untouched.
            if (target not in self._rows and target not in self._bits
                    and not self.store.exists(target)):
                op.future.set_exception(KeyError(f"no such key '{target}'"))
                continue
            if op.payload.get("nx") and (
                    new in self._rows or new in self._bits
                    or self.store.exists(new)):
                op.future.set_result(False)
                continue
            row = self._alloc.release(new)
            if row is not None:
                self.bank = sharded.zero_row(self.bank, row)
            self._bits.pop(new, None)
            self.store.delete(new)
            delegate._bloom_mirrors.pop(new, None)
            if target in self._rows:
                self._alloc.rows[new] = self._alloc.rows.pop(target)
                self._alloc.versions[new] = (
                    self._alloc.versions.pop(target, 0) + 1)
            elif target in self._bits:
                obj = self._bits.pop(target)
                obj.name = new
                obj.version += 1
                self._bits[new] = obj
            else:
                self.store.rename(target, new)
                mir = delegate._bloom_mirrors.pop(target, None)
                if mir is not None:
                    delegate._bloom_mirrors[new] = mir
            for name in (target, new):
                delegate.notify_restored(name)
            op.future.set_result(True)

    def _op_flushall(self, target: str, ops: List[Op]) -> None:
        self._alloc.clear()
        self.bank = sharded.make_bank(self.mesh, self.bank_capacity)
        self._bits.clear()
        self._delegate._bloom_mirrors.clear()
        self._delegate.read_cache.clear()
        self.store.flushall()
        self._account_bank()
        for op in ops:
            op.future.set_result(None)

    # -- HLL over the bank --------------------------------------------------

    def _op_hll_add(self, target: str, ops: List[Op]) -> None:
        # Two insert groups: raw u64 keys (hashed on the device) and byte
        # keys (hashed on the device, entering the bank pre-hashed). A
        # WRONGTYPE target fails only its own ops.
        live, raw, raw_rows, byte_ops = [], [], [], []
        for op in ops:
            try:
                row = self.row_of(op.target)
            except WrongTypeError as exc:
                op.future.set_exception(exc)
                continue
            live.append(op)
            p = op.payload
            if "packed" in p:
                keys = _as_i64(p["packed"])
            elif "hi" in p:
                keys = ((np.asarray(p["hi"], np.uint64) << np.uint64(32))
                        | np.asarray(p["lo"], np.uint64)).view(np.int64)
            elif "device_packed" in p:
                keys = p["device_packed"]
                keys = (keys.cpu().numpy() if isinstance(keys, torch.Tensor)
                        else _as_i64(np.asarray(keys)))
            else:
                byte_ops.append(op)
                continue
            raw.append(keys)
            raw_rows.append(np.full((keys.shape[0],), row, np.int32))
        chunks = []
        if raw:
            keys = np.concatenate(raw)
            rows = np.concatenate(raw_rows)
            chunks += [(False, keys[s:e], rows[s:e])
                       for s, e in engine.chunk_spans(keys.shape[0])]
        if byte_ops:
            data, lengths, spans = self._delegate._coalesce_bytes(byte_ops)
            rows = np.zeros((data.shape[0],), np.int32)
            for op, (s, e) in zip(byte_ops, spans):
                rows[s:e] = self._rows[op.target]
            chunks += [(True, (data[s:e], lengths[s:e]), rows[s:e])
                       for s, e in engine.chunk_spans(data.shape[0])]

        def stage(chunk):
            hashed, keys, rows = chunk
            prow, valid = engine.pad_ints(rows)
            if hashed:
                pdata, plengths, _ = engine.pad_bytes(*keys)
                return hashed, (pdata, plengths), prow, valid
            pkeys, _ = engine.pad_ints(keys)
            return hashed, pkeys, prow, valid

        def dispatch(_i, staged):
            hashed, keys, prow, valid = staged
            put = self._delegate._to_device
            if hashed:
                h1 = hashing.murmur3_x64_128(put(keys[0]), put(keys[1]),
                                             self.seed)[0]
            else:
                h1 = hashing.murmur3_x64_128_u64(put(keys), self.seed)[0]
            self.bank, changed = sharded.bank_insert_h1(
                self.bank, h1, put(prow), put(valid), self.mesh)
            return changed

        # Dispatches stay serial (the bank carries state); the chunks'
        # per-block flags meet on home once, and resolve on the completer,
        # each op reading its own row.
        parts = self._pipeline.run(chunks, stage, dispatch)
        for op in live:
            self._alloc.bump(op.target)
        complete_changed_rows(self.completer, live,
                              [self._rows[op.target] for op in live],
                              [sharded.changed_on_home(parts)] if parts else [])

    def _submit_estimate(self, ops: List[Op], est) -> None:
        rb = Readback(est)
        self.completer.submit(_complete_all(
            ops, lambda: int(round(float(rb.wait())))))

    def _op_hll_count(self, target: str, ops: List[Op]) -> None:
        row = self._rows.get(target)
        if row is None:
            for op in ops:
                op.future.set_result(0)
            return
        self._submit_estimate(ops, sharded.bank_count_row(self.bank, row))

    def _op_hll_count_with(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            names = [target, *op.payload["names"]]
            rows = [self._rows[n] for n in names if n in self._rows]
            if not rows:
                op.future.set_result(0)
                continue
            self._submit_estimate([op], sharded.bank_count_rows_merged(
                self.bank, np.array(rows, np.int32), self.mesh))

    def _merge_rows(self, target: str, names) -> tuple:
        """(target_row, source rows incl. target) for the PFMERGE pair."""
        trow = self.row_of(target)
        rows = [trow] + [self._rows[n] for n in names if n in self._rows]
        return trow, np.array(rows, np.int32)

    def _op_hll_merge_with(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            self.bank = sharded.bank_merge_rows(self.bank, rows, trow)
            self._alloc.bump(target)
            op.future.set_result(None)

    def _op_hll_merge_count(self, target: str, ops: List[Op]) -> None:
        """Fused PFMERGE + PFCOUNT (one readback)."""
        for op in ops:
            trow, rows = self._merge_rows(target, op.payload["names"])
            self.bank, est = sharded.bank_merge_count_rows(self.bank, rows, trow)
            self._alloc.bump(target)
            self._submit_estimate([op], est)

    def _op_hll_count_all(self, target: str, ops: List[Op]) -> None:
        """Union count of the entire bank: per-shard folds, one combine."""
        self._submit_estimate(ops, sharded.bank_count_all(self.bank, self.mesh))

    # -- sharded BitSet -----------------------------------------------------

    def _bits_check(self, name: str, otype: str) -> None:
        """Cross-type keyspace guard (the single-device rule plus the bit
        tier's own types)."""
        if name in self._rows:
            raise WrongTypeError(
                f"key '{name}' holds hll, operation needs {otype}")
        cur = self._bits.get(name)
        if cur is not None and cur.otype != otype:
            raise WrongTypeError(
                f"key '{name}' holds {cur.otype}, operation needs {otype}")
        sobj = self.store.get(name)
        if sobj is not None:
            raise WrongTypeError(
                f"key '{name}' holds {sobj.otype}, operation needs {otype}")

    def _bitset_obj(self, name: str, nbits: int = None) -> _PodBits:
        self._bits_check(name, ObjectType.BITSET)
        obj = self._bits.get(name)
        if obj is None:
            if nbits is None:
                raise KeyError(f"bitset '{name}' does not exist")
            obj = _PodBits(name, ObjectType.BITSET,
                           sharded_bits.make_bits(self.mesh, nbits),
                           {"nbits": nbits})
            self._bits[name] = obj
        return obj

    @staticmethod
    def _extend(obj: _PodBits, max_index: int) -> None:
        """Written extent in Redis byte granularity (size() / NOT follow
        STRLEN semantics)."""
        ext = ((int(max_index) // 8) + 1) * 8
        if ext > obj.meta.get("extent_bits", 0):
            obj.meta["extent_bits"] = ext

    def _bits_grow(self, obj: _PodBits, max_index: int) -> None:
        """SETBIT auto-grow: power-of-two logical sizes; the physical length
        pads to the shard grain."""
        if max_index < obj.logical_n:
            return
        new_bits = max(1024, 1 << (int(max_index).bit_length()))
        obj.meta["nbits"] = new_bits
        obj.state = sharded_bits.grow_bits(obj.state, new_bits, self.mesh)

    def _bitset_mutate(self, target: str, ops: List[Op], set_value: bool) -> None:
        idx = np.concatenate([op.payload["idx"] for op in ops]).astype(np.int64)
        obj = self._bitset_obj(target, nbits=1024)
        self._bits_grow(obj, int(idx.max()) if idx.size else 0)
        if idx.size:
            self._extend(obj, int(idx.max()))
        kernel = sharded_bits.set_bits if set_value else sharded_bits.clear_bits
        put = self._delegate._to_device
        outs, spans = [], []
        for s, e in engine.chunk_spans(idx.shape[0]):
            pidx, valid = engine.pad_ints(idx[s:e])
            obj.state, old = kernel(obj.state, put(pidx), put(valid), self.mesh)
            outs.append(old)
            spans.append(e - s)
        obj.version += 1
        self.completer.submit(self._delegate._slice_results(ops, outs, spans))

    def _op_bitset_set(self, target: str, ops: List[Op]) -> None:
        self._bitset_mutate(target, ops, True)

    def _op_bitset_clear(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BITSET)
        if target not in self._bits:
            for op in ops:
                op.future.set_result(np.zeros((op.payload["idx"].shape[0],), bool))
            return
        self._bitset_mutate(target, ops, False)

    def _op_bitset_get(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BITSET)
        obj = self._bits.get(target)
        if obj is None:
            for op in ops:
                op.future.set_result(np.zeros((op.payload["idx"].shape[0],), bool))
            return
        idx = np.concatenate([op.payload["idx"] for op in ops]).astype(np.int64)
        nbits = obj.logical_n
        clipped = np.clip(idx, 0, nbits - 1)
        put = self._delegate._to_device
        outs, spans = [], []
        for s, e in engine.chunk_spans(clipped.shape[0]):
            pidx, valid = engine.pad_ints(clipped[s:e])
            outs.append(sharded_bits.get_bits(obj.state, put(pidx), put(valid),
                                              self.mesh))
            spans.append(e - s)
        self.completer.submit(self._delegate._slice_results(
            ops, outs, spans, post=lambda flat: np.where(idx < nbits, flat, 0)))

    def _op_bitset_cardinality(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BITSET)
        obj = self._bits.get(target)
        if obj is None:
            for op in ops:
                op.future.set_result(0)
            return
        # int32 partials per shard; the 64-bit exact combine runs on the
        # host at completion (past 2^31 set bits an int32 sum wraps).
        rbs = [Readback(p) for p in
               sharded_bits.cardinality_partials(obj.state, self.mesh)]
        self.completer.submit(_complete_all(
            ops, lambda: sharded_bits.combine_partials([rb.wait() for rb in rbs])))

    def _op_bitset_length(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BITSET)
        obj = self._bits.get(target)
        value = 0 if obj is None else sharded_bits.length(obj.state, self.mesh)
        for op in ops:
            op.future.set_result(value)

    def _op_bitset_size(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BITSET)
        obj = self._bits.get(target)
        val = 0 if obj is None else obj.meta.get("extent_bits", 0)
        for op in ops:
            op.future.set_result(val)

    def _op_bitset_set_range(self, target: str, ops: List[Op]) -> None:
        for op in ops:
            start, end = op.payload["start"], op.payload["end"]
            value = op.payload["value"]
            obj = self._bitset_obj(target, nbits=1024)
            if end <= start:  # empty range: a no-op
                op.future.set_result(None)
                continue
            self._bits_grow(obj, end - 1)
            if value:
                self._extend(obj, end - 1)
            obj.state = sharded_bits.set_range(obj.state, start, end - 1,
                                               bool(value), self.mesh)
            obj.version += 1
            op.future.set_result(None)

    def _op_bitset_op(self, target: str, ops: List[Op]) -> None:
        """BITOP AND / OR / XOR / NOT: co-sharded operands make this local
        to each shard."""
        for op in ops:
            kind = op.payload["op"]
            if kind == "not":
                obj = self._bits.get(target)
                self._bits_check(target, ObjectType.BITSET)
                if obj is not None:
                    ext = obj.meta.get("extent_bits", 0)
                    if ext:  # NOT of a never-written string is a no-op
                        obj.state = sharded_bits.bitop_not(obj.state, ext - 1,
                                                           self.mesh)
                        obj.version += 1
                op.future.set_result(None)
                continue
            sources = []
            for n in op.payload["names"]:
                self._bits_check(n, ObjectType.BITSET)
                src = self._bits.get(n)
                if src is not None:
                    sources.append(src)
            obj = self._bitset_obj(target, nbits=1024)
            width = max([obj.logical_n] + [s.logical_n for s in sources])
            self._bits_grow(obj, width - 1)
            if sources:
                n = len(obj.state)
                obj.state = sharded_bits.bitop(
                    [obj.state] + [sharded_bits.grow_bits(s.state, n, self.mesh)
                                   for s in sources], kind, self.mesh)
            obj.meta["nbits"] = width
            obj.meta["extent_bits"] = max(
                [obj.meta.get("extent_bits", 0)]
                + [s.meta.get("extent_bits", 0) for s in sources])
            obj.version += 1
            op.future.set_result(None)

    # -- sharded Bloom -------------------------------------------------------

    def _bloom_obj(self, target: str) -> tuple:
        self._bits_check(target, ObjectType.BLOOM)
        obj = self._bits.get(target)
        if obj is None:
            raise RuntimeError(f"bloom filter '{target}' is not initialized")
        return obj, obj.meta["size"], obj.meta["hash_iterations"]

    def _op_bloom_init(self, target: str, ops: List[Op]) -> None:
        self._bits_check(target, ObjectType.BLOOM)
        for op in ops:
            n = op.payload["expected_insertions"]
            p = op.payload["false_probability"]
            blocked = bool(op.payload.get("blocked"))
            m = bloom_ops.optimal_num_of_bits(n, p)
            k = bloom_ops.optimal_num_of_hash_functions(n, m)
            if blocked:
                m = bloom_ops.blocked_geometry(m)
            bloom_ops.check_size(m)
            if target in self._bits:
                op.future.set_result(False)
                continue
            self._bits[target] = _PodBits(
                target, ObjectType.BLOOM,
                sharded_bits.make_bits(self.mesh, m),
                {"size": m, "hash_iterations": k, "expected_insertions": n,
                 "false_probability": p, "blocked": blocked})
            op.future.set_result(True)

    @staticmethod
    def _bloom_layout(obj: _PodBits) -> str:
        return "blocked" if obj.meta.get("blocked") else "classic"

    def _bloom_run(self, target: str, ops: List[Op], mutate: bool) -> None:
        """Sharded Bloom dispatch in op order (results slice by position);
        no host mirror in pod mode: the filter's home is the mesh."""
        obj, m, k = self._bloom_obj(target)
        layout = self._bloom_layout(obj)
        put = self._delegate._to_device
        outs, spans = [], []

        def emit(res, n):
            if mutate:
                obj.state, res = res
            outs.append(res)
            spans.append(n)

        for fmt, group in _format_runs(ops):
            if fmt == "packed":
                fn = (sharded_bits.bloom_add_packed if mutate
                      else sharded_bits.bloom_contains_packed)
                for keys in _segments([_as_i64(op.payload["packed"])
                                       for op in group], engine.MIN_BUCKET):
                    for s, e in engine.chunk_spans(keys.shape[0]):
                        pkeys, count = engine.pad_rows(keys[s:e])
                        emit(fn(obj.state, put(pkeys), count, k, m, self.seed,
                                self.mesh, layout), e - s)
            else:
                fn = (sharded_bits.bloom_add_bytes if mutate
                      else sharded_bits.bloom_contains_bytes)
                data, lengths, _ = self._delegate._coalesce_bytes(group)
                for s, e in engine.chunk_spans(data.shape[0]):
                    pdata, plengths, valid = engine.pad_bytes(
                        data[s:e], lengths[s:e])
                    emit(fn(obj.state, put(pdata), put(plengths), put(valid),
                            k, m, self.seed, self.mesh, layout), e - s)
        if mutate:
            obj.version += 1
        self.completer.submit(self._delegate._slice_results(ops, outs, spans))

    def _op_bloom_add(self, target: str, ops: List[Op]) -> None:
        self._bloom_run(target, ops, mutate=True)

    def _op_bloom_contains(self, target: str, ops: List[Op]) -> None:
        self._bloom_run(target, ops, mutate=False)

    def _op_bloom_contains_count(self, target: str, ops: List[Op]) -> None:
        obj, m, k = self._bloom_obj(target)
        layout = self._bloom_layout(obj)
        for op in ops:
            if "device_packed" in op.payload:
                keys = op.payload["device_packed"].to(self.device)
            else:
                keys = self._delegate._to_device(_as_i64(op.payload["packed"]))
            parts = [sharded_bits.bloom_contains_count_packed(
                obj.state, keys[s:e], e - s, k, m, self.seed, self.mesh, layout)
                for s, e in engine.chunk_spans(int(keys.shape[0]))]
            if not parts:
                op.future.set_result(0)
                continue
            total = Readback(torch.stack(parts).sum())
            self.completer.submit(_complete_all([op], lambda t=total: int(t.wait())))

    def _op_bloom_count(self, target: str, ops: List[Op]) -> None:
        obj, m, k = self._bloom_obj(target)
        bc = sharded_bits.cardinality(obj.state, self.mesh)
        # bc is a host int (the 64-bit combine): a pure-math estimate, the
        # formula the wire tier uses.
        est = int(round(bloom_math.count_estimate(bc, m, k)))
        for op in ops:
            op.future.set_result(est)

    def _op_bloom_meta(self, target: str, ops: List[Op]) -> None:
        obj, _, _ = self._bloom_obj(target)
        meta = dict(obj.meta)
        for op in ops:
            op.future.set_result(meta)

    def _op_bloom_sync(self, target: str, ops: List[Op]) -> None:
        # No host mirror in pod mode: the device state is always current.
        for op in ops:
            op.future.set_result(None)

    def _op_bits_export(self, target: str, ops: List[Op]) -> None:
        """(otype, host cells trimmed to the logical length, meta, version):
        the dispatcher-serialized checkpoint / durability read (portable to
        the single-device tier, whose arrays have no shard padding)."""
        obj = self._bits.get(target)
        if obj is None:
            self._delegate.run("bits_export", target, ops)
            return
        host = obj.state.to_numpy(obj.logical_n)
        for op in ops:
            op.future.set_result((obj.otype, host, dict(obj.meta), obj.version))

    def _install_bits(self, target: str, otype: str, cells, meta) -> None:
        """Create or overwrite a sharded bit object from host cells."""
        host = np.asarray(cells).astype(np.uint8)
        meta = dict(meta or {})
        self._bits_check(target, otype)
        phys = sharded_bits.physical_size(host.shape[0], self.mesh)
        padded = np.zeros((phys,), np.uint8)
        padded[: host.shape[0]] = host
        if otype == ObjectType.BITSET:
            meta.setdefault("nbits", host.shape[0])
            meta.setdefault("extent_bits", host.shape[0])
        obj = _PodBits(target, otype,
                       sharded_bits.bits_sharding(self.mesh).put(padded), meta)
        obj.version = 1
        self._bits[target] = obj

    def _op_bits_import(self, target: str, ops: List[Op]) -> None:
        """The checkpoint-restore path into a sharded bit object."""
        for op in ops:
            self._install_bits(target, op.payload["otype"], op.payload["array"],
                               op.payload.get("meta"))
            op.future.set_result(True)

    def sharded_bits_names(self) -> List[str]:
        return list(self._bits)

    def bits_version(self, name: str) -> int:
        """Mutation counter of a sharded bit object: the cheap dirty check
        durability consults before paying a full cell export."""
        obj = self._bits.get(name)
        return obj.version if obj is not None else -1

    # -- durability / checkpoint surface ------------------------------------
    # Export and import run as ops on the dispatcher, serialized with
    # inserts; the durability and checkpoint tiers call them through the
    # executor.

    def bank_names(self) -> List[str]:
        return list(self._rows)

    def row_version(self, name: str) -> int:
        return self._alloc.versions.get(name, 0)

    def _op_hll_export(self, target: str, ops: List[Op]) -> None:
        """(registers uint8[m], version) of a bank row; the delegate answers
        for names that are not bank rows."""
        row = self._rows.get(target)
        if row is None:
            self._delegate.run("hll_export", target, ops)
            return
        regs = self.bank.row(row).cpu().numpy().astype(np.uint8)
        version = self._row_versions.get(target, 0)
        for op in ops:
            op.future.set_result((regs, version))

    def _op_hll_import(self, target: str, ops: List[Op]) -> None:
        """Overwrite (or create) a bank row from host registers (the
        flush-restore / checkpoint-load path)."""
        for op in ops:
            regs = np.asarray(op.payload["regs"]).astype(np.int32)
            row = self.row_of(target)
            self.bank.row(row).copy_(torch.from_numpy(regs))
            self._alloc.bump(target)
            op.future.set_result(True)

    def snapshot_cut(self) -> dict:
        """A consistent copy of every sketch (persist snapshots): the
        delegate's store objects, the sharded bit objects and the bank,
        cloned on the dispatcher inside the barrier."""
        cut = self._delegate.snapshot_cut()
        for name, obj in self._bits.items():
            cut["objects"][name] = (obj.otype, obj.state.clone(obj.logical_n),
                                    dict(obj.meta), obj.version)
        cut["rows"] = {name: (row, self._row_versions.get(name, 0))
                       for name, row in self._rows.items()}
        cut["bank"] = self.bank.clone() if cut["rows"] else None
        return cut

    # -- state carry-over ---------------------------------------------------

    def from_jax_state(self, bank_np: np.ndarray, rows: dict,
                       objects=None) -> None:
        """Install a JAX PodBackend's state: its bank (numpy [S, m]), its
        name -> row map and, given `objects` (name -> what its `bits_export`
        returns), its sharded bit objects; store objects stay with the
        delegate. Run on the dispatcher (`execute_barrier`)."""
        bank_np = np.ascontiguousarray(bank_np, np.int32)
        cap = bank_np.shape[0]
        ndev = self.mesh.size
        if cap % ndev:
            bank_np = np.concatenate(
                [bank_np, np.zeros((ndev - cap % ndev, bank_np.shape[1]), np.int32)])
        self.bank = bank_sharding(self.mesh).put(bank_np)
        alloc = self._alloc
        alloc.clear()
        alloc.capacity = len(self.bank)
        alloc.rows.update({str(n): int(r) for n, r in rows.items()})
        alloc.next = max(alloc.rows.values(), default=-1) + 1
        used = set(alloc.rows.values())
        alloc.free = [r for r in range(alloc.next) if r not in used]
        for name in alloc.rows:
            alloc.bump(name)
        if objects is not None:
            self._bits.clear()
            for name, (otype, cells, meta, *_rest) in objects.items():
                self._install_bits(str(name), otype, cells, meta)
        self._account_bank()

    def to_numpy_state(self):
        """(bank as numpy [S, m] int32, name -> row map)."""
        return self.bank.to_numpy(), dict(self._rows)

    def to_numpy_objects(self) -> dict:
        """name -> (otype, cells trimmed to the logical length, meta) for
        every sharded bit object and every delegate store object."""
        out = self._delegate.to_numpy_objects()
        for name, obj in self._bits.items():
            out[name] = (obj.otype, obj.state.to_numpy(obj.logical_n),
                         dict(obj.meta))
        return out
