"""ClusterRouter — key_slot(name) -> shard dispatch with MOVED/ASK retry
(counterpart of `redisson_tpu.cluster.router`, both data planes).

The router implements the executor's dispatch protocol (execute_async /
execute_sync / execute_many / batch), so model getters bind to it exactly
like they bind to a CommandExecutor or ServingLayer — the facade client in
cluster mode hands out the same RHyperLogLog/RBucket/... objects, they just
route per key. Reference shape:

  * keyed ops — `ClusterConnectionManager.getEntry(slot)`: resolve owner
    by CRC16 slot, submit to that shard's dispatch;
  * redirect retry — `CommandAsyncService` MOVED/ASK loop: a shard that no
    longer owns the slot fails the op with `SlotMovedError`; the router
    re-resolves and resubmits (bounded depth), and the caller's future only
    ever sees the final result — zero lost acks across a live migration;
  * ASK window — during a cutover the migrating slots park new submissions
    on an event (the `-ASK` beat) until the table flips; other slots are
    untouched, so writes never block cluster-wide;
  * batches — `CommandBatchService.java:163-174`: execute_many splits the
    staged list per owner with the shared splitter (cluster/split.py) and
    reassembles futures by global index;
  * keyspace-wide ops — `RedissonKeys.readAllAsync` + SlotCallback: KEYS /
    FLUSHALL / MGET / MSET / SCRIPT* fan out and reduce;
  * cross-shard PFMERGE — registers export host-side max-fold, import into
    the destination (the FPGA HLL accelerator's merge-at-the-end shape:
    shard-local state stays independent until merge time).
"""

from __future__ import annotations

import queue
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from redisson_tpu_torch.cluster.errors import (ClusterCrossSlotError,
                                               SlotAskError, SlotMovedError)
from redisson_tpu_torch.cluster.split import slot_ranges, split_by_owner
from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.ops.crc16 import MAX_SLOT, key_slot

# Multi-key ops whose co-keys ride in the payload: must co-locate with the
# target (the -CROSSSLOT rule; hashtags are the escape hatch). Field values
# may be a single key or a list of keys.
_COKEY_FIELDS = {
    "rename": ("newkey",),
    "rpoplpush": ("dst",),
    "smove": ("dst",),
    "sstore": ("names",),
    "zstore": ("names",),
}

# PFMERGE family: relaxed beyond redis — sources may live on any shard
# (registers merge host-side; see _hll_cross below).
_HLL_MULTI = frozenset({"hll_merge_with", "hll_merge_count", "hll_count_with"})


class _Pending:
    """One routed op: the caller's outer future + everything needed to
    resubmit it after a redirect."""

    __slots__ = ("target", "kind", "payload", "nkeys", "tenant", "deadline",
                 "outer", "attempts")

    def __init__(self, target, kind, payload, nkeys, tenant, deadline):
        self.target = target
        self.kind = kind
        self.payload = payload
        self.nkeys = nkeys
        self.tenant = tenant
        self.deadline = deadline
        self.outer: Future = Future()
        self.attempts = 0


def _copy_result(src: Future, dst: Future) -> None:
    if dst.done():  # pragma: no cover - defensive
        return
    exc = src.exception()
    if exc is not None:
        dst.set_exception(exc)
    else:
        dst.set_result(src.result())


class ClusterRouter:
    RETRY_DEPTH = 5
    ASK_WAIT_S = 60.0

    def __init__(self, shards: Dict[int, Any], table: Sequence[int],
                 retry_depth: int = RETRY_DEPTH, mesh: bool = False):
        if len(table) != MAX_SLOT:
            raise ValueError(f"slot table must cover {MAX_SLOT} slots")
        self._shards = dict(shards)
        for sid in set(table):
            if sid not in self._shards:
                raise ValueError(f"slot table references unknown shard {sid}")
        self._table = list(table)
        # Mesh data plane: every shard fronts ONE shared engine stack, so a
        # cross-shard PFMERGE submits as a single op (the backend folds it
        # with the mesh collective, no host register export) and
        # keyspace-wide ops dispatch once instead of N times.
        self._mesh = bool(mesh)
        self._lock = make_lock("router.ClusterRouter._lock")
        # (frozenset(slots), Event) while a cutover is in flight — the ASK
        # window. New submissions for those slots wait on the event; the
        # migrator sets it right after the table flip.
        self._ask: Optional[Tuple[frozenset, threading.Event]] = None
        self._retry_depth = retry_depth
        self.redirects = 0
        self.retries_exhausted = 0
        self.cross_shard_merges = 0
        # Redirect resubmission happens OFF the completing thread: the
        # rejecting future resolves on the source shard's dispatcher, and
        # resubmitting there could block on the ASK window — parking the
        # dispatcher. One worker drains redirects instead.
        self._retryq: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="redisson-torch-cluster-redirect",
            daemon=True)
        self._retry_thread.start()
        self._closed = False

    # -- topology ------------------------------------------------------------

    def shard_of_slot(self, slot: int):
        with self._lock:
            return self._shards[self._table[slot]]

    def shard_ids(self) -> List[int]:
        return sorted(self._shards)

    def slot_table(self) -> List[int]:
        with self._lock:
            return list(self._table)

    def ranges(self) -> List[Tuple[int, int, int]]:
        return slot_ranges(self.slot_table())

    def ask_slots(self) -> frozenset:
        """Slots parked in the cutover (ASK) window right now, or an empty
        set. The wire tier renders keyed commands on these slots as real
        ``-ASK`` redirects instead of parking the event loop on the flip."""
        with self._lock:
            ask = self._ask
        return ask[0] if ask is not None else frozenset()

    def add_shard(self, shard) -> None:
        with self._lock:
            self._shards[shard.shard_id] = shard

    def remove_shard(self, shard_id: int) -> None:
        with self._lock:
            if shard_id in set(self._table):
                raise ValueError(
                    f"shard {shard_id} still owns slots; migrate them first")
            self._shards.pop(shard_id, None)

    # -- cutover (the ASK window) -------------------------------------------

    def begin_cutover(self, slots) -> None:
        with self._lock:
            if self._ask is not None:
                raise RuntimeError("a cutover is already in flight")
            self._ask = (frozenset(int(s) for s in slots), threading.Event())

    def commit_cutover(self, slots, new_owner: int) -> None:
        with self._lock:
            for s in slots:
                self._table[int(s)] = int(new_owner)
            ask = self._ask
            self._ask = None
        if ask is not None:
            ask[1].set()

    def abort_cutover(self) -> None:
        with self._lock:
            ask = self._ask
            self._ask = None
        if ask is not None:
            ask[1].set()

    def _resolve(self, target: str):
        """Owner shard for a key; parks on the ASK window when the key's
        slot is mid-cutover (bounded — a wedged migration must not hang
        callers forever)."""
        slot = key_slot(target)
        while True:
            with self._lock:
                ask = self._ask
                if ask is None or slot not in ask[0]:
                    return self._shards[self._table[slot]]
            ask[1].wait(self.ASK_WAIT_S)
            with self._lock:
                if self._ask is ask:  # timed out, window still open
                    raise SlotAskError(slot, target)

    # -- dispatch protocol ---------------------------------------------------

    def execute_async(self, target: str, kind: str, payload: Any,
                      nkeys: int = 0, tenant: str = "",
                      deadline: Optional[float] = None) -> Future:
        if not target:
            return self._unkeyed_async(kind, payload, nkeys, tenant, deadline)
        if kind in _HLL_MULTI:
            return self._hll_multi_async(target, kind, payload, nkeys,
                                         tenant, deadline)
        pending = _Pending(target, kind, payload, nkeys, tenant, deadline)
        cross = self._crossslot_check(target, kind, payload)
        if cross is not None:
            pending.outer.set_exception(cross)
            return pending.outer
        self._submit(pending)
        return pending.outer

    def execute_sync(self, target: str, kind: str, payload: Any,
                     nkeys: int = 0, **kw):
        return self.execute_async(target, kind, payload, nkeys, **kw).result()

    def execute_many(self, staged: Sequence[Tuple[str, str, Any, int]],
                     tenant: str = "",
                     deadline: Optional[float] = None) -> List[Future]:
        """The CommandBatchService split: group staged ops per owner shard
        (shared splitter), submit one execute_many per shard, reassemble
        outer futures by global index. Unkeyed / PFMERGE entries route
        through the single-op path (they fan out internally)."""
        outers: List[Optional[Future]] = [None] * len(staged)
        keyed: List[int] = []
        for i, (t, k, p, n) in enumerate(staged):
            if not t or k in _HLL_MULTI:
                outers[i] = self.execute_async(t, k, p, n, tenant=tenant,
                                               deadline=deadline)
            else:
                keyed.append(i)

        groups = split_by_owner(
            keyed, lambda _j, i: self._resolve(staged[i][0]).shard_id)
        for sid, positions in groups.items():
            idxs = [keyed[j] for j in positions]
            sub = [staged[i] for i in idxs]
            inner = self._shards[sid].dispatch.execute_many(
                sub, tenant=tenant, deadline=deadline)
            for i, fut in zip(idxs, inner):
                t, k, p, n = staged[i]
                pending = _Pending(t, k, p, n, tenant, deadline)
                cross = self._crossslot_check(t, k, p)
                if cross is not None:
                    pending.outer.set_exception(cross)
                else:
                    fut.add_done_callback(self._redirect_cb(pending))
                outers[i] = pending.outer
        return outers  # type: ignore[return-value]

    def batch(self, **submit_kwargs):
        from redisson_tpu_torch.executor import BatchCollector

        return BatchCollector(self, **submit_kwargs)

    def queue_depth(self) -> int:
        # Mesh plane: every shard resolves to the SAME executor; count it
        # once.
        seen, total = set(), 0
        for s in self._shards.values():
            ex = s.executor
            if id(ex) not in seen:
                seen.add(id(ex))
                total += ex.queue_depth()
        return total

    # -- keyed submission + redirect retry -----------------------------------

    def _submit(self, pending: _Pending) -> None:
        try:
            shard = self._resolve(pending.target)
        except Exception as exc:
            if not pending.outer.done():
                pending.outer.set_exception(exc)
            return
        fut = shard.dispatch.execute_async(
            pending.target, pending.kind, pending.payload, pending.nkeys,
            tenant=pending.tenant, deadline=pending.deadline)
        fut.add_done_callback(self._redirect_cb(pending))

    def _redirect_cb(self, pending: _Pending):
        def done(fut: Future) -> None:
            exc = fut.exception()
            if (isinstance(exc, SlotMovedError) and not self._closed
                    and pending.attempts < self._retry_depth):
                pending.attempts += 1
                # Completer-thread callback racing caller threads: the
                # redirect counters share the router lock.
                with self._lock:
                    self.redirects += 1
                self._retryq.put(pending)
                return
            if isinstance(exc, SlotMovedError):
                with self._lock:
                    self.retries_exhausted += 1
            _copy_result(fut, pending.outer)

        return done

    def _retry_loop(self) -> None:
        while True:
            pending = self._retryq.get()
            if pending is None:
                return
            self._submit(pending)

    def _crossslot_check(self, target, kind, payload):
        fields = _COKEY_FIELDS.get(kind)
        if fields is None or not isinstance(payload, dict):
            return None
        home = self._resolve(target).shard_id
        for f in fields:
            v = payload.get(f)
            names = v if isinstance(v, (list, tuple)) else [v]
            for name in names:
                if isinstance(name, str) and name:
                    if self._resolve(name).shard_id != home:
                        return ClusterCrossSlotError(
                            f"{kind}: '{name}' is not on the same shard as "
                            f"'{target}' (use {{hashtags}} to co-locate)")
        return None

    # -- keyspace-wide fan-out (SlotCallback reduction) ----------------------

    def _unkeyed_async(self, kind, payload, nkeys, tenant, deadline) -> Future:
        shards = list(self._shards.values())
        if self._mesh and shards:
            # One shared store holds the whole keyspace: dispatch ONCE
            # (fanning out would run the same op N times on one engine).
            shard = min(shards, key=lambda s: s.shard_id)
            if kind in ("keys", "flushall", "script_flush", "script_load",
                        "script_exists", "mget", "mset", "msetnx"):
                if kind == "keys":
                    reduce_fn = lambda rs: sorted(set(rs[0] or []))  # noqa: E731
                elif kind in ("flushall", "script_flush", "mset"):
                    reduce_fn = lambda rs: None  # noqa: E731
                else:
                    reduce_fn = lambda rs: rs[0]  # noqa: E731
                return self._fanout([(shard, "", kind, payload, nkeys)],
                                    reduce_fn, tenant, deadline)
        if kind == "keys":
            return self._fanout(
                [(s, "", kind, payload, 0) for s in shards],
                lambda rs: sorted(set(k for r in rs if r for k in r)),
                tenant, deadline)
        if kind == "flushall" or kind == "script_flush":
            return self._fanout(
                [(s, "", kind, payload, 0) for s in shards],
                lambda rs: None, tenant, deadline)
        if kind == "script_load":
            # script_sha is content-derived: every shard registers the same
            # sha, any result stands for all.
            return self._fanout(
                [(s, "", kind, payload, 0) for s in shards],
                lambda rs: rs[0] if rs else None, tenant, deadline)
        if kind == "script_exists":
            return self._fanout(
                [(s, "", kind, payload, 0) for s in shards],
                lambda rs: [all(flags) for flags in zip(*rs)] if rs else [],
                tenant, deadline)
        if kind == "mget":
            names = list(payload["names"])
            groups = split_by_owner(
                names, lambda _i, n: self._resolve(n).shard_id)
            calls = [(self._shards[sid], "", "mget",
                      {"names": [names[i] for i in idxs]}, nkeys)
                     for sid, idxs in groups.items()]

            def merge(rs):
                out: Dict[str, Any] = {}
                for r in rs:
                    if r:
                        out.update(r)
                return out

            return self._fanout(calls, merge, tenant, deadline)
        if kind in ("mset", "msetnx"):
            pairs = dict(payload["pairs"])
            groups = split_by_owner(
                list(pairs), lambda _i, n: self._resolve(n).shard_id)
            if kind == "msetnx" and len(groups) > 1:
                fut: Future = Future()
                fut.set_exception(ClusterCrossSlotError(
                    "MSETNX is all-or-nothing and cannot span shards "
                    "(redis cluster rejects it the same way); use "
                    "{hashtags} to co-locate the keys"))
                return fut
            keys = list(pairs)
            calls = [(self._shards[sid], "", kind,
                      {"pairs": {keys[i]: pairs[keys[i]] for i in idxs}},
                      nkeys)
                     for sid, idxs in groups.items()]
            reduce = (lambda rs: all(rs)) if kind == "msetnx" else (
                lambda rs: None)
            return self._fanout(calls, reduce, tenant, deadline)
        fut = Future()
        fut.set_exception(ValueError(
            f"unkeyed op '{kind}' is not cluster-routable"))
        return fut

    def _fanout(self, calls, reduce_fn, tenant, deadline) -> Future:
        """Submit to every listed shard; reduce once ALL resolve (counting
        callback — never blocks a dispatcher thread)."""
        outer: Future = Future()
        if not calls:
            outer.set_result(reduce_fn([]))
            return outer
        results: List[Any] = [None] * len(calls)
        state = {"pending": len(calls), "exc": None}
        lock = threading.Lock()

        def finish():
            if state["exc"] is not None:
                outer.set_exception(state["exc"])
            else:
                try:
                    outer.set_result(reduce_fn(results))
                except Exception as exc:  # pragma: no cover - defensive
                    outer.set_exception(exc)

        for i, (shard, t, k, p, n) in enumerate(calls):
            fut = shard.dispatch.execute_async(t, k, p, n, tenant=tenant,
                                               deadline=deadline)

            def done(f: Future, i=i) -> None:
                last = False
                with lock:
                    exc = f.exception()
                    if exc is not None and state["exc"] is None:
                        state["exc"] = exc
                    elif exc is None:
                        results[i] = f.result()
                    state["pending"] -= 1
                    last = state["pending"] == 0
                if last:
                    finish()

            fut.add_done_callback(done)
        return outer

    # -- cross-shard PFMERGE (host register max-fold) ------------------------

    def _hll_multi_async(self, target, kind, payload, nkeys,
                         tenant, deadline) -> Future:
        names = list(payload.get("names") or [])
        home = self._resolve(target)
        if self._mesh or all(self._resolve(n) is home for n in names):
            # One shard holds every sketch (or the mesh plane's shared bank
            # holds them all): one op, merged on the device (merge_stack
            # over the listed bank rows; the mesh collective on the mesh
            # plane, tagged with the target's owner).
            if self._mesh and any(self._resolve(n) is not home
                                  for n in names):
                with self._lock:
                    self.cross_shard_merges += 1
            pending = _Pending(target, kind, payload, nkeys, tenant, deadline)
            self._submit(pending)
            return pending.outer
        # Cross-shard: PFMERGE semantics via register export + host-side
        # elementwise max + import. Runs on the caller's thread (the sync
        # facade path models use); the returned future is pre-resolved.
        fut: Future = Future()
        try:
            fut.set_result(self._hll_cross(target, kind, names))
        except Exception as exc:
            fut.set_exception(exc)
        return fut

    def _routed_sync(self, target, kind, payload, nkeys=0):
        """execute_sync with the MOVED retry loop inlined (helper paths
        that run on the caller's thread, not through _Pending)."""
        last: Optional[Exception] = None
        for _ in range(self._retry_depth + 1):
            shard = self._resolve(target)
            try:
                return shard.dispatch.execute_sync(target, kind, payload,
                                                   nkeys)
            except SlotMovedError as exc:
                # Caller-thread retry path racing the redirect worker's
                # counter bumps: share the router lock.
                with self._lock:
                    self.redirects += 1
                last = exc
        raise last  # type: ignore[misc]

    def _hll_cross(self, target, kind, names):
        self.cross_shard_merges += 1
        regs: List[np.ndarray] = []
        for n in [target, *names]:
            exported = self._routed_sync(n, "hll_export", None)
            if exported is not None:
                regs.append(np.asarray(exported[0], dtype=np.uint8))
        if not regs:
            # No participating sketch exists anywhere: nothing to merge.
            return 0 if kind != "hll_merge_with" else None
        merged = np.maximum.reduce(regs)
        if kind == "hll_count_with":
            # Non-mutating union count: estimate via a routed scratch key
            # (lands on whichever shard owns its slot — no co-location
            # games), deleted right after.
            tmp = f"__cluster_tmp__{uuid.uuid4().hex}"
            self._routed_sync(tmp, "hll_import", {"regs": merged})
            try:
                return self._routed_sync(tmp, "hll_count", None)
            finally:
                self._routed_sync(tmp, "delete", None)
        self._routed_sync(target, "hll_import", {"regs": merged})
        if kind == "hll_merge_count":
            return self._routed_sync(target, "hll_count", None)
        return None

    # -- RKeys compatibility --------------------------------------------------

    def keys(self, pattern: str = "*") -> List[str]:
        return self.execute_sync("", "keys", {"pattern": pattern})

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        self.abort_cutover()
        self._retryq.put(None)
        self._retry_thread.join(timeout=10.0)
