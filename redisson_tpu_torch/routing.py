"""RoutingBackend: the tier router behind the executor waist (counterpart of
`redisson_tpu.routing`).

Sketch kinds (HyperLogLog, BitSet, Bloom) go to the device backend;
everything else goes to the in-process structure engine
(`structures.StructureBackend`). Keyspace-wide ops (delete, exists,
flushall, keys, rename) fan out to both tiers and reduce, the analogue of
the reference's `readAllAsync` + SlotCallback.
"""

from __future__ import annotations

from typing import List, Optional

from redisson_tpu_torch.executor import Op
from redisson_tpu_torch.structures.engine import StructureBackend


class RoutingBackend:
    """kind-based router between the sketch tier and the structure tier."""

    # keyspace-wide kinds served across both tiers
    _BOTH = {"delete", "exists", "flushall", "keys", "rename"}

    def __init__(self, sketch_backend,
                 structures: Optional[StructureBackend] = None):
        self.sketch = sketch_backend
        self.structures = structures or StructureBackend()
        self.GLOBAL_COALESCE = frozenset(getattr(sketch_backend, "GLOBAL_COALESCE", ()))
        self.COALESCE_GROUPS = dict(getattr(sketch_backend, "COALESCE_GROUPS", {}))
        self.BLOOM_STRICT_MOD = bool(
            getattr(sketch_backend, "BLOOM_STRICT_MOD", False))
        # Both tiers commit all observable state inside run() (the structure
        # engine resolves synchronously; parked pops are PARKED_KINDS), so
        # the router is dispatch-time-state exactly when the sketch tier is.
        self.DISPATCH_TIME_STATE = bool(
            getattr(sketch_backend, "DISPATCH_TIME_STATE", False))
        # Window handoff: forward the executor's window sequence to a sketch
        # tier that attributes per-window launch cost to it.
        self.WINDOW_HANDOFF = bool(
            getattr(sketch_backend, "WINDOW_HANDOFF", False))
        self.pubsub = self.structures.pubsub

    def run(self, kind: str, target: str, ops: List[Op],
            window: Optional[int] = None) -> None:
        if kind in self._BOTH:
            getattr(self, "_both_" + kind)(target, ops)
            return
        if self.sketch.handles(kind):
            if window is not None and self.WINDOW_HANDOFF:
                self.sketch.run(kind, target, ops, window=window)
            else:
                self.sketch.run(kind, target, ops)
            return
        self.structures.run(kind, target, ops)

    # -- keyspace-wide fan-out ----------------------------------------------

    def _sketch_side(self, kind: str, target: str, payload=None):
        """Run the sketch backend's own handler (bank rows live outside the
        store) and return its result; run() completes the probe inline."""
        probe = Op(target=target, kind=kind, payload=payload)
        self.sketch.run(kind, target, [probe])
        return probe.future.result()

    def _both_delete(self, target: str, ops: List[Op]) -> None:
        res = bool(self._sketch_side("delete", target)) | self.structures.delete(target)
        for op in ops:
            op.future.set_result(res)

    def _both_exists(self, target: str, ops: List[Op]) -> None:
        res = bool(self._sketch_side("exists", target)) or self.structures.exists(target)
        for op in ops:
            op.future.set_result(res)

    def _both_flushall(self, target: str, ops: List[Op]) -> None:
        self._sketch_side("flushall", "")
        self.structures.flushall()
        for op in ops:
            op.future.set_result(None)

    def _both_rename(self, target: str, ops: List[Op]) -> None:
        """RENAME / RENAMENX routed to the tier holding the source; the
        destination is cleared in both tiers first (RENAME overwrites
        whatever held that name). Serialized on the dispatcher, so atomic."""
        for op in ops:
            new = op.payload["newkey"]
            in_sketch = bool(self._sketch_side("exists", target))
            in_struct = self.structures.exists(target)
            if not in_sketch and not in_struct:
                op.future.set_exception(KeyError(f"no such key '{target}'"))
                continue
            if op.payload.get("nx") and (
                    bool(self._sketch_side("exists", new))
                    or self.structures.exists(new)):
                op.future.set_result(False)
                continue
            try:
                if in_sketch:
                    self.structures.delete(new)
                    op.future.set_result(
                        self._sketch_side("rename", target, op.payload))
                else:
                    self._sketch_side("delete", new)
                    self.structures.run("rename", target, [op])
            except Exception as exc:  # noqa: BLE001 — resolve, never strand
                if not op.future.done():
                    op.future.set_exception(exc)

    def _both_keys(self, target: str, ops: List[Op]) -> None:
        """KEYS across both tiers, serialized on the dispatcher thread."""
        for op in ops:
            pattern = (op.payload or {}).get("pattern", "*")
            op.future.set_result(self.keys(pattern))

    def keys(self, pattern: str = "*") -> List[str]:
        seen = dict.fromkeys(self.sketch.names(pattern))
        for k in self.structures.keys(pattern):
            seen[k] = None
        return list(seen)
