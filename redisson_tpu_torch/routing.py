"""RoutingBackend: the tier router behind the executor waist (counterpart of
`redisson_tpu.routing`, sketch tier only).

Sketch kinds (HyperLogLog, BitSet, Bloom and the keyspace ops) go to the
device backend. The JAX package sends every other kind (buckets, maps,
locks, queues, ...) to its in-process structure engine; that tier is not
ported yet, so such kinds fail with NotImplementedError instead of running
somewhere else.
"""

from __future__ import annotations

from typing import List

from redisson_tpu_torch.executor import Op


class RoutingBackend:
    """kind-based router; only the sketch tier exists in this slice."""

    def __init__(self, sketch_backend):
        self.sketch = sketch_backend
        self.GLOBAL_COALESCE = frozenset(getattr(sketch_backend, "GLOBAL_COALESCE", ()))
        self.DISPATCH_TIME_STATE = bool(
            getattr(sketch_backend, "DISPATCH_TIME_STATE", False))
        self.BLOOM_STRICT_MOD = bool(
            getattr(sketch_backend, "BLOOM_STRICT_MOD", False))

    def run(self, kind: str, target: str, ops: List[Op]) -> None:
        if self.sketch.handles(kind):
            self.sketch.run(kind, target, ops)
            return
        exc = NotImplementedError(
            f"op kind {kind!r} belongs to the structures tier, which "
            "redisson_tpu_torch has not ported yet")
        for op in ops:
            op.future.set_exception(exc)
