"""The structures tier: host-side data-structure engine for the long tail of
L3 objects (maps, sets, lists, queues, zsets, caches, locks, topics).

A copy of `redisson_tpu.structures`. The reference executes *every* object
op remotely on Redis' C data-structure engine; this package keeps sketch ops
(HLL/BitSet/Bloom) on the CUDA device and runs the rest on this in-process
engine behind the same CommandExecutor waist. Atomicity falls out of
the single dispatcher thread exactly as the reference's falls out of Redis'
single-threaded command loop — compound ops that the reference expresses as
Lua scripts are single engine ops here.
"""

from redisson_tpu_torch.structures.engine import PubSubHub, StructureBackend  # noqa: F401
