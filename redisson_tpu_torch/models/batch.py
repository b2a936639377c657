"""RBatch — pipelined multi-object execution.

Reference: `RedissonBatch.java` + `command/CommandBatchService.java`: the
collect phase does no I/O; execute() dispatches everything and returns
results in staging order (global-index reassembly,
`CommandBatchService.java:163-174`). Batch-flavored object clones share one
BatchCollector exactly as the reference's clones share one
CommandBatchService (`RedissonBatch.java`, wired at `Redisson.java:540-542`).
"""

from __future__ import annotations

from typing import Any, List

from redisson_tpu_torch.models.bitset import RBitSet
from redisson_tpu_torch.models.bloomfilter import RBloomFilter
from redisson_tpu_torch.models.bucket import RAtomicDouble, RAtomicLong, RBucket
from redisson_tpu_torch.models.collections import RList, RSet
from redisson_tpu_torch.models.geo import RGeo
from redisson_tpu_torch.models.hyperloglog import RHyperLogLog
from redisson_tpu_torch.models.map import RMap
from redisson_tpu_torch.models.multimap import RListMultimap, RSetMultimap
from redisson_tpu_torch.models.queue import RDeque, RQueue
from redisson_tpu_torch.models.scoredsortedset import RLexSortedSet, RScoredSortedSet


class _StagingExecutor:
    """Executor facade that stages into a BatchCollector instead of
    dispatching; async methods return a `StagedFuture` placeholder that the
    collector resolves in global-index order at execute() time."""

    def __init__(self, collector):
        self._collector = collector

    def execute_async(self, target, kind, payload, nkeys=0):
        return self._collector.add(target, kind, payload, nkeys)

    def execute_sync(self, target, kind, payload, nkeys=0):
        raise RuntimeError(
            "sync calls are not allowed on batch objects; stage with the "
            "async variants and call execute()"
        )


class RBatch:
    def __init__(self, executor, codec, key_width_buckets, **submit_kwargs):
        # submit_kwargs (tenant / timeout_s / deadline, serving-layer mode)
        # bind at dispatch: ONE admission decision and one deadline budget
        # for the whole pipeline, not one per staged op.
        self._collector = executor.batch(**submit_kwargs)
        self._staging = _StagingExecutor(self._collector)
        self._codec = codec
        self._widths = key_width_buckets

    def get_hyper_log_log(self, name: str) -> RHyperLogLog:
        return RHyperLogLog(name, self._staging, self._codec, self._widths)

    def get_bit_set(self, name: str) -> RBitSet:
        return RBitSet(name, self._staging, self._codec, self._widths)

    def get_bloom_filter(self, name: str) -> RBloomFilter:
        return RBloomFilter(name, self._staging, self._codec, self._widths)

    # -- structure-tier clones (reference RedissonBatch covers every object
    #    family; only async staging methods are usable, as there) ------------

    def get_bucket(self, name: str) -> RBucket:
        return RBucket(name, self._staging, self._codec, self._widths)

    def get_atomic_long(self, name: str) -> RAtomicLong:
        return RAtomicLong(name, self._staging, self._codec, self._widths)

    def get_atomic_double(self, name: str) -> RAtomicDouble:
        return RAtomicDouble(name, self._staging, self._codec, self._widths)

    def get_map(self, name: str) -> RMap:
        return RMap(name, self._staging, self._codec, self._widths)

    def get_set(self, name: str) -> RSet:
        return RSet(name, self._staging, self._codec, self._widths)

    def get_list(self, name: str) -> RList:
        return RList(name, self._staging, self._codec, self._widths)

    def get_queue(self, name: str) -> RQueue:
        return RQueue(name, self._staging, self._codec, self._widths)

    def get_deque(self, name: str) -> RDeque:
        return RDeque(name, self._staging, self._codec, self._widths)

    def get_scored_sorted_set(self, name: str) -> RScoredSortedSet:
        return RScoredSortedSet(name, self._staging, self._codec, self._widths)

    def get_lex_sorted_set(self, name: str) -> RLexSortedSet:
        return RLexSortedSet(name, self._staging, self._codec, self._widths)

    def get_set_multimap(self, name: str) -> RSetMultimap:
        return RSetMultimap(name, self._staging, self._codec, self._widths)

    def get_list_multimap(self, name: str) -> RListMultimap:
        return RListMultimap(name, self._staging, self._codec, self._widths)

    def get_map_cache(self, name: str) -> "RMapCache":
        from redisson_tpu_torch.models.mapcache import RMapCache

        return RMapCache(name, self._staging, self._codec)

    def get_set_cache(self, name: str) -> "RSetCache":
        from redisson_tpu_torch.models.mapcache import RSetCache

        return RSetCache(name, self._staging, self._codec)

    def get_set_multimap_cache(self, name: str) -> "RSetMultimapCache":
        from redisson_tpu_torch.models.multimap import RSetMultimapCache

        return RSetMultimapCache(name, self._staging, self._codec)

    def get_list_multimap_cache(self, name: str) -> "RListMultimapCache":
        from redisson_tpu_torch.models.multimap import RListMultimapCache

        return RListMultimapCache(name, self._staging, self._codec)

    def get_blocking_queue(self, name: str) -> "RBlockingQueue":
        from redisson_tpu_torch.models.queue import RBlockingQueue

        return RBlockingQueue(name, self._staging, self._codec)

    def get_blocking_deque(self, name: str) -> "RBlockingDeque":
        from redisson_tpu_torch.models.queue import RBlockingDeque

        return RBlockingDeque(name, self._staging, self._codec)

    def get_topic(self, name: str) -> "RTopic":
        """Batch-staged publish (listeners attach via the live client)."""
        from redisson_tpu_torch.models.topic import RTopic

        return RTopic(name, self._staging, self._codec, pubsub=None)

    def get_script(self) -> "RScript":
        from redisson_tpu_torch.models.script import RScript

        return RScript(self._staging)

    def get_keys(self) -> "RKeys":
        from redisson_tpu_torch.models.keys import RKeys

        return RKeys(self._staging, routing=None)

    def get_geo(self, name: str) -> RGeo:
        return RGeo(name, self._staging, self._codec, self._widths)

    def execute(self) -> List[Any]:
        """Dispatch all staged ops; results in staging order."""
        return self._collector.execute()

    def execute_async(self):
        return self._collector.execute_async()
