"""The client facade (counterpart of `redisson_tpu.client.RedissonTPU` in
its local/tpu mode).

`RedissonTorch.create(config)` resolves the device (a CUDA card by default;
`device="cpu"` only when asked), builds the sketch backend, the tier router
and the executor waist around it, and hands out objects bound to it.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch.backend_torch import TorchBackend
from redisson_tpu_torch.codecs import get_codec
from redisson_tpu_torch.config import Config, CudaConfig
from redisson_tpu_torch.executor import CommandExecutor
from redisson_tpu_torch.models.bitset import RBitSet
from redisson_tpu_torch.models.bloomfilter import RBloomFilter
from redisson_tpu_torch.models.hyperloglog import RHyperLogLog
from redisson_tpu_torch.routing import RoutingBackend
from redisson_tpu_torch.store import SketchStore


class RedissonTorch:
    """The RedissonClient analogue on one CUDA device."""

    def __init__(self, config: Union[Config, CudaConfig, None] = None):
        if isinstance(config, CudaConfig):
            config = Config(cuda=config)
        self.config = config or Config()
        ccfg = self.config.cuda or CudaConfig()
        self.device = device_mod.resolve(ccfg.device)
        self._codec = get_codec(self.config.codec)
        self._widths = tuple(ccfg.key_width_buckets)
        self._store = SketchStore(self.device)
        self.sketch = TorchBackend(
            self._store, hll_impl=ccfg.hll_impl, seed=ccfg.hash_seed,
            ingest=ccfg.ingest, hll_hash=ccfg.hll_hash,
            read_cache_entries=ccfg.read_cache_entries)
        self._backend = RoutingBackend(self.sketch)
        self._executor = CommandExecutor(
            self._backend, max_batch_keys=ccfg.max_batch_keys,
            inflight_runs=self.config.inflight_runs)
        self._is_shutdown = False

    @classmethod
    def create(cls, config: Union[Config, CudaConfig, None] = None) -> "RedissonTorch":
        """Build a client; accepts a Config or the CudaConfig section that
        `Config().use_cuda(...)` returns."""
        return cls(config)

    # -- sketch objects -----------------------------------------------------

    def get_hyper_log_log(self, name: str, codec=None) -> RHyperLogLog:
        codec = get_codec(codec) if codec is not None else self._codec
        return RHyperLogLog(name, self._executor, codec, self._widths)

    def get_bit_set(self, name: str) -> RBitSet:
        return RBitSet(name, self._executor, self._codec, self._widths)

    def get_bloom_filter(self, name: str, codec=None) -> RBloomFilter:
        codec = get_codec(codec) if codec is not None else self._codec
        return RBloomFilter(name, self._executor, codec, self._widths)

    def get_keys(self, pattern: str = "*"):
        return self._executor.execute_sync("", "keys", {"pattern": pattern})

    def flushall(self) -> None:
        self._executor.execute_sync("", "flushall", None)

    # -- state carry-over ---------------------------------------------------

    def from_jax_state(self, bank_np: np.ndarray, rows: dict,
                       objects: dict = None) -> None:
        """Install the JAX backend's HLL bank and row map and, given
        `objects` (name -> what the JAX backend's `bits_export` returns for
        it), its BitSet and Bloom objects; ordered on the dispatcher after
        every op submitted before it."""
        self._executor.execute_barrier(
            lambda: self.sketch.from_jax_state(bank_np, rows, objects)).result()

    def to_numpy_state(self):
        """(bank [S, m] int32 numpy, name -> row) after all submitted ops."""
        return self._executor.execute_barrier(self.sketch.to_numpy_state).result()

    def to_numpy_objects(self) -> dict:
        """name -> (otype, cells uint8 numpy, meta) of every BitSet and
        Bloom object, after all submitted ops."""
        return self._executor.execute_barrier(self.sketch.to_numpy_objects).result()

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        if self._is_shutdown:
            return
        self._executor.shutdown()
        self.sketch.completer.shutdown()
        self._is_shutdown = True
