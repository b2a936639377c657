"""Client configuration: the counterpart of `redisson_tpu.config` for the
single-device sketch engine on a CUDA card.

`Config.use_cuda()` is the builder, like `Config.use_tpu()`: it creates (or
returns) the `CudaConfig` section, applies any keyword overrides, and
returns that section.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

#: ingest paths: "auto" lets the planner pick per batch size from timings
#: taken on the device and the measured link profile; "device" uses
#: `hll_impl`; "scatter" / "sort" / "segment" force that device insert
#: ("segment" = the CUDA segmented-insert kernel); "hostfold" folds keys on
#: the host (HLL registers, the Bloom host mirror); "delta" folds the three
#: write kinds into planes merged on the device by the delta_merge kernel;
#: "tape" retires such a window with one window_merge launch.
INGEST_CHOICES = ("auto", "device", "hostfold", "delta", "scatter", "sort",
                  "segment", "tape")
#: ingest paths that need the host fold library (`native.py`)
HOST_INGEST = ("hostfold", "delta", "tape")
HLL_IMPLS = ("scatter", "sort", "segment")
HLL_HASHES = ("murmur3", "redis")


def check_ingest(ingest: str) -> None:
    if ingest not in INGEST_CHOICES:
        raise ValueError(f"unknown ingest policy: {ingest!r}")


@dataclass
class CudaConfig:
    """Single-device sketch engine (mirrors `redisson_tpu.config.TpuConfig`)."""

    # "cuda:N", or "cpu" to run the same engine on the CPU (tests).
    device: str = "cuda:0"
    hll_impl: str = "scatter"  # insert used by ingest="device"
    # "murmur3" (murmur3 x64 128, the framework's family) or "redis"
    # (MurmurHash64A seed 0xadc83b19, what a Redis server's PFADD computes).
    hll_hash: str = "murmur3"
    ingest: str = "auto"
    hash_seed: int = 0
    # Coalescing cap for one dispatcher run; kernels still chunk at
    # engine.MAX_BUCKET keys per call.
    max_batch_keys: int = 1 << 23
    key_width_buckets: tuple = (16, 32, 64, 128, 256)
    # Epoch-stamped read cache entries (memoized PFCOUNT); 0 disables.
    read_cache_entries: int = 1024


@dataclass
class Config:
    cuda: Optional[CudaConfig] = None
    codec: str = "json"  # default value codec
    # How many coalesced runs may be in flight at once (staged and
    # dispatched, futures unresolved); per-target order holds at any depth.
    inflight_runs: int = 2

    def use_cuda(self, **overrides) -> CudaConfig:
        self.cuda = self.cuda or CudaConfig()
        names = {f.name for f in fields(CudaConfig)}
        for key, value in overrides.items():
            if key not in names:
                raise TypeError(f"CudaConfig has no field {key!r}")
            setattr(self.cuda, key, value)
        check_ingest(self.cuda.ingest)
        return self.cuda
