"""Client configuration: the counterpart of `redisson_tpu.config` for the
single-device sketch engine on a CUDA card.

`Config.use_cuda()` is the builder, like `Config.use_tpu()`: it creates (or
returns) the `CudaConfig` section, applies any keyword overrides, and
returns that section. `use_persist(dir)` and `use_faults()` do the same for
the durability and fault sections (the JAX package's fields and defaults).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

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
class PersistConfig:
    """Durability subsystem (`persist/`): write-ahead op journal, snapshots
    and crash recovery (mirrors `redisson_tpu.config.PersistConfig`)."""

    # Journal + snapshot directory ("" disables persistence even when the
    # section is present).
    dir: str = ""
    # appendfsync analogue: "always" (group-committed write-ahead fsync,
    # durability lag bounded by the in-flight window), "everysec"
    # (background fsync every fsync_interval_s), "off" (OS-paced).
    fsync: str = "everysec"
    fsync_interval_s: float = 1.0
    # Group-commit size for fsync="always"; 0 = follow Config.inflight_runs
    # (one fsync per in-flight window). 1 = strict fsync-per-run.
    group_commit_runs: int = 0
    segment_max_bytes: int = 64 << 20
    # Background snapshot cadence (0 = on demand via
    # client.persist.snapshot() only). Each snapshot truncates wholly
    # covered journal segments.
    snapshot_interval_s: float = 0.0
    snapshot_keep: int = 2
    # Replay snapshot + journal suffix at client create when the directory
    # holds prior state (also the way back from a lost CUDA context: a new
    # process on the same directory).
    auto_recover: bool = True


@dataclass
class FaultConfig:
    """Fault subsystem (`fault/`): classification is always on; this
    section controls injection, the run watchdog and the self-healing
    rebuild (mirrors `redisson_tpu.config.FaultConfig`)."""

    # Declarative injection schedule: FaultRule dicts ({"seam", "fault",
    # "nth", "times", "kind", "target"}); empty = no injection.
    plan: List[Dict[str, Any]] = field(default_factory=list)
    seed: int = 0  # documents how a random plan was generated
    # Run watchdog over the executor's in-flight window (floor deadlines:
    # no cost model without a serving layer).
    watchdog: bool = False
    watchdog_margin: float = 8.0
    watchdog_floor_s: float = 2.0
    watchdog_poll_s: float = 0.05
    # Self-healing rebuild on StateUncertain/DeviceLost retirement; needs
    # Config.persist for host truth, else faulted targets degrade.
    rebuild: bool = True


def _apply(section, overrides: dict):
    names = {f.name for f in fields(section)}
    for key, value in overrides.items():
        if key not in names:
            raise TypeError(f"{type(section).__name__} has no field {key!r}")
        setattr(section, key, value)
    return section


@dataclass
class Config:
    cuda: Optional[CudaConfig] = None
    codec: str = "json"  # default value codec
    # How many coalesced runs may be in flight at once (staged and
    # dispatched, futures unresolved); per-target order holds at any depth.
    inflight_runs: int = 2
    persist: Optional[PersistConfig] = None
    faults: Optional[FaultConfig] = None

    def use_cuda(self, **overrides) -> CudaConfig:
        self.cuda = _apply(self.cuda or CudaConfig(), overrides)
        check_ingest(self.cuda.ingest)
        return self.cuda

    def use_persist(self, dir: str = "", **overrides) -> PersistConfig:
        """The durability section: journal and snapshots under `dir`."""
        self.persist = self.persist or PersistConfig()
        if dir:
            self.persist.dir = dir
        _apply(self.persist, overrides)
        if self.persist.fsync not in ("always", "everysec", "off"):
            raise ValueError(f"unknown fsync policy {self.persist.fsync!r}")
        return self.persist

    def use_faults(self, **overrides) -> FaultConfig:
        """The fault section: injection plan, watchdog, rebuild."""
        self.faults = _apply(self.faults or FaultConfig(), overrides)
        return self.faults
