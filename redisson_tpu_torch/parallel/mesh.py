"""Logical device meshes (counterpart of `redisson_tpu.parallel.mesh`).

Two axes live here, as in JAX:

* ``SHARD_AXIS`` ("shards") — the pod tier's one-axis mesh (backend_pod);
* ``SLOT_AXIS`` ("slots") — the cluster mesh data plane's axis: one HLL
  bank whose rows (slot-range sketches) are split across the mesh
  (``ShardedBank``), so N logical shards share one engine.

JAX's pod and mesh modes are single-controller: one process, one ``Mesh``
over every device, collectives inside ``shard_map``. The port keeps that
shape with a mesh of LOGICAL devices: a ``Mesh`` is an axis name and a
tuple of ``torch.device``, entry ``i`` on ``cuda:{i % cards}`` (the cluster
tier's shard rule), or on the CPU when the caller asks for it. Each shard
body of JAX runs once per entry, over that entry's rows or cell range, and
``pmax`` / ``psum`` become an explicit combine of the per-entry partials.

Placement: when every entry names the same device, a sharded array is ONE
contiguous tensor whose row blocks (bank) or cell ranges (bits) are the
shards, as views with no copies. That is the only layout one card and the
CPU tests can run, and it keeps every single-bank code path of the backend
unchanged. A mesh whose entries name different cards raises
NotImplementedError (ROADMAP queue 1, multi-card placement).

``get_mesh`` is the CACHED constructor: topology-change storms (node_up /
node_down scans re-resolving the same device set) must not mint fresh
meshes. The cache is invalidated only when the resolved device set
changes; ``mesh_cache_stats`` exposes build / hit counters so tests can pin
the no-rebuild contract.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from redisson_tpu_torch import device as device_mod

SHARD_AXIS = "shards"
SLOT_AXIS = "slots"

#: the ROADMAP item a mesh spanning several cards waits for
MULTI_CARD_ITEM = "ROADMAP queue 1: multi-card placement"

# Lock discipline: every name in this table is only touched under the
# named lock.
GUARDED_BY = {
    "_MESH_CACHE": "_CACHE_LOCK",
    "_CACHE_STATS": "_CACHE_LOCK",
}

_CACHE_LOCK = threading.Lock()
# (num_devices, axis, devices) -> Mesh
_MESH_CACHE: Dict[Tuple[int, str, Tuple[str, ...]], "Mesh"] = {}
_CACHE_STATS = {"builds": 0, "hits": 0, "invalidations": 0}


class Devices(tuple):
    """A mesh's entries: a tuple of `torch.device` that also answers JAX's
    `mesh.devices.size`."""

    @property
    def size(self) -> int:
        return len(self)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of logical devices: `axis` and one `torch.device` per
    entry. Hashable, so per-mesh caches key on it."""

    axis: str
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "devices", Devices(self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def device(self) -> torch.device:
        """The one device every entry names: where the mesh's arrays live
        as one tensor. Raises for a mesh spanning several cards."""
        first = self.devices[0]
        if any(d != first for d in self.devices[1:]):
            raise NotImplementedError(
                f"a mesh whose entries span several devices "
                f"({sorted({str(d) for d in self.devices})}) needs multi-card "
                f"placement ({MULTI_CARD_ITEM})")
        return first


def _entries(num_devices: int, device) -> Tuple[torch.device, ...]:
    """The entries' devices: n entries on the CPU, or entry i on
    `cuda:{i % cards}` (resolved, so a request for the card raises
    without one). `num_devices=0` means one entry per card (one on the
    CPU)."""
    base = device_mod.resolve(device)
    if base.type == "cpu":
        return (base,) * max(1, int(num_devices))
    cards = torch.cuda.device_count()
    n = int(num_devices) or cards
    return tuple(torch.device("cuda", i % cards) for i in range(n))


def build_mesh(num_devices: int = 0, axis: str = SHARD_AXIS,
               device="cuda:0") -> Mesh:
    """1-D mesh of `num_devices` logical entries (0 = one per card) on
    `device`'s type: the card unless the caller names the CPU."""
    return Mesh(axis, _entries(num_devices, device))


def get_mesh(num_devices: int = 0, axis: str = SHARD_AXIS,
             device="cuda:0") -> Mesh:
    """Cached `build_mesh`: returns the SAME Mesh for the same resolved
    device set, so reshard / on_change paths hitting this every scan reuse
    every per-mesh cache. Invalidated (and rebuilt) only when the device
    set itself changed."""
    devs = _entries(num_devices, device)
    key = (len(devs), axis, tuple(str(d) for d in devs))
    with _CACHE_LOCK:
        mesh = _MESH_CACHE.get(key)
        if mesh is not None:
            _CACHE_STATS["hits"] += 1
            return mesh
        # Same (count, axis) but a different device set: the old entry is
        # stale (a device was lost or replaced); drop it before rebuilding.
        stale = [k for k in _MESH_CACHE if k[0] == key[0] and k[1] == key[1]]
        for k in stale:
            _MESH_CACHE.pop(k, None)
            _CACHE_STATS["invalidations"] += 1
        mesh = Mesh(axis, devs)
        _MESH_CACHE[key] = mesh
        _CACHE_STATS["builds"] += 1
    return mesh


def mesh_cache_stats() -> Dict[str, int]:
    with _CACHE_LOCK:
        return dict(_CACHE_STATS)


def reset_mesh_cache() -> None:
    """Test hook: drop every cached mesh and zero the counters."""
    with _CACHE_LOCK:
        _MESH_CACHE.clear()
        for k in _CACHE_STATS:
            _CACHE_STATS[k] = 0


def row_blocks(rows: int, mesh: Mesh):
    """[(lo, hi)] row range of each mesh entry of a [rows, ...] array
    (rows divide evenly: callers round capacities to the mesh size)."""
    per = rows // mesh.size
    return [(i * per, (i + 1) * per) for i in range(mesh.size)]


class ShardedBank:
    """Placement and row-geometry bookkeeping for the mesh data plane's one
    HLL bank.

    The bank itself stays a plain ``[S, m] int32`` tensor owned by the
    TorchBackend (every single-bank path keeps working); this object
    carries the mesh and the logical shard -> preferred row-block map that
    keeps a shard's sketches in its own mesh entry's rows, so a collective
    fold finds them in that entry's local block.

    Row blocks are a PLACEMENT HINT, not a correctness domain: when a
    shard's preferred block fills, rows spill to any free row (the
    collectives select by row index, never by block)."""

    def __init__(self, mesh: Mesh, capacity: int, num_shards: int):
        self.mesh = mesh
        self.num_shards = max(int(num_shards), 1)
        self.capacity = self.round_capacity(capacity)

    def round_capacity(self, capacity: int) -> int:
        """Row count must divide evenly across mesh entries."""
        ndev = self.mesh.size
        if capacity % ndev:
            capacity += ndev - capacity % ndev
        return capacity

    def place(self, bank: torch.Tensor) -> torch.Tensor:
        """Commit a bank onto the mesh: one contiguous tensor on the mesh's
        device, whose row blocks are the entries' shards."""
        return bank.to(self.mesh.device).contiguous()

    def replicate(self, arr) -> torch.Tensor:
        """An operand every entry reads (wire, table, row list): on the
        mesh's device, read by every shard in place."""
        return torch.as_tensor(arr).to(self.mesh.device)

    def block(self, shard_id: int, capacity: Optional[int] = None
              ) -> Tuple[int, int]:
        """Preferred [lo, hi) row range for a logical shard's sketches."""
        cap = self.capacity if capacity is None else capacity
        width = max(cap // self.num_shards, 1)
        lo = min(shard_id * width, cap)
        hi = cap if shard_id == self.num_shards - 1 else min(lo + width, cap)
        return lo, hi
