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

Placement (the pod tier and the mesh plane): a sharded array is a ``Sharded``, one tensor per
entry on that entry's device, as JAX's ``NamedSharding(mesh, P("shards",
...))`` places one shard per device. ``Sharding`` (``bank_sharding``,
``slot_sharding``) makes and moves them, as JAX's ``device_put`` does; an
operand every entry reads whole goes to each entry's device by
``replicate``. One layout for every mesh: on one card the entries'
blocks are separate tensors of ``cuda:0``, on the CPU separate CPU tensors,
so one card and the CPU tests run the code several cards run.

The mesh data plane (``ShardedBank``, ``TorchBackend.attach_mesh``) has the
pod's layout: its one shared HLL bank is a ``Sharded`` made and moved by
``slot_sharding(mesh)``, block ``i`` on entry ``i``'s device, so the plane
runs over several cards as the pod does.

``get_mesh`` is the CACHED constructor: topology-change storms (node_up /
node_down scans re-resolving the same device set) must not mint fresh
meshes. The cache is invalidated only when the resolved device set
changes; ``mesh_cache_stats`` exposes build / hit counters so tests can pin
the no-rebuild contract.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch import device as device_mod

SHARD_AXIS = "shards"
SLOT_AXIS = "slots"

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
    def home(self) -> torch.device:
        """Entry 0's device: where the pod's and the mesh plane's
        cross-shard combines land, and where the unsharded kinds live (the
        pod's delegate, the mesh plane's store and tape windows: JAX's
        device 0)."""
        return self.devices[0]


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


class Sharded:
    """One sharded array of the pod tier or the mesh plane (JAX: an array
    placed with ``NamedSharding(mesh, P(axis, ...))``): block ``i`` is a
    tensor of its own on ``mesh.devices[i]`` holding the global rows (the bank) or
    cells (bits) ``[i * per, i * per + len(block i))``. Every block holds
    ``per`` but in a trimmed copy (``clone(stop)``). Global indexes are
    Python ints, so a cell index up to 2^32 - 1 is exact."""

    __slots__ = ("mesh", "blocks", "per")

    def __init__(self, mesh: Mesh, blocks, per: Optional[int] = None):
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size}")
        self.mesh = mesh
        self.blocks: List[torch.Tensor] = list(blocks)
        self.per = int(blocks[0].shape[0]) if per is None else int(per)

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((sum(int(b.shape[0]) for b in self.blocks),)
                + tuple(self.blocks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def nbytes(self) -> int:
        """Bytes of every block: what the entries' devices hold."""
        return sum(int(b.nbytes) for b in self.blocks)

    def __len__(self) -> int:
        return self.shape[0]

    def ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)] global range of each block."""
        return [(i * self.per, i * self.per + int(b.shape[0]))
                for i, b in enumerate(self.blocks)]

    def locate(self, index: int) -> Tuple[int, int]:
        """(entry, local index) of a global row or cell."""
        i = int(index)
        if not 0 <= i < len(self):
            raise IndexError(f"index {i} outside [0, {len(self)})")
        return i // self.per, i % self.per

    def row(self, index: int) -> torch.Tensor:
        """The view of one global row (or cell) in its block."""
        b, j = self.locate(index)
        return self.blocks[b][j]

    def to_numpy(self, stop: Optional[int] = None) -> np.ndarray:
        """The blocks concatenated on the host (the first `stop` rows or
        cells)."""
        stop = len(self) if stop is None else int(stop)
        parts = []
        for (lo, hi), b in zip(self.ranges(), self.blocks):
            if lo < stop:
                parts.append(b[: min(hi, stop) - lo].cpu().numpy())
        if not parts:
            return self.blocks[0][:0].cpu().numpy()
        return np.concatenate(parts)

    def __array__(self, dtype=None, copy=None):
        out = self.to_numpy()
        return out if dtype is None else out.astype(dtype)

    def clone(self, stop: Optional[int] = None) -> "Sharded":
        """A copy of every block on its own device (the first `stop` rows
        or cells: later blocks come out shorter or empty)."""
        stop = len(self) if stop is None else int(stop)
        return Sharded(self.mesh, [b[: max(0, min(hi, stop) - lo)].clone()
                                   for (lo, hi), b in zip(self.ranges(), self.blocks)],
                       self.per)


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return torch.as_tensor(arr)


def on_home(mesh: Mesh, arr, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An operand (numpy or a tensor on any device) on the mesh's home."""
    t = _as_tensor(arr).to(mesh.home)
    return t if dtype is None else t.to(dtype)


# Cross-card moves are peer copies (``Tensor.to`` / ``copy_`` between cards,
# which PyTorch orders against both cards' current streams), not NCCL: the
# pod is one process driving every card, as JAX's is, while
# ``torch.distributed`` wants a process per card; and what crosses cards is
# small (a key chunk's hashes, a [2^14] HLL partial, a few BITCOUNT
# partials) or a one-off re-blocking (growth, reshard).


def replicate(mesh: Mesh, arr) -> Tuple[torch.Tensor, ...]:
    """An operand every entry reads whole (JAX's ``device_put`` under
    ``P()``): one tensor per entry, entries on one device sharing it."""
    t = _as_tensor(arr)
    copies: Dict[torch.device, torch.Tensor] = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
    return tuple(copies[d] for d in mesh.devices)


@dataclass(frozen=True)
class Sharding:
    """An array split over the mesh's axis along its first dimension
    (JAX's ``NamedSharding`` under ``P(axis, ...)``): rows for a bank,
    cells for bits."""

    mesh: Mesh
    axis: str = SHARD_AXIS

    def __post_init__(self):
        if self.axis != self.mesh.axis:
            raise ValueError(f"axis {self.axis!r} is not the mesh's axis "
                             f"{self.mesh.axis!r}")

    def _per(self, n: int) -> int:
        if n % self.mesh.size:
            raise ValueError(f"{n} rows not divisible by {self.mesh.size} devices")
        return n // self.mesh.size

    def zeros(self, shape, dtype: torch.dtype) -> Sharded:
        """A zero array of global `shape`, split into its blocks."""
        per = self._per(int(shape[0]))
        rest = tuple(shape[1:])
        return Sharded(self.mesh, [torch.zeros((per,) + rest, dtype=dtype, device=d)
                                   for d in self.mesh.devices])

    def put(self, arr, rows: Optional[int] = None) -> Sharded:
        """`arr` (numpy, a tensor on any device, or a ``Sharded``) split
        here (JAX's ``device_put``): a new ``Sharded`` of `rows` global
        rows or cells (default `len(arr)`; rows past `arr` are zero), each
        block filled from the source ranges it overlaps, so rows keep
        their global index when the block boundaries move."""
        if isinstance(arr, Sharded):
            pieces = [(lo, b) for (lo, _), b in zip(arr.ranges(), arr.blocks)]
            src_rows, rest, dtype = len(arr), arr.shape[1:], arr.dtype
        else:
            t = _as_tensor(arr)
            pieces = [(0, t)]
            src_rows, rest, dtype = int(t.shape[0]), tuple(t.shape[1:]), t.dtype
        rows = src_rows if rows is None else int(rows)
        if rows < src_rows:
            raise ValueError(f"cannot shrink {src_rows} -> {rows}")
        per = self._per(rows)
        blocks = []
        for i, d in enumerate(self.mesh.devices):
            lo, hi = i * per, (i + 1) * per
            make = torch.empty if hi <= src_rows else torch.zeros
            blk = make((per,) + tuple(rest), dtype=dtype, device=d)
            for start, src in pieces:
                a, b = max(lo, start), min(hi, start + int(src.shape[0]))
                if a < b:
                    blk[a - lo:b - lo].copy_(src[a - start:b - start],
                                             non_blocking=True)
            blocks.append(blk)
        return Sharded(self.mesh, blocks)


def bank_sharding(mesh: Mesh, axis: str = SHARD_AXIS) -> Sharding:
    """[S, m] sketch bank: rows split across the entries, registers
    local."""
    return Sharding(mesh, axis)


def slot_sharding(mesh: Mesh) -> Sharding:
    """A bank split by slot-range rows across a ``SLOT_AXIS`` mesh."""
    return Sharding(mesh, SLOT_AXIS)


def replicated(mesh: Mesh):
    """JAX's name for the replicated placement: ``replicated(mesh)(arr)``
    is ``replicate(mesh, arr)``."""
    return functools.partial(replicate, mesh)


class ShardedBank:
    """Placement and row-geometry bookkeeping for the mesh data plane's one
    HLL bank.

    The bank is a ``Sharded`` owned by the TorchBackend, placed by
    ``slot_sharding(mesh)`` as JAX places it (``NamedSharding(mesh,
    P("slots"))``): block ``i``, rows ``[i * S/D, (i + 1) * S/D)``, a tensor
    of its own on entry ``i``'s device. This object carries the mesh and
    the logical shard -> preferred row-range map that keeps a shard's
    sketches in one entry's block, so a collective fold finds them there.

    Preferred ranges are a PLACEMENT HINT, not a correctness domain: when a
    shard's range fills, rows spill to any free row (the collectives select
    by row index, never by block)."""

    def __init__(self, mesh: Mesh, capacity: int, num_shards: int):
        self.mesh = mesh
        self.num_shards = max(int(num_shards), 1)
        self.capacity = self.round_capacity(capacity)
        self.sharding = slot_sharding(mesh)

    @property
    def ndev(self) -> int:
        return self.mesh.size

    def round_capacity(self, capacity: int) -> int:
        """Row count must divide evenly across mesh entries."""
        ndev = self.mesh.size
        if capacity % ndev:
            capacity += ndev - capacity % ndev
        return capacity

    def place(self, bank, rows: Optional[int] = None) -> Sharded:
        """Commit a bank (numpy, a tensor on any device, or a ``Sharded``)
        onto the mesh (JAX's ``device_put`` under the slot sharding): a
        ``Sharded`` of `rows` rows (default the bank's own; rows past it
        are zero), each block filled on its entry's device."""
        return self.sharding.put(bank, rows)

    def block(self, shard_id: int, capacity: Optional[int] = None
              ) -> Tuple[int, int]:
        """Preferred [lo, hi) row range for a logical shard's sketches."""
        cap = self.capacity if capacity is None else capacity
        width = max(cap // self.num_shards, 1)
        lo = min(shard_id * width, cap)
        hi = cap if shard_id == self.num_shards - 1 else min(lo + width, cap)
        return lo, hi
