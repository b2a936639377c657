"""Local checkpoint / resume of the sketch store (counterpart of
`redisson_tpu.checkpoint`, same on-disk format: a directory written by
either package loads in the other).

For a framework that OWNS its state in HBM, snapshots are first-class.
Format: one directory per checkpoint,

    manifest.json   {"version": 1, "objects": {name: {otype, meta, version,
                     dtype, shape}}, "written_at": ...}
    state.npz       name -> array (numpy, host copy)

Writes are atomic (tmp dir + rename). `save` takes host copies through
`backend_torch.Readback`; the port's cell tensors are mutated in place, so
a consistent copy is the caller's to take (the client and the snapshotter
clone each object on the dispatcher and pass the clones as
`extra_objects`). `load` moves the arrays to the store's device and bumps
versions. The structure tier persists separately via its engine.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

import tempfile
import threading
from collections import defaultdict

import numpy as np
import torch

from redisson_tpu_torch.store import SketchStore

MANIFEST = "manifest.json"
STATE = "state.npz"
FORMAT_VERSION = 1
_KEY_PREFIX = "obj:"

# In-process serialization of the swap per target path; cross-process
# concurrent saves to one path are NOT supported (callers coordinate).
_path_locks: dict = defaultdict(threading.Lock)
_path_locks_guard = threading.Lock()


def _swap_lock(path: str) -> threading.Lock:
    with _path_locks_guard:
        return _path_locks[os.path.abspath(path)]


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Directory fsync: makes the rename/creation itself durable. No-op
    where directories can't be opened (exotic filesystems)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def host_copy(state) -> np.ndarray:
    """A host numpy copy of a tensor or an array-like. A CUDA tensor comes
    through a pinned `Readback` and is copied out of it, so its pinned
    buffer is released before the next object's is taken."""
    if isinstance(state, torch.Tensor):
        if not state.is_cuda:
            return state.detach().numpy()
        from redisson_tpu_torch.backend_torch import Readback

        return Readback(state.detach()).wait().numpy().copy()
    return np.asarray(state)


def save(store: SketchStore, path: str,
         names: Optional[List[str]] = None,
         extra_objects: Optional[Dict] = None,
         manifest_extra: Optional[Dict] = None,
         extra_files: Optional[Dict[str, bytes]] = None) -> int:
    """Snapshot the named objects (default all) into `path`. Returns count.

    extra_objects: {name: (otype, host array or tensor, meta, version)}
    for state the caller captured itself — bank-row HLL exports and clones
    of cell tensors taken on the dispatcher. Saved exactly like store
    objects.

    manifest_extra: extra top-level manifest keys (the persist snapshotter
    records its journal watermark here); load() ignores unknown keys.

    extra_files: {filename: bytes} written beside the manifest — opaque
    sidecar state (the structure tier's pickled keyspace). Read back via
    `extra_file()`. Pass names=[] to skip the store walk entirely and save
    only extra_objects/extra_files (a pre-captured consistent cut)."""
    if names is None:
        names = store.keys()
    objs = {}
    arrays: Dict[str, np.ndarray] = {}
    for name in names:
        obj = store.get(name)
        if obj is None:
            continue
        host = host_copy(obj.state)
        arrays[name] = host
        objs[name] = {
            "otype": obj.otype,
            "meta": obj.meta,
            "version": obj.version,
            "dtype": str(host.dtype),
            "shape": list(host.shape),
        }
    for name, (otype, host, meta, version) in (extra_objects or {}).items():
        host = host_copy(host)
        arrays[name] = host
        objs[name] = {
            "otype": otype,
            "meta": meta,
            "version": version,
            "dtype": str(host.dtype),
            "shape": list(host.shape),
        }
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    # Unique tmp dir: concurrent save() calls never clobber each other.
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.", dir=parent)
    try:
        manifest = {"version": FORMAT_VERSION, "written_at": time.time(),
                    "objects": objs}
        manifest.update(manifest_extra or {})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # Prefix array keys: a sketch literally named "file" would collide
        # with savez's first positional parameter as a bare kwarg.
        np.savez_compressed(os.path.join(tmp, STATE),
                            **{_KEY_PREFIX + k: v for k, v in arrays.items()})
        for fname, blob in (extra_files or {}).items():
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
        # Durability before the swap: the rename below is atomic against a
        # crash of THIS process, but after power loss the directory entry
        # may point at files whose data never left the page cache — fsync
        # every payload file and the tmp directory first, and the parent
        # after the swap so the rename itself is durable.
        _fsync_file(os.path.join(tmp, STATE))
        _fsync_dir(tmp)
        # Exchange-style swap: the previous good checkpoint survives (as
        # `.old`) through every crash point; load() falls back to it.
        # In-process concurrent saves serialize here.
        with _swap_lock(path):
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            if os.path.exists(path):
                os.replace(path, old)
            os.replace(tmp, path)
            _fsync_dir(parent)
            if os.path.exists(old):
                shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return len(objs)


def load(store: SketchStore, path: str,
         names: Optional[List[str]] = None, put=None) -> int:
    """Restore objects from a checkpoint into the store (overwriting
    same-named objects). Returns the number restored. Falls back to the
    `.old` sibling if a crash interrupted the last save's swap.

    put: optional hook ``put(name, otype, host_array, meta) -> bool`` that
    claims an object (returning True) instead of the default store path —
    the client uses it to route HLLs into the bank and BitSets / Blooms
    through the executor."""
    if not os.path.exists(os.path.join(path, MANIFEST)):
        old = path + ".old"
        if os.path.exists(os.path.join(old, MANIFEST)):
            path = old
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {manifest.get('version')}")
    with np.load(os.path.join(path, STATE)) as z:
        count = 0
        for name, info in manifest["objects"].items():
            if names is not None and name not in names:
                continue
            host = z[_KEY_PREFIX + name]
            meta = info.get("meta") or {}
            if info["otype"] == "bitset":
                # Legacy checkpoints predate extent tracking: default the
                # written extent to the array length so size() stays sane.
                meta.setdefault("extent_bits", int(np.prod(host.shape)))
            if info["otype"] == "bloom":
                # Layout flag is merge-unsafe (only written when true): an
                # absent key must clear any stale blocked=True on a live
                # object, or blocked kernels would run over classic bits.
                meta.setdefault("blocked", False)
            if put is not None and put(name, info["otype"], host, meta):
                count += 1
                continue
            arr = torch.from_numpy(np.ascontiguousarray(host)).to(store.device)
            obj = store.get_or_create(name, info["otype"], lambda: arr, meta)
            store.swap(name, arr)
            obj.meta.update(meta)
            count += 1
    return count


def info(path: str) -> Dict:
    """Read a checkpoint's manifest without loading state. Falls back to
    the `.old` sibling exactly like load() — a crash between the two
    os.replace calls leaves only `.old` valid, and callers probing "is
    there a checkpoint here?" must see the same answer load() would act
    on."""
    if not os.path.exists(os.path.join(path, MANIFEST)):
        old = path + ".old"
        if os.path.exists(os.path.join(old, MANIFEST)):
            path = old
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def extra_file(path: str, name: str) -> Optional[bytes]:
    """Read a sidecar file written via save(extra_files=...), honoring the
    same `.old` fallback as load()/info(). None when absent."""
    if not os.path.exists(os.path.join(path, MANIFEST)):
        old = path + ".old"
        if os.path.exists(os.path.join(old, MANIFEST)):
            path = old
    full = os.path.join(path, name)
    if not os.path.exists(full):
        return None
    with open(full, "rb") as f:
        return f.read()
