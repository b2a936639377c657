"""The sketch store: named objects -> tensors on one `torch.device`
(counterpart of `redisson_tpu.store`).

HLLs live as rows of the backend's bank, not here; the store holds the
other sketch kinds (BitSet and Bloom cell tensors), and the backend
consults it so an operation on a name of another kind fails with WRONGTYPE.
Every `swap` of an object's state bumps its `version`, with an optional
compare-and-set on it.
Names map to cluster hash slots with the same CRC16 function as Redis.
"""

from __future__ import annotations

import fnmatch
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from redisson_tpu_torch.ops import crc16


class ObjectType:
    HLL = "hll"
    BITSET = "bitset"
    BLOOM = "bloom"


@dataclass
class StoredObject:
    """One named object: its device state plus metadata."""

    name: str
    otype: str
    state: torch.Tensor
    slot: int
    meta: Dict[str, Any] = field(default_factory=dict)
    version: int = 0


class WrongTypeError(TypeError):
    """Operation against a key holding the wrong kind of value (Redis
    WRONGTYPE)."""


class SketchStore:
    """Thread-safe name -> StoredObject registry on one device."""

    def __init__(self, device: torch.device):
        self._lock = threading.RLock()
        self._objects: Dict[str, StoredObject] = {}
        self.device = torch.device(device)

    @staticmethod
    def slot_of(name: str) -> int:
        return crc16.key_slot(name)

    def get(self, name: str, otype: Optional[str] = None) -> Optional[StoredObject]:
        with self._lock:
            obj = self._objects.get(name)
        if obj is not None and otype is not None and obj.otype != otype:
            raise WrongTypeError(
                f"key '{name}' holds {obj.otype}, operation needs {otype}")
        return obj

    def get_or_create(self, name: str, otype: str,
                      factory: Callable[[], torch.Tensor],
                      meta: Optional[Dict[str, Any]] = None) -> StoredObject:
        with self._lock:
            obj = self._objects.get(name)
            if obj is None:
                obj = StoredObject(name=name, otype=otype,
                                   state=factory().to(self.device),
                                   slot=self.slot_of(name),
                                   meta=dict(meta or {}))
                self._objects[name] = obj
        if obj.otype != otype:
            raise WrongTypeError(
                f"key '{name}' holds {obj.otype}, operation needs {otype}")
        return obj

    def swap(self, name: str, new_state: torch.Tensor,
             expected_version: Optional[int] = None) -> bool:
        """Install new state (the same tensor after an in-place update, or a
        fresh one) and bump the version; with `expected_version`, only if
        the version still matches (False otherwise, or if absent)."""
        with self._lock:
            obj = self._objects.get(name)
            if obj is None:
                return False
            if expected_version is not None and obj.version != expected_version:
                return False
            obj.state = new_state
            obj.version += 1
            return True

    def delete(self, name: str) -> bool:
        with self._lock:
            return self._objects.pop(name, None) is not None

    def rename(self, name: str, new_name: str) -> bool:
        """Move an object under a new key (the destination is overwritten)."""
        with self._lock:
            obj = self._objects.pop(name, None)
            if obj is None:
                return False
            obj.name = new_name
            obj.slot = self.slot_of(new_name)
            self._objects[new_name] = obj
            return True

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._objects

    def keys(self, pattern: Optional[str] = None):
        with self._lock:
            names = list(self._objects)
        if pattern is None or pattern == "*":
            return names
        return [n for n in names if fnmatch.fnmatch(n, pattern)]

    def flushall(self) -> None:
        with self._lock:
            self._objects.clear()
