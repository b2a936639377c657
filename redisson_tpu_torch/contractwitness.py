"""Runtime op-contract coverage witness (a copy of
`redisson_tpu.contractwitness`).

A declared (kind x surface) cell can be dead: a wire command that stages
a kind no client sends, a geo apply branch no converge run reaches, a
journaled kind no recovery ever replays. Armed via::

    REDISSON_TPU_CONTRACT_WITNESS=1          # arm for this process
    REDISSON_TPU_CONTRACT_WITNESS_OUT=f.json # dump a snapshot at exit

it records, per execution **surface**, which op kinds actually pass the
executor's single enqueue funnel (`execute_async` / `execute_many`):

  facade  — direct client/model dispatch (the default surface)
  wire    — RESP command windows flushed by the TCP front-end
  replay  — crash-recovery journal replay
  replica — follower live-stream apply
  geo     — remote-site record application

Surfaces are tagged with a thread-local ``surface("wire")`` context
manager at the four dispatch seams (wire/server.py, persist/recover.py,
persist/follower.py, geo/applier.py); everything untagged is facade
traffic. The hot path is one module-global probe (``RECORD is None``)
when disarmed and a dict increment on per-thread cells when armed — no
locks are taken on the dispatch path, matching the lock/loop witness
discipline.

Snapshots from concurrent/sequential runs merge
(`merge_contract_snapshots`), so a matrix can be gathered over several
processes. ``uninstall()`` / ``contract_witness_reset()`` give tests
isolation.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Callable, Dict, Iterable, Optional

ENV_FLAG = "REDISSON_TPU_CONTRACT_WITNESS"
ENV_OUT = "REDISSON_TPU_CONTRACT_WITNESS_OUT"

DEFAULT_SURFACE = "facade"

#: dispatch-path hook: None when disarmed (the one-probe fast path the
#: executor checks), else a callable(kind) recording on the caller's
#: thread-local cell dict. Rebound by arm()/disarm(), never mutated.
RECORD: Optional[Callable[[str], None]] = None

# Registry of per-thread cell dicts is guarded by _STATE_LOCK; each cell
# dict has a single writer (its thread) with racy cross-thread snapshot
# reads — same discipline as the lock witness.
_STATE_LOCK = threading.Lock()
_CELLS: list = []  # [{surface: {kind: count}}, ...] one per thread
_TLS = threading.local()
_DUMP_ARMED = False


def contract_witness_enabled() -> bool:
    """True when the contract witness is armed for this process."""
    return os.environ.get(ENV_FLAG, "") == "1"


def _thread_cells() -> Dict[str, Dict[str, int]]:
    cells = getattr(_TLS, "cells", None)
    if cells is None:
        cells = _TLS.cells = {}
        with _STATE_LOCK:
            _CELLS.append(cells)
    return cells


def _record(kind: str) -> None:
    cells = _thread_cells()
    surf = getattr(_TLS, "surface", DEFAULT_SURFACE)
    per = cells.get(surf)
    if per is None:
        per = cells[surf] = {}
    per[kind] = per.get(kind, 0) + 1


class surface:
    """Tag ops dispatched inside the block with an execution surface::

        with contractwitness.surface("wire"):
            dispatch.execute_many(staged)

    Thread-local and re-entrant (restores the previous tag on exit), so
    nested seams — a geo apply inside a replica stream — attribute to
    the innermost surface. Cheap enough to run unconditionally: two
    attribute writes when the witness is disarmed.
    """

    __slots__ = ("name", "_prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._prev = getattr(_TLS, "surface", DEFAULT_SURFACE)
        _TLS.surface = self.name
        return self

    def __exit__(self, *exc):
        _TLS.surface = self._prev
        return False


def arm(force: bool = False) -> bool:
    """Enable recording (no-op unless the env flag is set or `force`).
    Returns True when the witness is (now) armed."""
    global RECORD
    if not (force or contract_witness_enabled()):
        return False
    RECORD = _record
    _arm_dump()
    return True


def disarm() -> None:
    """Stop recording; witnessed cells stay visible to snapshots."""
    global RECORD
    RECORD = None


def uninstall() -> None:
    """Disarm and drop all witnessed state (test isolation). Other
    threads' thread-local cell dicts re-register on their next record."""
    disarm()
    contract_witness_reset()


def contract_witness_reset() -> None:
    """Zero the witnessed matrix without changing armed state."""
    with _STATE_LOCK:
        cells = list(_CELLS)
    for c in cells:
        c.clear()


def contract_snapshot() -> dict:
    """The witnessed (surface -> kind -> count) matrix across all
    threads, JSON-shaped."""
    with _STATE_LOCK:
        cells = list(_CELLS)
    merged: Dict[str, Dict[str, int]] = {}
    for c in cells:
        for surf, kinds in list(c.items()):
            per = merged.setdefault(surf, {})
            for kind, n in list(kinds.items()):
                per[kind] = per.get(kind, 0) + n
    return {"version": 1,
            "cells": {s: dict(sorted(k.items()))
                      for s, k in sorted(merged.items())}}


def merge_contract_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge contract_snapshot() dicts from several runs/processes:
    counts sum per (surface, kind) cell."""
    merged: Dict[str, Dict[str, int]] = {}
    for snap in snaps:
        for surf, kinds in snap.get("cells", {}).items():
            per = merged.setdefault(surf, {})
            for kind, n in kinds.items():
                per[kind] = per.get(kind, 0) + int(n)
    return {"version": 1,
            "cells": {s: dict(sorted(k.items()))
                      for s, k in sorted(merged.items())}}


def dump_contract_witness(path: Optional[str] = None) -> None:
    """Write the snapshot as JSON (atexit hook when
    REDISSON_TPU_CONTRACT_WITNESS_OUT names a file — the subprocess
    harvest path)."""
    path = path or os.environ.get(ENV_OUT, "")
    if not path:
        return
    try:
        with open(path, "w") as fh:
            json.dump(contract_snapshot(), fh, indent=1, sort_keys=True)
    except OSError:
        pass


def _arm_dump() -> None:
    global _DUMP_ARMED
    out = os.environ.get(ENV_OUT, "")
    if not out or _DUMP_ARMED:
        return
    _DUMP_ARMED = True
    atexit.register(dump_contract_witness, out)


# Subprocess harvest path: the smoke sets the env flag before spawning a
# worker; arming at import means the worker needs no code to opt in.
if contract_witness_enabled():
    arm()
