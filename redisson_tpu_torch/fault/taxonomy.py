"""Fault taxonomy: the classification boundary between raw device/IO
exceptions and the framework's recovery machinery (counterpart of
`redisson_tpu.fault.taxonomy`, with the CUDA runtime's messages).

Every seam that completes op futures on an error path (the executor's
dispatch, the backend's completion closures, the persist journal) routes
the exception through `classify()` before `set_exception`, so the layers
above see a *decision*, not a raw traceback:

  RetryableFault      re-running the op is safe: the failure happened
                      before any observable state was committed (staging
                      transfer, journal fsync, an allocation that ran out
                      of device memory before the run committed).
                      Subclasses `serve.errors.RetryableError`, so a retry
                      loop keyed on that class fires unmodified.
  StateUncertainFault the run may or may not have committed: a kernel
                      launch that died mid-flight, a wedged run tripped
                      by the watchdog. NOT retryable blindly (a replay
                      could double-apply); the rebuild path re-derives
                      the targets from host truth instead.
  DeviceLostFault     the card's context is gone and its HBM contents with
                      it. A StateUncertainFault plus a signal that rebuild
                      must re-materialize whole planes.
  FatalFault          misconfiguration or a broken invariant; retrying
                      or rebuilding cannot help.

What a CUDA error does to the context decides its class:

  * sticky errors (an illegal memory access, an unspecified launch
    failure, a device-side assert, an uncorrectable ECC error, a card
    that fell off the bus, a launch timeout, a misaligned address, an
    illegal instruction) leave the context unusable for the rest of the
    process -> DeviceLostFault. Nothing in this process can re-apply
    state on that context, so a rebuild after one fails and its targets
    degrade; the recovery is a restart with `PersistConfig.auto_recover`;
  * `torch.cuda.OutOfMemoryError` ("CUDA out of memory") is not sticky ->
    transient, under the seam rule below (matched by type before any
    message);
  * a card the program cannot use at all (no kernel image for it, a
    driver too old, an invalid device ordinal, the port's own kernel
    build failing) -> FatalFault.

The JAX package's XLA/TPU message tables stay beside the CUDA ones: fault
plans and persisted fault records name them.

Semantic/application errors (KeyError, WrongTypeError, ValueError from
payload validation...) pass through `classify()` UNCHANGED — they are
results, not faults, and must reach the caller as-is.
"""

from __future__ import annotations

import re
import threading
from concurrent.futures import CancelledError
from functools import lru_cache
from typing import Dict, Optional

import torch

from redisson_tpu_torch.serve.errors import RetryableError


class Fault(Exception):
    """Base of the taxonomy. `seam` records where the fault surfaced
    (one of inject.SEAMS, or "watchdog"/"classify" for derived faults);
    `cause` keeps the original exception when classify() wrapped one."""

    def __init__(self, message: str, seam: str = "",
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.seam = seam
        self.cause = cause


class RetryableFault(Fault, RetryableError):
    """Failure before the commit point: re-dispatching the op is safe."""


class StateUncertainFault(Fault):
    """The run may have partially committed; blind replay is unsafe.
    Recovery is the rebuild path (re-materialize from host truth)."""


class DeviceLostFault(StateUncertainFault):
    """The device (or a pod slice) and its HBM contents are gone."""


class FatalFault(Fault):
    """Unrecoverable: configuration or invariant breakage."""


class TargetQuarantinedError(RetryableFault):
    """Write rejected: the target is quarantined while its HBM planes
    rebuild from host truth. Retryable — the serve layer's backoff
    normally outlives the rebuild, so a retried write lands after the
    planes are back (the reference's reconnect-then-resend behavior)."""


class TargetDegradedError(Fault):
    """Write rejected permanently: rebuild failed and the target is
    degraded to read-only-from-snapshot. NOT retryable — only operator
    action (restart / restore) clears degradation."""


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

# Seams where no observable state has committed yet when they fail: a
# staging H2D copy, the write-ahead fsync, a snapshot write, admission.
# Failures here are retryable; the same message pattern AFTER dispatch
# (d2h_complete, mesh_collective) means the run itself died -> uncertain.
_PRECOMMIT_SEAMS = frozenset({
    "stage_h2d", "kernel_launch", "journal_fsync", "snapshot_io",
})

# Message fragments (lowercased) -> taxonomy class, checked in order:
# device-loss first (most specific), then fatal invariants, then the
# transient/capacity family. Each table holds the CUDA runtime's messages
# and the XLA/TPU ones of the JAX package.
_DEVICE_LOST = (
    # CUDA sticky errors: the context is unusable for the rest of the process
    "an illegal memory access was encountered", "unspecified launch failure",
    "device-side assert triggered", "uncorrectable ecc error",
    "gpu has fallen off the bus", "the launch timed out",
    "misaligned address", "illegal instruction",
    # XLA / TPU
    "device lost", "device is lost", "data_loss", "device halted",
    "chip reboot", "hardware failure", "device failure",
    "slice health", "missing device",
)
_FATAL = (
    # CUDA: a card this build cannot use, and the port's kernel build
    "no kernel image is available", "cuda driver version is insufficient",
    "invalid device ordinal", "cuda kernel build failed", "nvcc not found",
    # XLA / TPU
    "invalid_argument", "failed_precondition", "unimplemented",
    "not_found: no tpu", "permission_denied",
)
_TRANSIENT = (
    "cuda out of memory",
    "resource_exhausted", "out of memory", "oom", "unavailable",
    "deadline_exceeded", "preempted", "preemption", "aborted", "cancelled",
    "transfer", "connection reset", "temporarily",
)

_LOCK = threading.Lock()
_STATS: Dict[str, int] = {
    "classified": 0,       # exceptions mapped INTO the taxonomy
    "retryable": 0,
    "state_uncertain": 0,  # includes device_lost
    "device_lost": 0,
    "fatal": 0,
    "passthrough": 0,      # semantic errors returned unchanged
    "watchdog_trips": 0,   # bumped by watchdog.py
}


def _count(key: str) -> None:
    with _LOCK:
        _STATS[key] += 1


def stats() -> Dict[str, int]:
    """Snapshot of module-wide classification counters (fault.* gauges)."""
    with _LOCK:
        return dict(_STATS)


def _reset_stats() -> None:
    """Test hook."""
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


@lru_cache(maxsize=64)
def _fragment_re(fragment: str):
    # Word-boundary anchored: "oom" must match "ran oom" / "OOM: ..." but
    # never the inside of "bloom"; multi-word fragments keep their spaces.
    return re.compile(r"(?<![a-z0-9])" + re.escape(fragment)
                      + r"(?![a-z0-9])")


def _match(text: str, fragments) -> bool:
    return any(_fragment_re(f).search(text) for f in fragments)


def classify(exc: BaseException, seam: str = "") -> BaseException:
    """Map a raw exception into the taxonomy; the caller sets the RESULT
    on the op future (never the raw exc).

    Already-classified faults and semantic errors pass through unchanged.
    Infrastructure errors (CUDA and XLA runtime errors, OSError at IO
    seams) wrap
    into the taxonomy keyed on message pattern + seam position: the same
    "UNAVAILABLE" before dispatch is retryable, after dispatch it means
    the run's effects are unknown.
    """
    if isinstance(exc, (Fault, CancelledError)):
        return exc
    precommit = seam in _PRECOMMIT_SEAMS
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        # Typed before any message: the allocation failed, nothing was
        # written, and the context stays usable.
        return _transient(exc, seam, precommit)
    tname = type(exc).__name__
    text = f"{tname}: {exc}".lower()
    infra = (
        "xlaruntimeerror" in tname.lower()
        or isinstance(exc, (OSError, MemoryError, RuntimeError))
    )
    if not infra and not _match(text, _DEVICE_LOST) \
            and not _match(text, _TRANSIENT) and not _match(text, _FATAL):
        # Semantic/application error (KeyError, WrongTypeError, payload
        # ValueError...): a result, not a fault.
        _count("passthrough")
        return exc
    if _match(text, _DEVICE_LOST):
        _count("classified")
        _count("state_uncertain")
        _count("device_lost")
        return DeviceLostFault(
            f"device lost at {seam or 'unknown seam'}: {exc}",
            seam=seam, cause=exc)
    if _match(text, _FATAL):
        _count("classified")
        _count("fatal")
        return FatalFault(
            f"fatal fault at {seam or 'unknown seam'}: {exc}",
            seam=seam, cause=exc)
    if _match(text, _TRANSIENT) or isinstance(exc, (OSError, MemoryError)):
        return _transient(exc, seam, precommit)
    # A RuntimeError that matches no infrastructure pattern: almost always
    # application logic (shape mismatch, invariant message). Pass through.
    _count("passthrough")
    return exc


def _transient(exc: BaseException, seam: str, precommit: bool) -> Fault:
    """The transient family: retryable before the commit point, uncertain
    after it."""
    _count("classified")
    if precommit:
        _count("retryable")
        return RetryableFault(
            f"transient fault at {seam or 'unknown seam'} "
            f"(pre-commit, safe to retry): {exc}",
            seam=seam, cause=exc)
    _count("state_uncertain")
    return StateUncertainFault(
        f"transient fault at {seam or 'unknown seam'} after dispatch "
        f"(commit state unknown): {exc}",
        seam=seam, cause=exc)
