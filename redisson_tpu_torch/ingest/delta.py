"""Host-side delta folding for the delta ingest path (counterpart of
`redisson_tpu.ingest.delta`).

The three foldable write kinds are pre-aggregated on the host into one
byte plane per target, and the plane crosses the link instead of the key
batch:

  * ``hll_add``    -> a dense 16384-byte register-max image (one uint8 per
    register) from the host fold library's ``hll_fold_*``;
  * ``bloom_add``  -> a packed big-endian bit plane ((m+7)//8 bytes) from
    ``bloom_fold_*`` with ``want_newly=False``;
  * ``bitset_set`` -> the same packed layout, folded in numpy
    (``np.bitwise_or.at`` over byte index / bit mask).

When few bytes of a plane are set it is re-encoded sparsely as
``(idx int32, val uint8)`` pairs (5 B each), padded to a power of two with
``(0, 0)``, an identity under the max/or merge.

The device half is `engine.delta_merge_stack` over the `delta_merge`
kernel: every plane of a window becomes a row of one ``[T, L]`` uint8
stack, merged in one elementwise max (OR is max on 0/1 cells, and HLL
registers fit uint8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from redisson_tpu_torch import native

# Sparse entry = int32 byte index + uint8 byte value.
SPARSE_ENTRY_BYTES = 5

# HLL geometry (ops/hll.py M): a register image is always this many bytes.
HLL_M = 16384


@dataclass
class DeltaPlane:
    """One target's folded delta, in the form it crosses the link.

    ``dense`` XOR (``idx``, ``val``) is set. ``packed`` planes are
    big-endian bit maps (bit i -> byte i>>3, mask 0x80>>(i&7), numpy
    packbits order) that the device unpacks to one uint8 cell per bit;
    HLL planes are already in the cell domain (one byte per register).
    """

    kind: str                       # hll_add | bloom_add | bitset_set
    target: str
    plane_bytes: int                # dense byte-plane length
    cells: int                      # unpacked cell count on the device
    packed: bool                    # True: bit-packed, the device unpacks
    dense: Optional[np.ndarray] = None   # uint8 [plane_bytes]
    idx: Optional[np.ndarray] = None     # int32 [nnz padded] byte indices
    val: Optional[np.ndarray] = None     # uint8 [nnz padded] byte values
    nnz: int = 0
    nkeys: int = 0
    raw_bytes: int = 0              # what the raw-key path would have shipped
    link_bytes: int = 0             # what the delta path ships

    @property
    def sparse(self) -> bool:
        return self.dense is None


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def encode(kind: str, target: str, plane: np.ndarray, *, cells: int,
           packed: bool, nkeys: int, raw_bytes: int) -> DeltaPlane:
    """Pick the dense or sparse encoding of a folded byte plane: sparse when
    ``nnz * 5 < plane_bytes``, its arrays padded to a power of two with
    (idx=0, val=0) entries, a no-op under the max merge."""
    plane_bytes = int(plane.shape[0])
    nnz = int(np.count_nonzero(plane))
    if nnz * SPARSE_ENTRY_BYTES < plane_bytes:
        idx = np.flatnonzero(plane).astype(np.int32)
        val = plane[idx]
        b = _pow2(max(nnz, 1))
        if b != nnz:
            pidx = np.zeros((b,), np.int32)
            pval = np.zeros((b,), np.uint8)
            pidx[:nnz] = idx
            pval[:nnz] = val
            idx, val = pidx, pval
        return DeltaPlane(
            kind=kind, target=target, plane_bytes=plane_bytes, cells=cells,
            packed=packed, idx=idx, val=val, nnz=nnz, nkeys=nkeys,
            raw_bytes=raw_bytes, link_bytes=b * SPARSE_ENTRY_BYTES)
    return DeltaPlane(
        kind=kind, target=target, plane_bytes=plane_bytes, cells=cells,
        packed=packed, dense=plane, nnz=nnz, nkeys=nkeys,
        raw_bytes=raw_bytes, link_bytes=plane_bytes)


# ---------------------------------------------------------------------------
# Per-kind host folds: each takes the payloads of every op on one object in
# the window and returns one byte plane.
# ---------------------------------------------------------------------------


def _u64_keys(payload) -> np.ndarray:
    """An hll/bloom u64 payload as a uint64 [n] key vector."""
    if "packed" in payload:
        p = np.ascontiguousarray(payload["packed"], dtype=np.uint32)
        return p.view(np.uint64).reshape(-1)
    hi = np.asarray(payload["hi"], np.uint64)
    lo = np.asarray(payload["lo"], np.uint64)
    return (hi << np.uint64(32)) | lo


def payload_nkeys(kind: str, payload) -> int:
    if kind == "bitset_set":
        return int(np.asarray(payload["idx"]).shape[0])
    if "packed" in payload:
        return int(payload["packed"].shape[0])
    if "data" in payload:
        return int(payload["data"].shape[0])
    return int(payload["hi"].shape[0])


def payload_raw_bytes(kind: str, payload) -> int:
    """Bytes the raw-key path would push over the link for this payload."""
    if kind == "bitset_set":
        idx = np.asarray(payload["idx"])
        return idx.shape[0] * 4  # uint32 index per key after padding
    if "packed" in payload:
        return int(payload["packed"].nbytes)
    if "data" in payload:
        return int(payload["data"].nbytes) + int(payload["lengths"].nbytes)
    return int(payload["hi"].nbytes) + int(payload["lo"].nbytes)


def foldable(kind: str, payload) -> bool:
    """Can this op's payload be folded on the host? Device-resident payloads
    (``device_packed``) never; hll/bloom payloads need the host fold
    library; SETBIT index payloads fold in numpy. A remote site's
    ``geo_merge`` plane arrives folded (dense ``plane`` bytes or a sparse
    ``idx`` / ``val`` pair): nothing to hash, so it needs no library."""
    if payload is None or not isinstance(payload, dict):
        return False
    if kind == "geo_merge":
        return "plane" in payload or "idx" in payload
    if kind == "bitset_set":
        return "idx" in payload
    if "device_packed" in payload:
        return False
    if not native.available():
        return False
    if kind == "hll_add":
        return ("packed" in payload or ("hi" in payload and "lo" in payload)
                or ("data" in payload and "lengths" in payload))
    if kind == "bloom_add":
        return ("packed" in payload
                or ("data" in payload and "lengths" in payload))
    return False


def fold_hll(payloads: List[dict], seed: int = 0) -> np.ndarray:
    """Fold hll_add payloads into one 16384-byte register-max image."""
    regs = np.zeros((HLL_M,), np.uint8)
    for p in payloads:
        if "data" in p:
            native.hll_fold_rows(p["data"], p["lengths"], regs, seed)
        else:
            native.hll_fold_u64(_u64_keys(p), regs, seed)
    return regs


def fold_bloom(payloads: List[dict], k: int, m: int, seed: int = 0) -> np.ndarray:
    """Fold bloom_add payloads into one packed (m+7)//8-byte bit plane."""
    bits = np.zeros(((m + 7) >> 3,), np.uint8)
    for p in payloads:
        if "data" in p:
            native.bloom_fold_rows(p["data"], p["lengths"], bits, k, m, seed,
                                   want_newly=False)
        else:
            native.bloom_fold_u64(_u64_keys(p), bits, k, m, seed,
                                  want_newly=False)
    return bits


def fold_bitset(payloads: List[dict], nbits: int) -> np.ndarray:
    """Fold bitset_set index payloads into one packed bit plane."""
    plane = np.zeros(((nbits + 7) >> 3,), np.uint8)
    for p in payloads:
        idx = np.asarray(p["idx"], np.int64)
        if idx.size:
            np.bitwise_or.at(
                plane, idx >> 3, (0x80 >> (idx & 7)).astype(np.uint8))
    return plane
