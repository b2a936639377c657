"""Window command tape: the host encode for the window merge (counterpart
of `redisson_tpu.ingest.tape`).

Every folded delta plane of a window, mixed ``hll_add`` / ``bloom_add`` /
``bitset_set`` over many targets, is laid out as one command tape that
`ops.window_kernel.window_merge` retires in one launch:

* ``table`` int32 ``[T2, 5]``: ``(op_code, target_row, offset, length,
  shard)`` per row. ``target_row`` is the HLL bank row of HLL entries (-1
  for store-backed ones, whose row -> object map the host keeps);
  ``offset`` the row's byte offset into the flattened wire; ``length`` the
  valid cell count; ``shard`` the logical cluster shard the entry belongs
  to (0 outside the mesh data plane): the shard axis that lets one launch
  retire a multi-shard window while per-shard attribution survives into
  the tape.
* ``wire`` uint8 ``[T2, W]``: one operand row per entry, register bytes for
  HLL entries, packed big-endian bits for Bloom / BitSet. Sparse planes are
  made dense again here.

Rows are ordered HLL first, so the bank rows gather and scatter as one
prefix; ``T2`` and ``W`` are powers of two, padded with ``OP_PAD`` rows
(length 0, the identity of the merge).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from redisson_tpu_torch.ingest.delta import DeltaPlane
from redisson_tpu_torch.ops.window_kernel import (
    COL_SHARD, OP_BITSET, OP_BLOOM, OP_HLL, OP_PAD, TABLE_COLS)

_OP_OF = {"hll_add": OP_HLL, "bloom_add": OP_BLOOM, "bitset_set": OP_BITSET}

#: Minimum cell-lane count (engine.MIN_BUCKET): tape rows share the delta
#: path's power-of-two size classes.
MIN_LANES = 1 << 10

#: Minimum wire width in bytes.
MIN_WIRE = 128


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclass
class WindowTape:
    """One encoded window, ready for a single launch."""

    table: np.ndarray               # int32 [T2, TABLE_COLS]
    wire: np.ndarray                # uint8 [T2, W]
    lanes: int                      # padded cell-lane count L
    n_hll: int                      # HLL entries (rows 0..n_hll-1)
    hll_rows: np.ndarray            # int32 [n_hll] bank rows
    planes: List[DeltaPlane] = field(default_factory=list)  # row order
    link_bytes: int = 0             # table + wire bytes shipped

    @property
    def n_entries(self) -> int:
        return len(self.planes)

    @property
    def n_shards(self) -> int:
        """Distinct logical shards this window retires (>= 1)."""
        if not self.planes:
            return 1
        return len(set(self.table[: len(self.planes), COL_SHARD].tolist()))


def _wire_row(p: DeltaPlane) -> np.ndarray:
    """A plane's operand row: the folded byte plane, made dense again from
    the sparse pairs where needed (their indices are unique, from
    flatnonzero, so a plain assignment inverts the encode)."""
    if not p.sparse:
        return p.dense
    seg = np.zeros((p.plane_bytes,), np.uint8)
    if p.nnz:
        seg[p.idx[: p.nnz]] = p.val[: p.nnz]
    return seg


def encode_window(planes: List[DeltaPlane],
                  hll_row: Callable[[str], int],
                  shard_of: Optional[Callable[[str], int]] = None
                  ) -> WindowTape:
    """Encode a window's folded planes into one command tape.

    ``hll_row`` maps an hll_add target to its bank row; ``shard_of`` maps a
    target to its logical cluster shard for the shard column (mesh data
    plane; None stamps shard 0 everywhere). Raises ValueError on a kind
    the tape has no op code for.
    """
    ordered = ([p for p in planes if p.kind == "hll_add"]
               + [p for p in planes if p.kind != "hll_add"])
    n = len(ordered)
    n_hll = sum(1 for p in ordered if p.kind == "hll_add")
    t2 = _pow2(max(n, 1))
    lanes = max(MIN_LANES, _pow2(max((p.cells for p in ordered), default=1)))
    width = max(MIN_WIRE,
                _pow2(max((p.plane_bytes for p in ordered), default=1)))
    table = np.zeros((t2, TABLE_COLS), np.int32)
    table[:, 0] = OP_PAD
    table[:, 1] = -1
    wire = np.zeros((t2, width), np.uint8)
    rows = np.zeros((n_hll,), np.int32)
    for i, p in enumerate(ordered):
        try:
            op = _OP_OF[p.kind]
        except KeyError:
            raise ValueError(f"tape: no op code for kind {p.kind!r}")
        row = hll_row(p.target) if op == OP_HLL else -1
        if op == OP_HLL:
            rows[i] = row
        shard = int(shard_of(p.target)) if shard_of is not None else 0
        table[i] = (op, row, i * width, p.cells, shard)
        wire[i, : p.plane_bytes] = _wire_row(p)
    return WindowTape(
        table=table, wire=wire, lanes=lanes, n_hll=n_hll, hll_rows=rows,
        planes=ordered, link_bytes=int(table.nbytes) + int(wire.nbytes))
