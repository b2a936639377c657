"""The window merge: one launch retires a whole encoded window (counterpart
of `redisson_tpu.ops.window_kernel`).

The host encodes every folded delta plane of a window, mixed hll_add /
bloom_add / bitset_set over many targets, into one command tape
(`ingest/tape.py`):

* ``table`` int32 ``[T, TABLE_COLS]``, rows ``(op_code, target_row,
  offset, length, shard)``. ``op_code`` picks the merge of the row
  (``OP_HLL``: max of dense uint8 registers; ``OP_BLOOM`` / ``OP_BITSET``:
  OR of a packed big-endian bit plane); ``length`` is the row's valid cell
  count; ``target_row``, ``offset`` and ``shard`` ride along for the host.
  The merge reads ``op_code`` and ``length`` only: row t's operand is wire
  row t, whatever ``offset`` says.
* ``wire`` uint8 ``[T, W]``: one operand row per entry, register bytes for
  HLL rows, packed bits for the others.
* ``old`` uint8 ``[T, L]``: the entries' current state rows, merged in
  place.

`window_merge` launches the hand-written CUDA kernel
(`csrc/window_merge.cu`) on a CUDA tensor, or raises; on a CPU tensor it
runs `window_merge_plain`, the counterpart of JAX's `window_merge_lax`
(bit-identical to the Pallas kernel), which is also what the kernel is
held against on the card.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import kernels as pk

# Tape op codes (table column 0). PAD rows carry length 0 and merge as the
# identity.
OP_PAD = 0
OP_HLL = 1      # dense uint8 register plane, elementwise max
OP_BLOOM = 2    # packed big-endian bit plane, bit-OR
OP_BITSET = 3   # packed big-endian bit plane, bit-OR (old bits read back)

# Table geometry: (op_code, target_row, offset, length, shard).
TABLE_COLS = 5
COL_SHARD = 4

#: op codes whose wire row is already in the cell domain (one byte per
#: cell); every other code is a packed bit plane that the merge unpacks.
DENSE_OPS = (OP_HLL,)

#: kernel launches since the last `reset_launches()`
launches = {"window_merge": 0}


def reset_launches() -> None:
    launches["window_merge"] = 0


def _check(old: torch.Tensor, wire: torch.Tensor, table: torch.Tensor) -> None:
    if old.dim() != 2 or old.dtype != torch.uint8:
        raise ValueError(f"window_merge: old must be [T, L] uint8, got "
                         f"{tuple(old.shape)} {old.dtype}")
    t = old.shape[0]
    if wire.dim() != 2 or wire.dtype != torch.uint8 or wire.shape[0] != t:
        raise ValueError(f"window_merge: wire must be [{t}, W] uint8, got "
                         f"{tuple(wire.shape)} {wire.dtype}")
    if (table.dim() != 2 or table.dtype != torch.int32 or table.shape[0] != t
            or table.shape[1] < 4):
        raise ValueError(f"window_merge: table must be [{t}, >=4] int32, got "
                         f"{tuple(table.shape)} {table.dtype}")


def window_merge_plain(old: torch.Tensor, wire: torch.Tensor,
                       table: torch.Tensor):
    """The plain version: decode every row by its op code, mask cells at or
    past its length, max-merge into `old` in place -> (old, changed [T]
    bool). Wire bytes past the wire's width read as 0."""
    _check(old, wire, table)
    t, lanes = old.shape
    if wire.shape[1] < lanes:
        wire = torch.nn.functional.pad(wire, (0, lanes - wire.shape[1]))
    wire = wire[:, :lanes]
    op = table[:, 0:1]
    length = table[:, 3:4]
    pos = torch.arange(lanes, device=old.device)[None, :]
    sh = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8,
                      device=old.device)
    unpacked = ((wire[:, : lanes // 8, None] >> sh) & 1).reshape(t, lanes)
    delta = torch.where(op == OP_HLL, wire, unpacked)
    delta = torch.where(pos < length, delta, torch.zeros_like(delta))
    merged = torch.maximum(old, delta)
    changed = (merged != old).any(dim=1)
    old.copy_(merged)
    return old, changed


def window_merge(old: torch.Tensor, wire: torch.Tensor, table: torch.Tensor):
    """Retire one tape: merge every row of `wire` into `old` ([T, L] uint8,
    in place) by the table's op codes and lengths -> (old, changed [T]
    bool). On a card this is one foreign call; `changed` is the bool tensor
    allocated here, and the kernel writes every flag. The plain version on
    a CPU tensor."""
    _check(old, wire, table)
    # The HLL window's call is host-bound: each tensor attribute read below
    # costs host time, so each is read once.
    if not old.is_cuda:
        if old.device.type == "cpu":
            return window_merge_plain(old, wire, table)
        raise ValueError(f"window_merge: unsupported device {old.device}")
    t, lanes = old.shape
    width, cols = wire.shape[1], table.shape[1]
    old_ptr, wire_ptr = old.data_ptr(), wire.data_ptr()
    if lanes % 16 or old_ptr % 16 or not old.is_contiguous():
        raise ValueError("window_merge: old must be contiguous and 16-byte "
                         "aligned with L % 16 == 0")
    if wire_ptr % 16 or not wire.is_contiguous():
        wire = wire.clone(memory_format=torch.contiguous_format)
        wire_ptr = wire.data_ptr()
    if not table.is_contiguous():
        table = table.contiguous()
    index = old.get_device()
    changed = torch.empty(t, dtype=torch.bool, device=index)
    if t == 0:
        return old, changed
    rc = pk._kernel("window_merge_u8")(
        old_ptr, wire_ptr, table.data_ptr(), changed.data_ptr(), t, lanes,
        width, cols, index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"window_merge launch failed: CUDA error {rc}")
    launches["window_merge"] += 1
    return old, changed
