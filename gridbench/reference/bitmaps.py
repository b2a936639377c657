"""The plain reference of a bitmap rollup: BITOP OR over a window of daily
bitmaps, and BITCOUNT of the result, while logins keep setting bits in
the newest day.

A day is the set of ids the benchmark generated for it. The union of the
window's days, as cells, is the OR; the number of ids in it is the count.
After k login batches the union holds the first k batches too.
Plain PyTorch on whatever device it is given; it imports nothing of the
program and takes nothing the program made.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: ids scattered per step (bounds the index copies on the device)
CHUNK = 1 << 24


def union_cells(days: Sequence[np.ndarray], nbits: int,
                device: torch.device) -> torch.Tensor:
    """[nbits] uint8 cells, 1 where some day of `days` holds the id."""
    cells = torch.zeros((nbits,), dtype=torch.uint8, device=device)
    for ids in days:
        for s in range(0, ids.shape[0], CHUNK):
            part = torch.from_numpy(ids[s:s + CHUNK]).to(device)
            cells[part] = 1
    return cells


def add(cells: torch.Tensor, ids: np.ndarray) -> int:
    """Set `ids` in `cells` in place; how many of them were not set."""
    part = torch.unique(torch.from_numpy(np.ascontiguousarray(ids)).to(cells.device))
    new = int((cells[part] == 0).sum(dtype=torch.int64))
    cells[part] = 1
    return new


def prefix_counts(cells: torch.Tensor, batches: Sequence[np.ndarray]) -> np.ndarray:
    """[len(batches) + 1] counts: of `cells`, then after each batch is set
    in turn. Leaves `cells` holding every batch."""
    out = np.empty((len(batches) + 1,), np.int64)
    out[0] = count(cells)
    for k, ids in enumerate(batches):
        out[k + 1] = out[k] + add(cells, ids)
    return out


def count(cells: torch.Tensor) -> int:
    """BITCOUNT, exact in 64 bits."""
    return int(cells.sum(dtype=torch.int64))


def cells_differing(ref: torch.Tensor, got: np.ndarray) -> int:
    """How many cells of the program's bitmap `got` (host uint8) differ
    from the reference's; cells past either end count as 0."""
    n = min(ref.shape[0], got.shape[0])
    diff = 0
    for s in range(0, n, CHUNK * 8):
        e = min(n, s + CHUNK * 8)
        part = torch.from_numpy(np.ascontiguousarray(got[s:e])).to(ref.device)
        diff += int((part != ref[s:e]).sum(dtype=torch.int64))
    diff += int(np.count_nonzero(got[n:])) if got.shape[0] > n else 0
    diff += int(ref[n:].sum(dtype=torch.int64)) if ref.shape[0] > n else 0
    return diff
