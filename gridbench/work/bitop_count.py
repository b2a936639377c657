"""Least bytes of one rollup query: BITOP over K operands into a
destination, then BITCOUNT of it.

One cell is one byte (the port keeps a bit per uint8 cell). The query has
to read each operand's cells once and write the destination's once; a
BITOP fused with its BITCOUNT needs no second read of the destination, so
the count adds nothing here. Whatever implements the query moves at
least that.
"""

from __future__ import annotations

from typing import Sequence


def least_bytes(operand_cells: Sequence[int], dest_cells: int) -> int:
    return int(sum(operand_cells)) + int(dest_cells)
