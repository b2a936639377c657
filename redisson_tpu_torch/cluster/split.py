"""Per-owner batch splitting (counterpart of `redisson_tpu.cluster.split`).

Reference: `CommandBatchService.java:163-174` — the collect phase appends
indexed commands per slot/entry, execute sends one pipeline per owner and
reassembles replies by global index. `split_by_owner` is that grouping,
kept dependency-free so the router (`cluster/router.py`) and any socket
client use the identical splitter.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Sequence, Tuple, TypeVar

from redisson_tpu_torch.ops.crc16 import MAX_SLOT

__all__ = ["MAX_SLOT", "contiguous_assignment", "slot_ranges",
           "split_by_owner"]

T = TypeVar("T")


def split_by_owner(items: Sequence[T],
                   owner_of: Callable[[int, T], Hashable],
                   ) -> Dict[Hashable, List[int]]:
    """Group item indices by owner, preserving submission order within
    each group (per-owner FIFO order == list order — the property the
    executor's per-target queues and redis pipelines both rely on).
    Returns {owner: [global indices]}; reassemble replies by walking each
    group's indices."""
    groups: Dict[Hashable, List[int]] = {}
    for i, item in enumerate(items):
        groups.setdefault(owner_of(i, item), []).append(i)
    return groups


def slot_ranges(table: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Collapse a slot->owner table into contiguous (start, end, owner)
    ranges — the CLUSTER SLOTS reply shape (end inclusive)."""
    out: List[Tuple[int, int, int]] = []
    if not table:
        return out
    start, owner = 0, table[0]
    for slot in range(1, len(table)):
        if table[slot] != owner:
            out.append((start, slot - 1, owner))
            start, owner = slot, table[slot]
    out.append((start, len(table) - 1, owner))
    return out


def contiguous_assignment(num_slots: int, num_shards: int) -> List[int]:
    """The initial slot table: contiguous, near-even ranges (redis-cli's
    `--cluster create` does the same arithmetic)."""
    if num_shards <= 0:
        raise ValueError("cluster needs at least one shard")
    base, extra = divmod(num_slots, num_shards)
    table: List[int] = []
    for shard in range(num_shards):
        table.extend([shard] * (base + (1 if shard < extra else 0)))
    return table
