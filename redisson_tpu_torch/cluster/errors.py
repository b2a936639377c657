"""Cluster redirect / routing errors — the MOVED/ASK/CROSSSLOT family
(counterpart of `redisson_tpu.cluster.errors`).

Reference: redis cluster replies `-MOVED <slot> <addr>` when a key's slot
permanently lives elsewhere and `-ASK <slot> <addr>` during a migration
window; Redisson turns both into re-routes instead of failures
(`RedisClusterDownException` handling in `ClusterConnectionManager.java`,
redirect loop in `CommandAsyncService`). A shard guard raises
`SlotMovedError` and the router's retry path re-resolves the owner and
resubmits; the replica router re-serves a replica read its guard bounced
from the primary.

`render_redirect` gives a redirect's wire frame, for the RESP front-end.
"""

from __future__ import annotations

from typing import Optional


class SlotMovedError(Exception):
    """The addressed slot is not (or no longer) owned by the shard that
    received the op — the `-MOVED` analogue. `owner_hint` carries the new
    owner's shard id when the rejecting side knows it (post-flip)."""

    def __init__(self, slot: int, target: str = "",
                 owner_hint: Optional[int] = None):
        self.slot = int(slot)
        self.target = target
        self.owner_hint = owner_hint
        hint = f" -> shard {owner_hint}" if owner_hint is not None else ""
        super().__init__(f"MOVED slot {slot} ('{target}'){hint}")


class SlotAskError(SlotMovedError):
    """The slot is mid-cutover — the `-ASK` analogue: retry against the
    migration target for this one op, the table flip lands momentarily."""

    def __init__(self, slot: int, target: str = "",
                 owner_hint: Optional[int] = None):
        super().__init__(slot, target, owner_hint)
        self.args = (f"ASK slot {slot} ('{target}')",)


class ClusterCrossSlotError(Exception):
    """A multi-key op references keys on different shards — the
    `-CROSSSLOT` analogue. Hashtags (`{tag}`) co-locate keys on purpose;
    PFMERGE and MGET/MSET are fanned out by the router instead."""


def render_redirect(exc: SlotMovedError, addr: str) -> bytes:
    """Render a redirect error as its real wire frame: ``-ASK <slot>
    <host:port>`` for the cutover window, ``-MOVED`` otherwise. `addr` is
    the wire address of the destination shard (the guard only knows shard
    ids; the wire tier owns the id -> host:port map)."""
    from redisson_tpu_torch.wire import proto  # late: wire imports this module

    if isinstance(exc, SlotAskError):
        return proto.ask(exc.slot, addr)
    return proto.moved(exc.slot, addr)
