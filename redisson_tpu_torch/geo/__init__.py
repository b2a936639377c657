"""Active-active geo-replication: CRDT site merge + anti-entropy (a copy of
`redisson_tpu.geo`).

N independent engine stacks ("sites") each accept local writes and
converge asynchronously. There is no cross-site consensus and no
leader: the persist journal IS the replication transport — each site's
``SiteLink`` (link.py) tails its own journal and ships folded **delta
planes** to every peer, and the receiver applies them through the same
stacked ``delta_merge`` kernel (``csrc/delta_merge.cu``) local ingest
uses, so one batched semilattice max per pipeline window absorbs a whole
remote batch regardless of how many origin ops it folds.

Convergence contract
--------------------
Two sites that have delivered the same set of messages hold
**bit-identical** sketch state. The guarantee splits by op class:

* **Semilattice writes** (PFADD / bloom add / SETBIT-to-1) commute:
  register max and bit OR are joins, so delivery order, duplication
  (anti-entropy re-ship), and folding granularity are all invisible.
  These converge with no arbitration and can never lose data.

* **Destructive writes** (DEL, FLUSHALL, RENAME, SETBIT-to-0) are NOT
  joins. They are arbitrated **last-writer-wins** on the total order of
  stamps ``(origin_journal_seq, site_id)`` (applier.py): a destructive
  op erases exactly the writes with smaller stamps, everywhere. A DEL
  racing a newer merge is *suppressed* at the site holding the newer
  write, which re-ships the key's full state so the deleting site
  resurrects it — the race resolves add-wins, deterministically, at
  every site. FLUSHALL resolves per key by the same rule: receivers
  wipe exactly the keys whose newest write predates the flush stamp
  and re-ship the survivors, resurrecting them at the flushing site.
  Consequence to document, not hide: a DEL acknowledged at
  site A may be overridden by a concurrent higher-stamped write at
  site B; "acked" for destructive ops means *locally durable*, not
  *globally final* until the sites have exchanged vectors.

* **Non-replicated kinds** (bitset NOT/AND/rotate, structure-tier ops,
  hll_merge, …) stay site-local; geo replicates the sketch-tier write
  kinds in ``SHIP_KINDS`` only.

Anti-entropy (manager.py) closes the loop: links rewind to the peer's
version-vector cursor after restarts, a compacted-away journal range
triggers full-state snapshot repair, and the LWW maps persist in a
``geo_state.json`` sidecar so arbitration survives a site crash.

Reads are always local and expose per-site staleness via
``client.info()['replication']`` (per-peer vector + link lag).
"""

from redisson_tpu_torch.geo.applier import (
    DESTRUCTIVE_KINDS,
    GeoApplier,
    NEG_STAMP,
    SEMILATTICE_KINDS,
    SHIP_KINDS,
    stamp_of,
)
from redisson_tpu_torch.geo.link import SiteLink
from redisson_tpu_torch.geo.manager import GeoManager, connect_sites, converge

__all__ = [
    "DESTRUCTIVE_KINDS",
    "GeoApplier",
    "GeoManager",
    "NEG_STAMP",
    "SEMILATTICE_KINDS",
    "SHIP_KINDS",
    "SiteLink",
    "connect_sites",
    "converge",
    "stamp_of",
]
