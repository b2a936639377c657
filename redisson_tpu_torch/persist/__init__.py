"""persist/ — durability for an engine that OWNS its state in HBM
(counterpart of `redisson_tpu.persist`, same on-disk formats).

  * journal.py     — segmented append-only log of committed mutating ops
                     (the AOF analogue), fsync policies always/everysec/off
                     with group commit sized to the in-flight window.
  * snapshotter.py — snapshots via checkpoint.py, cut by cloning every
                     object on the dispatcher, + journal rotation and
                     truncation (the BGSAVE / AOF-rewrite analogue).
  * recover.py     — newest snapshot + journal-suffix replay through the
                     normal executor/backend op path.

  * follower.py    — warm standby: a second engine that bootstraps from
                     the newest snapshot and tails the journal (file mode
                     across processes, queue mode in process), with
                     promote / retarget and PSYNC-style resync counters;
                     the replica tier builds on it.

`PersistenceManager` (manager.py) wires the pieces to one client.
"""

from redisson_tpu_torch.persist.codec import decode_payload, encode_payload
from redisson_tpu_torch.persist.journal import (
    Journal,
    JournalGap,
    JournalRecord,
    JournalTail,
    iter_records,
    last_seq_in_dir,
)
from redisson_tpu_torch.persist.manager import PersistenceManager
from redisson_tpu_torch.persist.recover import recover
from redisson_tpu_torch.persist.snapshotter import Snapshotter, find_snapshots
from redisson_tpu_torch.persist.follower import JournalFollower

__all__ = [
    "Journal",
    "JournalFollower",
    "JournalGap",
    "JournalRecord",
    "JournalTail",
    "PersistenceManager",
    "Snapshotter",
    "decode_payload",
    "encode_payload",
    "find_snapshots",
    "iter_records",
    "last_seq_in_dir",
    "recover",
]
