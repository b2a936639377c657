"""PersistenceManager — wires journal, snapshotter and recovery to a client
(counterpart of `redisson_tpu.persist.manager`).

Lifecycle (client.__init__ calls start() once the executor exists, before
user traffic):

  1. open the Journal (torn-tail truncation happens here, so replay only
     ever sees the committed prefix);
  2. auto-recover when the directory holds prior state — snapshot load +
     journal-suffix replay through the executor, with the journal hook
     still DETACHED so replayed ops don't re-journal;
  3. attach the journal to the executor (write-ahead hook at the dispatch
     commit point) — journaling resumes at the recovered seq;
  4. start the background snapshotter.

start() also works on a live client created without persistence: the
replica tier's failover attaches a journal (`start_seq` = the promotion
watermark, so the fresh journal continues the old primary's numbering) to
the promoted replica's client after it has served traffic.

Shutdown is split to match the client's teardown ordering: the snapshotter
stops before the executor drains (stop_background), the journal closes
after it (close) — drained ops still journal, and the final close fsyncs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from redisson_tpu_torch.persist.journal import Journal
from redisson_tpu_torch.persist.recover import recover
from redisson_tpu_torch.persist.snapshotter import Snapshotter, find_snapshots


class PersistenceManager:
    def __init__(self, client, cfg, start_seq: int = 0):
        self._client = client
        self.cfg = cfg
        # Seq numbering floor for a FRESH journal dir (promoted-replica
        # failover continues the old primary's global numbering so the
        # surviving fleet can partial-resync); 0 for normal startups.
        self._start_seq = start_seq
        self.journal: Optional[Journal] = None
        self.snapshotter: Optional[Snapshotter] = None
        self.last_recovery: Optional[Dict[str, Any]] = None

    def start(self) -> None:
        cfg = self.cfg
        client = self._client
        os.makedirs(cfg.dir, exist_ok=True)
        group = cfg.group_commit_runs or getattr(client.config, "inflight_runs", 2)
        self.journal = Journal(
            cfg.dir, fsync=cfg.fsync, fsync_interval_s=cfg.fsync_interval_s,
            group_commit_runs=group, segment_max_bytes=cfg.segment_max_bytes,
            start_seq=self._start_seq)
        had_state = self.journal.last_seq > 0 or bool(find_snapshots(cfg.dir))
        if cfg.auto_recover and had_state:
            self.last_recovery = recover(client, cfg.dir)
        client._executor.set_journal(self.journal)
        self.snapshotter = Snapshotter(
            client, self.journal, cfg.dir,
            interval_s=cfg.snapshot_interval_s, keep=cfg.snapshot_keep)
        self.snapshotter.start()
        registry = getattr(client, "metrics", None)
        if registry is not None:
            from redisson_tpu_torch.observability import register_persist

            register_persist(registry, self)

    # -- operations ----------------------------------------------------------

    def snapshot(self) -> str:
        """On-demand BGSAVE: full snapshot + journal truncation."""
        if self.snapshotter is None:
            raise RuntimeError("persistence manager not started")
        return self.snapshotter.snapshot_now()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        if self.snapshotter is not None:
            out["snapshotter"] = self.snapshotter.stats()
        if self.last_recovery is not None:
            out["recovery"] = self.last_recovery
        return out

    # -- teardown (two-phase; see module docstring) --------------------------

    def stop_background(self) -> None:
        if self.snapshotter is not None:
            self.snapshotter.stop()

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
            self.journal = None
