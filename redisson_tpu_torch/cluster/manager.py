"""ClusterManager — N shard engine stacks behind one ClusterRouter
(counterpart of `redisson_tpu.cluster.manager`, both data planes).

The engine-owned analogue of `ClusterConnectionManager.java`: builds one
full client per shard (executor + backend + store + optional persist +
optional per-shard serve admission), hands each a contiguous range of the
16384 CRC16 slots, and fronts them with the router. Responsibilities:

  * **bootstrap** — derive per-shard Configs from the parent Config (card
    shards round-robin over the visible cards, so on one H100 every shard
    shares `cuda:0`; `device="cpu"` keeps every shard on the CPU), journal
    a `migrate_adopt` on every shard so the slot table is
    crash-recoverable;
  * **recovery** — on restart the per-shard journals replay their
    ownership history; the manager rebuilds the live slot table from the
    guards instead of re-assuming the initial split;
  * **resharding** — `migrate_slots` / `rebalance` / `add_shard` /
    `remove_shard` drive SlotMigrator runs (live, never write-blocking);
  * **healing** — a `parallel/topology.py` TopologyManager watches shard
    pingers; node_down quarantines the shard and (auto_heal) drains its
    slots onto the survivors — quarantine-then-migrate;
  * **parity** — cluster_info / cluster_slots / cluster_keyslot back the
    client's CLUSTER command facade.

The mesh data plane (`ClusterConfig.data_plane="mesh"`): N logical shards
(`MeshShard`) over ONE shared engine stack whose HLL bank is row-sharded
over a logical mesh of N entries (`parallel/mesh.py`); slot ownership is
one guard holding the whole table, and a migration moves ownership
through the same journaled records plus a device-side bank-row
relocation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Tuple

import torch

from redisson_tpu_torch.cluster.migrator import SlotMigrator
from redisson_tpu_torch.cluster.router import ClusterRouter
from redisson_tpu_torch.cluster.shard import ClusterShard, MeshShard
from redisson_tpu_torch.cluster.split import MAX_SLOT, contiguous_assignment
from redisson_tpu_torch.executor import make_lock
from redisson_tpu_torch.ops.crc16 import key_slot
from redisson_tpu_torch.parallel.topology import TopologyManager


class ClusterManager:
    def __init__(self, config):
        from redisson_tpu_torch.client import RedissonTorch

        cluster = config.cluster
        if cluster is None:
            raise ValueError("Config.cluster section required")
        if config.pod is not None:
            raise ValueError(
                "cluster and pod modes are mutually exclusive: the cluster "
                "tier shards the namespace over full engine stacks, pod "
                "shards one engine over the mesh")
        self.data_plane = getattr(cluster, "data_plane", "stacks") or "stacks"
        self.config = config
        self._lock = make_lock("manager.ClusterManager._lock")
        self.migrations = 0
        self.migration_stats: Dict[str, int] = {}
        self._next_shard_id = 0
        # Mesh data plane: the ONE shared engine stack behind every logical
        # shard (None on the stacks plane).
        self.mesh_client = None

        self.shards: Dict[int, Any] = {}
        if self.data_plane == "mesh":
            self.mesh_client = RedissonTorch.create(self._mesh_config())
            for _ in range(max(1, int(cluster.num_shards))):
                shard_id = self._next_shard_id
                self._next_shard_id += 1
                self.shards[shard_id] = MeshShard(shard_id, self.mesh_client)
        else:
            try:
                for _ in range(max(1, int(cluster.num_shards))):
                    shard_id = self._next_shard_id
                    self._next_shard_id += 1
                    self.shards[shard_id] = ClusterShard(
                        shard_id,
                        RedissonTorch.create(self._shard_config(shard_id)))
            except Exception:
                for shard in self.shards.values():
                    shard.shutdown()
                raise

        table = self._recovered_table()
        self.router = ClusterRouter(self.shards, table,
                                    retry_depth=cluster.redirect_retries,
                                    mesh=self.data_plane == "mesh")
        self._adopt_table(table)

        # Failure plane: one pinger per shard (replaceable for drills /
        # real health checks); node_down => quarantine-then-migrate.
        self.topology = TopologyManager()
        for shard_id in self.shards:
            self.topology.add_node(self._ident(shard_id),
                                   self._default_pinger(shard_id))
        self.topology.add_listener(self._on_topology_event)

    # -- bootstrap ------------------------------------------------------------

    def _shard_config(self, shard_id: int):
        """The shard member's Config: the facade's `cuda` section (the card
        by default) with `device = cuda:<shard_id % cards>` (JAX's
        `device_index = shard_id % ndev`), so on one card every shard
        shares `cuda:0`; a CPU section (`device="cpu"`) stays on the CPU.
        Persistence under <dir>/shard-NN, the shard's replica fleet, and
        the serve / trace / memory / fault sections as JAX's copies them."""
        from redisson_tpu_torch.config import (Config, CudaConfig,
                                               PersistConfig, ReplicaConfig)

        parent = self.config
        cluster = parent.cluster
        shard_cfg = Config(codec=parent.codec,
                           inflight_runs=parent.inflight_runs)
        ccfg = parent.cuda or CudaConfig()
        device = ccfg.device
        if device.startswith("cuda"):
            device = f"cuda:{shard_id % max(1, torch.cuda.device_count())}"
        shard_cfg.cuda = dataclasses.replace(ccfg, device=device)
        if cluster.dir:
            shard_cfg.persist = PersistConfig(
                dir=os.path.join(cluster.dir, f"shard-{shard_id:02d}"),
                fsync=cluster.fsync,
                snapshot_interval_s=0.0)
        if cluster.replicas_per_shard > 0:
            if not cluster.dir:
                raise ValueError(
                    "cluster.replicas_per_shard needs cluster.dir — each "
                    "shard's fleet tails that shard's journal")
            # Per-shard replica fleet (shard-level HA): the shard client
            # wires its own ReplicaManager/ReplicaRouter, so reads route
            # with bounded staleness and a primary loss fails over INSIDE
            # the shard while the rest of the slot map keeps serving — the
            # per-partition slave set of ClusterConnectionManager.java.
            # Config.replicas on the facade acts as the tuning template.
            template = parent.replicas or ReplicaConfig()
            shard_cfg.replicas = dataclasses.replace(
                template, num_replicas=cluster.replicas_per_shard)
        if cluster.shard_serve:
            if parent.serve is None:
                raise ValueError("cluster.shard_serve needs Config.serve")
            shard_cfg.serve = dataclasses.replace(parent.serve)
        if parent.trace is not None:
            shard_cfg.trace = dataclasses.replace(parent.trace)
        if parent.memory is not None:
            shard_cfg.memory = dataclasses.replace(parent.memory)
        if parent.faults is not None:
            shard_cfg.faults = dataclasses.replace(parent.faults)
        # shard_id >= 0 tells the client to install the ownership guard.
        shard_cfg.cluster = dataclasses.replace(cluster, shard_id=shard_id)
        return shard_cfg

    def _mesh_config(self):
        """Config of the mesh plane's ONE shared engine stack: shard_id ==
        -2 makes the client install the MeshOwnershipBackend guard and put
        the bank onto a logical mesh of `num_shards` entries on the `cuda`
        section's device (the card by default). The ingest is pinned, not
        'auto': the tape's window_merge retires a multi-shard window in
        one launch, stamping each entry's shard."""
        from redisson_tpu_torch import native as native_mod
        from redisson_tpu_torch.config import (Config, CudaConfig,
                                               PersistConfig)

        parent = self.config
        cluster = parent.cluster
        cfg = Config(codec=parent.codec, inflight_runs=parent.inflight_runs)
        ccfg = parent.cuda or CudaConfig()
        cfg.cuda = dataclasses.replace(
            ccfg, ingest="tape" if native_mod.available() else "device")
        if cluster.dir:
            cfg.persist = PersistConfig(
                dir=os.path.join(cluster.dir, "mesh"),
                fsync=cluster.fsync,
                snapshot_interval_s=0.0)
        if cluster.replicas_per_shard > 0:
            raise ValueError(
                "data_plane='mesh' does not support replicas_per_shard "
                "yet — the shared stack has one journal, not N")
        if parent.trace is not None:
            cfg.trace = dataclasses.replace(parent.trace)
        if parent.memory is not None:
            cfg.memory = dataclasses.replace(parent.memory)
        cfg.cluster = dataclasses.replace(cluster, shard_id=-2)
        return cfg

    def _recovered_table(self) -> List[int]:
        """The live slot table. Fresh start: contiguous near-even ranges.
        Restart: the per-shard journals already replayed their ownership
        records into the guards — rebuild from those (the initial split may
        be long obsolete). Unowned slots (crash between a source's flip and
        the target's adopt) go to the least-loaded shard; a conflict keeps
        the lowest shard id and flips the others."""
        ids = sorted(self.shards)
        owned_any = any(self.shards[i].guard.owned_slots() is not None
                        for i in ids)
        if not owned_any:
            assign = contiguous_assignment(MAX_SLOT, len(ids))
            return [ids[owner] for owner in assign]
        table = [-1] * MAX_SLOT
        conflicts: Dict[int, List[int]] = {}
        for shard_id in ids:
            owned = self.shards[shard_id].guard.owned_slots() or set()
            for slot in owned:
                if table[slot] < 0:
                    table[slot] = shard_id
                else:
                    conflicts.setdefault(shard_id, []).append(slot)
        for shard_id, slots in conflicts.items():
            self.shards[shard_id].flip(slots)
        counts = {i: sum(1 for s in table if s == i) for i in ids}
        orphans = [s for s in range(MAX_SLOT) if table[s] < 0]
        for slot in orphans:
            shard_id = min(counts, key=counts.get)
            table[slot] = shard_id
            counts[shard_id] += 1
        return table

    def _adopt_table(self, table: List[int]) -> None:
        """Journal every shard's ownership (idempotent: adopt is a union,
        and on a fresh shard it draws the accept-everything -> owned-set
        boundary before any routed traffic arrives)."""
        by_shard: Dict[int, List[int]] = {i: [] for i in self.shards}
        for slot, shard_id in enumerate(table):
            by_shard[shard_id].append(slot)
        for shard_id, slots in by_shard.items():
            self.shards[shard_id].adopt(slots)

    # -- topology healing ------------------------------------------------------

    @staticmethod
    def _ident(shard_id: int) -> str:
        return f"shard-{shard_id}"

    def _default_pinger(self, shard_id: int):
        def ping() -> bool:
            shard = self.shards.get(shard_id)
            return shard is not None and not shard.quarantined
        return ping

    def set_pinger(self, shard_id: int, fn) -> None:
        """Replace a shard's health probe (drills / real checks). The
        TopologyManager polls it; `failed_attempts` consecutive False
        results fire node_down -> quarantine-then-migrate."""
        self.topology.add_node(self._ident(shard_id), fn)

    def _on_topology_event(self, event: str, ident: str) -> None:
        try:
            shard_id = int(ident.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return
        shard = self.shards.get(shard_id)
        if shard is None:
            return
        if event == "node_down":
            shard.quarantined = True
            if self.config.cluster.auto_heal:
                try:
                    self.drain_shard(shard_id)
                except Exception:
                    # Best-effort from a watcher callback: a failed drain
                    # leaves the shard quarantined with its slots intact
                    # (raising would kill the topology scan loop).
                    pass
        elif event == "node_up":
            shard.quarantined = False

    # -- resharding ------------------------------------------------------------

    def migrate_slots(self, slots: Iterable[int], target_shard: int,
                      timeout_s: float = 120.0) -> Dict[str, int]:
        """Live-migrate `slots` to `target_shard` (grouped per current
        owner; slots already on the target are skipped). Writes keep
        flowing throughout — see cluster/migrator.py for the protocol."""
        slots = sorted({int(s) for s in slots})
        if target_shard not in self.shards:
            raise ValueError(f"unknown target shard {target_shard}")
        table = self.router.slot_table()
        by_source: Dict[int, List[int]] = {}
        for slot in slots:
            owner = table[slot]
            if owner != target_shard:
                by_source.setdefault(owner, []).append(slot)
        total: Dict[str, int] = {}
        with self._lock:  # one migration at a time (BGSAVE-style)
            for source_id, group in sorted(by_source.items()):
                if self.data_plane == "mesh":
                    stats = self._mesh_migrate_group(
                        source_id, target_shard, group)
                else:
                    migrator = SlotMigrator(
                        self.router, self.shards[source_id],
                        self.shards[target_shard], group,
                        timeout_s=timeout_s)
                    stats = migrator.run()
                self.migrations += 1
                for k, v in stats.items():
                    total[k] = total.get(k, 0) + v
            # Published under the migration lock: an auto-heal drain on the
            # topology-watcher thread must not interleave its publish with
            # an operator-driven reshard's.
            self.migration_stats = total
        return total

    def _mesh_migrate_group(self, source_id: int, target_shard: int,
                            group: List[int]) -> Dict[str, int]:
        """Mesh-plane slot migration: no snapshot, no journal tailing (the
        state is already shared). What moves is OWNERSHIP, through the same
        journaled begin / flip / adopt records the stacks plane writes (the
        flip in the shared journal is the cutover fence), and BANK ROW
        PLACEMENT, a device-side relocation into the adopting shard's
        preferred row block, run as an executor barrier so it lands at a
        dispatcher consistency cut."""
        source = self.shards[source_id]
        target = self.shards[target_shard]
        slots = set(group)
        # IMPORTING mark first: ops redirected early (between the flip and
        # the router's table update) find the target accepting.
        target.begin_migrate(group, target_shard)
        self.router.begin_cutover(group)
        try:
            source.flip(group)          # the journaled cutover fence
            target.adopt(group)
        finally:
            self.router.commit_cutover(group, target_shard)
        client = self.mesh_client
        backend = client._routing.sketch

        def relocate() -> int:
            names = [n for n in list(backend._alloc.rows)
                     if key_slot(n) in slots]
            return backend.mesh_relocate(names, target_shard)

        moved = int(client._executor.execute_barrier(relocate).result())
        return {"slots": len(group), "keys_moved": moved,
                "bank_rows_relocated": moved}

    def drain_shard(self, shard_id: int) -> int:
        """Move every slot off `shard_id` onto the other non-quarantined
        shards (least-loaded first) — the quarantine-then-migrate step and
        the first half of remove_shard. Returns slots moved."""
        survivors = [i for i, s in self.shards.items()
                     if i != shard_id and not s.quarantined]
        if not survivors:
            raise RuntimeError("no live shard left to drain onto")
        table = self.router.slot_table()
        mine = [s for s in range(MAX_SLOT) if table[s] == shard_id]
        if not mine:
            return 0
        counts = {i: sum(1 for s in table if s == i) for i in survivors}
        share = (len(mine) + len(survivors) - 1) // len(survivors)
        moved = 0
        for start in range(0, len(mine), share):
            target = min(counts, key=counts.get)
            chunk = mine[start:start + share]
            self.migrate_slots(chunk, target)
            counts[target] += len(chunk)
            moved += len(chunk)
        return moved

    def rebalance(self) -> int:
        """Even out slot ownership across non-quarantined shards. Returns
        slots moved. Greedy: repeatedly migrate the most-loaded shard's
        excess to the least-loaded until within one slot of even."""
        live = sorted(i for i, s in self.shards.items() if not s.quarantined)
        if len(live) < 2:
            return 0
        moved = 0
        while True:
            table = self.router.slot_table()
            counts = {i: sum(1 for s in table if s == i) for i in live}
            fat = max(counts, key=counts.get)
            thin = min(counts, key=counts.get)
            excess = (counts[fat] - counts[thin]) // 2
            if excess < 1:
                return moved
            chunk = [s for s in range(MAX_SLOT) if table[s] == fat][:excess]
            self.migrate_slots(chunk, thin)
            moved += len(chunk)

    def add_shard(self) -> int:
        """Bring up a new empty shard (owns no slots until rebalance /
        migrate_slots moves some in). Returns its shard id."""
        from redisson_tpu_torch.client import RedissonTorch

        shard_id = self._next_shard_id
        self._next_shard_id += 1
        if self.data_plane == "mesh":
            shard = MeshShard(shard_id, self.mesh_client)
            # Widen the logical-shard axis of the shared bank's preferred
            # row blocks; rows relocate as slots migrate in.
            sb = self.mesh_client._routing.sketch._sharded_bank
            if sb is not None:
                sb.num_shards = max(sb.num_shards, shard_id + 1)
            guard = self.mesh_client._routing
            guard.num_shards = max(guard.num_shards, shard_id + 1)
        else:
            shard = ClusterShard(
                shard_id, RedissonTorch.create(self._shard_config(shard_id)))
        shard.adopt([])  # closed ownership: reject until slots migrate in
        self.shards[shard_id] = shard
        self.router.add_shard(shard)
        self.topology.add_node(self._ident(shard_id),
                               self._default_pinger(shard_id))
        return shard_id

    def remove_shard(self, shard_id: int) -> int:
        """Drain then retire a shard. Returns slots moved off it."""
        if shard_id not in self.shards:
            raise ValueError(f"unknown shard {shard_id}")
        moved = self.drain_shard(shard_id)
        self.router.remove_shard(shard_id)
        self.topology.remove_node(self._ident(shard_id))
        shard = self.shards.pop(shard_id)
        shard.shutdown()
        return moved

    # -- CLUSTER command parity ------------------------------------------------

    @staticmethod
    def cluster_keyslot(key: str) -> int:
        """CLUSTER KEYSLOT."""
        return key_slot(key)

    def cluster_slots(self) -> List[Tuple[int, int, int, List[dict]]]:
        """CLUSTER SLOTS shape: (start, end_inclusive, shard_id, replicas)
        ranges — `replicas` lists the owning shard's fleet members as
        {id, watermark, lag} dicts, the way redis CLUSTER SLOTS appends
        replica entries after the master per range (empty without
        replicas_per_shard)."""
        out = []
        for start, end, shard_id in self.router.ranges():
            shard = self.shards.get(shard_id)
            entries = shard.replica_entries() if shard is not None else []
            out.append((start, end, shard_id, entries))
        return out

    def failovers(self) -> int:
        """Total per-shard promotions across the cluster."""
        return sum(s.replicas.promotions for s in self.shards.values()
                   if s.replicas is not None)

    def cluster_info(self) -> Dict[str, Any]:
        """CLUSTER INFO analogue (`cluster_state:ok` etc.)."""
        table = self.router.slot_table()
        assigned = sum(1 for s in table if s is not None and s >= 0)
        quarantined = sum(1 for s in self.shards.values() if s.quarantined)
        replicas = sum(len(s.replicas.replicas) for s in self.shards.values()
                       if s.replicas is not None)
        info = {
            "cluster_enabled": 1,
            "cluster_state": "ok" if quarantined == 0 else "degraded",
            "cluster_slots_assigned": assigned,
            # Known nodes counts every engine in the topology — masters
            # plus live fleet members, like redis counts replicas too.
            "cluster_known_nodes": len(self.shards) + replicas,
            "cluster_replicas": replicas,
            "cluster_size": len(self.shards) - quarantined,
            "migrations": self.migrations,
            "failovers": self.failovers(),
            "redirects": self.router.redirects,
            "retries_exhausted": self.router.retries_exhausted,
            "cross_shard_merges": self.router.cross_shard_merges,
            "data_plane": self.data_plane,
        }
        if self.mesh_client is not None:
            counters = self.mesh_client._routing.sketch.counters
            info["collective_merges"] = counters.get("collective_merges", 0)
            info["multi_shard_windows"] = counters.get(
                "multi_shard_windows", 0)
        return info

    def stats(self) -> Dict[str, Any]:
        return {
            "info": self.cluster_info(),
            "shards": {i: s.stats() for i, s in sorted(self.shards.items())},
            "slots": self.cluster_slots(),
            "last_migration": dict(self.migration_stats),
        }

    # -- lifecycle -------------------------------------------------------------

    def shutdown(self) -> None:
        self.topology.shutdown()
        self.router.close()
        for shard in self.shards.values():
            shard.shutdown()      # mesh: per-shard no-op (shared client)
        if self.mesh_client is not None:
            self.mesh_client.shutdown()
            self.mesh_client = None
        self.shards.clear()
