"""GeoManager: one site's geo-replication root (a copy of
`redisson_tpu.geo.manager`).

Owns the site identity, the LWW applier, one SiteLink per connected
peer, and the anti-entropy loop. Wired by the client after the replica
fleet (client.py) when ``Config.use_geo()`` is set; peering happens at
runtime — ``connect_sites([c1, c2, ...])`` meshes a set of clients
all-pairs, or ``client.geo.connect(peer_manager)`` adds one direction.

Durability sidecar: the applier's LWW state (vv / lw / floor /
flush_floor) persists as ``geo_state.json`` next to the journal,
atomically (write + os.replace) on the anti-entropy cadence and at
close. After a restart the sidecar seeds the applier and the journal
suffix past the sidecar's seq is re-folded (``GeoApplier.rebuild``), so
arbitration state never trails the replayed engine state.

Remote applies dispatch through the RAW executor waist
(``client._executor``) — geo traffic is internal maintenance like lock
watchdog renewals and durability flushes: it must not be shed or
deadline-expired by the serve layer, and it must bypass replica read
routing (it is all writes).

On a card, every state read this module hands a link thread is a host
numpy array: the `hll_export` / `bits_export` handlers copy the key's
cells off the card once (a pinned readback the completer waits for), so
no CUDA tensor ever reaches a link thread. A Bloom filter's parameters are
read with the `bloom_meta` op, not an export of its cells.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Set

import numpy as np

from redisson_tpu_torch.concurrency import make_lock
from redisson_tpu_torch.geo.applier import NEG_STAMP, GeoApplier
from redisson_tpu_torch.geo.link import SiteLink
from redisson_tpu_torch.ingest import delta as delta_mod
from redisson_tpu_torch.persist.journal import iter_records
from redisson_tpu_torch.store import ObjectType, WrongTypeError

SIDECAR_NAME = "geo_state.json"

GUARDED_BY = {
    "GeoManager.links": "_links_lock",
    "GeoManager._closed": "thread:wiring — set once by close(); the AE "
        "thread observes it via the Event, links via join()",
}


class GeoManager:
    """Per-site replication root (one per client with ``Config.geo``)."""

    def __init__(self, client, cfg):
        self.client = client
        self.cfg = cfg
        journal = client._executor.journal
        if journal is None:
            raise ValueError(
                "Config.geo requires Config.persist with a dir — the "
                "persist journal IS the geo replication transport")
        self._journal = journal
        self.journal_path = journal.path
        self.site_id = cfg.site_id or os.path.basename(
            os.path.dirname(os.path.abspath(journal.path))) or "site"
        self.applier = GeoApplier(self)
        self.links: Dict[str, SiteLink] = {}
        self._links_lock = make_lock("geo.GeoManager._links_lock")
        self._stop = threading.Event()
        self._ae_thread = threading.Thread(
            target=self._ae_loop,
            name=f"redisson-torch-geo-ae-{self.site_id}", daemon=True)
        self._closed = False
        self._load_sidecar()
        journal.add_listener(self._on_records)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._ae_thread.start()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        with self._links_lock:
            links = list(self.links.values())
            self.links.clear()
        for link in links:
            link.close()
        if self._ae_thread.is_alive():
            self._ae_thread.join(timeout=5.0)
        try:
            self._journal.remove_listener(self._on_records)
        except Exception:
            pass
        self._persist_sidecar()

    # -- peering ------------------------------------------------------------

    def connect(self, peer: "GeoManager") -> None:
        """Start shipping this site's journal to ``peer`` (one
        direction; call on both managers — or use connect_sites — for
        active-active)."""
        if peer is self or peer.site_id == self.site_id:
            raise ValueError(
                f"peer site id {peer.site_id!r} collides with this site")
        with self._links_lock:
            old = self.links.get(peer.site_id)
            if old is not None and old.peer is peer:
                return
            link = SiteLink(self, peer)
            self.links[peer.site_id] = link
        if old is not None:
            # Same site id, new manager instance: the peer restarted.
            # Retire the link to its dead predecessor.
            old.close()
        link.start()

    def deliver(self, msgs: List[dict], origin: str, watermark: int) -> int:
        """Entry point peer links call into (the receive half)."""
        return self.applier.apply(msgs, origin, watermark)

    # -- executor facade (applier + links dispatch through these) -----------

    def execute_async(self, target: str, kind: str, payload,
                      nkeys: int = 0):
        return self.client._executor.execute_async(
            target, kind, payload, nkeys=nkeys)

    def monotonic(self) -> float:
        return time.monotonic()

    def journal_last_seq(self) -> int:
        return self._journal.last_seq

    @property
    def seed(self) -> int:
        return int(self.client.sketch.seed)

    def _on_records(self, records) -> None:
        self.applier.note_local(records)

    # -- state reads (ship-time exports, flush key resolution) ---------------

    def local_keys(self) -> Set[str]:
        """Every live sketch-tier key, read under a dispatcher barrier (a
        consistency cut against in-flight writes)."""
        sketch = self.client.sketch
        store = self.client._store

        def cut():
            keys = set(sketch._rows)
            with store._lock:
                keys.update(store._objects)
            return keys

        return self.client._executor.execute_barrier(cut).result()

    def bloom_meta(self, target: str) -> Optional[dict]:
        """A live Bloom filter's parameters (its store meta), else None."""
        try:
            return self.client._executor.execute_sync(
                target, "bloom_meta", None)
        except (WrongTypeError, RuntimeError):
            return None  # absent (uninitialized) or not a Bloom filter

    def _export(self, key: str):
        """(otype, cells uint8[n], meta) for a live key, else None."""
        ex = self.client._executor
        try:
            hll = ex.execute_sync(key, "hll_export", None)
        except WrongTypeError:
            hll = None  # store-typed key: fall through to bits_export
        if hll is not None:
            return (ObjectType.HLL, hll[0], {})
        bits = ex.execute_sync(key, "bits_export", None)
        if bits is None:
            return None
        return (bits[0], bits[1], bits[2])

    def export_state(self, key: str) -> Optional[dict]:
        """Full-state message body for ``key`` (merge/replace/repair
        shipping): the key's whole plane, sparse-encoded when that wins.
        ``_link_bytes`` rides along for the sender's byte accounting."""
        exported = self._export(key)
        if exported is None:
            return None
        otype, cells, meta = exported
        if otype == ObjectType.HLL:
            inner, plane = "hll_add", np.asarray(cells, np.uint8)
            n, packed, meta = delta_mod.HLL_M, False, None
        else:
            host = np.asarray(cells, np.uint8)
            plane = np.packbits(host)
            n, packed = int(host.shape[0]), True
            if otype == ObjectType.BLOOM:
                inner = "bloom_add"
                meta = {k: meta[k] for k in
                        ("size", "hash_iterations", "expected_insertions",
                         "false_probability", "blocked") if k in meta}
            else:
                inner = "bitset_set"
                meta = {"max_idx": n - 1,
                        "extent_bits": meta.get("extent_bits", n)}
        dp = delta_mod.encode(inner, key, plane, cells=n, packed=packed,
                              nkeys=0, raw_bytes=0)
        msg: Dict[str, Any] = {
            "inner": inner, "cells": dp.cells,
            "plane_bytes": dp.plane_bytes, "_link_bytes": dp.link_bytes,
        }
        if meta:
            msg["meta"] = meta
        if dp.sparse:
            msg["idx"], msg["val"] = dp.idx, dp.val
        else:
            msg["plane"] = dp.dense
        return msg

    def broadcast_repair(self, key: str) -> bool:
        """A remote delete/flush lost to this site's newer write:
        re-ship the key's full state to every peer (stamped with our
        last-write stamp) so the wiping site resurrects it — the
        documented add-wins resolution. Returns whether anything
        shipped (the key may have been removed in the meantime)."""
        st = self.export_state(key)
        if st is None:
            return False
        stamp = self.applier.lw.get(key)
        if stamp is None or stamp == NEG_STAMP:
            stamp = (self._journal.last_seq, self.site_id)
        st.pop("_link_bytes", None)
        st.update({"kind": "merge", "target": key, "stamp": stamp,
                   "repair": True})
        with self._links_lock:
            links = list(self.links.values())
        for link in links:
            try:
                link.peer.deliver([st], self.site_id, 0)
            except Exception:
                link.stats["errors"] += 1
        return True

    # -- anti-entropy loop ---------------------------------------------------

    def _ae_loop(self) -> None:
        """Cursor repair lives in the link ticks (rewind to peer vv);
        this loop owns the durable half: flushing the LWW sidecar so a
        restarted site resumes with arbitration state instead of
        re-deciding from nothing."""
        while not self._stop.wait(self.cfg.anti_entropy_interval_s):
            try:
                self._persist_sidecar()
            except Exception:
                pass

    def _persist_sidecar(self) -> None:
        state = self.applier.state()
        state["seq"] = self._journal.last_seq
        state["site_id"] = self.site_id
        path = os.path.join(self.journal_path, SIDECAR_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _load_sidecar(self) -> None:
        path = os.path.join(self.journal_path, SIDECAR_NAME)
        seq = 0
        try:
            with open(path) as f:
                state = json.load(f)
            self.applier.load_state(state)
            seq = int(state.get("seq", 0))
        except FileNotFoundError:
            pass
        except Exception:
            seq = 0  # corrupt sidecar: rebuild everything from the journal
        tail = self._journal.last_seq
        if tail > seq:
            self.applier.rebuild(
                r for r in iter_records(self.journal_path)
                if r.seq > seq)

    # -- introspection (INFO replication / metrics) ---------------------------

    def info(self) -> Dict[str, Any]:
        with self._links_lock:
            links = dict(self.links)
        peers: Dict[str, Any] = {}
        for pid, link in links.items():
            lag = link.lag()
            peers[pid] = {
                "acked_seq": link.peer.applier.vv.get(self.site_id, 0),
                "lag_records": lag["records"],
                "lag_seconds": round(lag["seconds"], 3),
                "link_bytes": lag["link_bytes"],
                "raw_bytes": lag["raw_bytes"],
                "partitions": link.stats["partitions"],
                "repairs": link.stats["repairs"],
            }
        return {
            "role": "active",
            "site_id": self.site_id,
            "local_seq": self._journal.last_seq,
            "version_vector": dict(self.applier.vv),
            "applied": self.applier.applied,
            "suppressed": self.applier.suppressed,
            "resurrections": self.applier.resurrections,
            "peers": peers,
        }

    def staleness(self) -> Dict[str, float]:
        """Per-peer replication staleness in seconds, as exposed to
        reads: how far behind each peer's acknowledged cursor is."""
        with self._links_lock:
            links = dict(self.links)
        return {pid: link.lag()["seconds"] for pid, link in links.items()}


# ---------------------------------------------------------------------------
# Module helpers (tests / benchmarks / embedders)
# ---------------------------------------------------------------------------


def connect_sites(clients) -> None:
    """Mesh a set of geo-enabled clients all-pairs (active-active)."""
    managers = [c.geo for c in clients]
    for m in managers:
        if m is None:
            raise ValueError("every client needs Config.use_geo()")
    for a in managers:
        for b in managers:
            if a is not b:
                a.connect(b)


def converge(clients, timeout_s: float = 30.0) -> bool:
    """Block until every site has delivered every other site's journal
    head and retired every dispatched remote apply — the all-quiet
    fixpoint tests and the smoke gate assert digests at. Returns False
    on timeout."""
    managers = [c.geo for c in clients]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        settled = True
        for a in managers:
            head = a.journal_last_seq()
            for b in managers:
                if a is b:
                    continue
                if b.applier.vv.get(a.site_id, 0) < head:
                    settled = False
                    break
                if b.applier.pending():
                    settled = False
                    break
            if not settled:
                break
        if settled:
            return True
        time.sleep(0.005)
    return False
