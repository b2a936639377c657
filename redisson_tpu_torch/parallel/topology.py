"""Topology monitoring: failure detection + recovery triggers (counterpart
of `redisson_tpu.parallel.topology`; the port's own copy, no device code).

The reference runs two detection planes (SURVEY.md §5): sentinel pub/sub
events (`SentinelConnectionManager.java:143-192`) and cluster topology
polling every scanInterval (`ClusterConnectionManager.java:265-341`), plus
per-node failure counting that freezes a pool entry after `failedAttempts`
(`ConnectionPool.java:184-186, 283-295`) and a background probe loop that
unfreezes it. The engine has no sentinels, so the polling plane is the model:

  * TopologyManager polls every node's pinger on an interval;
  * a node is marked DOWN after `failed_attempts` consecutive failures
    (the freeze) and UP again after one successful probe (the unfreeze);
  * listeners receive ('node_down' | 'node_up', ident) events — the
    +sdown/-sdown analogues — and a `on_change` hook fires with the set of
    live nodes so a backend can reshard (the cluster tier drains a lost shard).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class NodeState:
    ident: str
    pinger: Callable[[], bool]
    up: bool = True
    failures: int = 0  # consecutive


class TopologyManager:
    def __init__(self, scan_interval_s: float = 1.0, failed_attempts: int = 3):
        self.scan_interval_s = scan_interval_s  # ClusterServersConfig.scanInterval
        self.failed_attempts = failed_attempts  # BaseMasterSlaveServersConfig.failedAttempts
        self._nodes: Dict[str, NodeState] = {}
        self._listeners: List[Callable[[str, str], None]] = []
        self._on_change: Optional[Callable[[List[str]], None]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scans = 0

    # -- registration -------------------------------------------------------

    def add_node(self, ident: str, pinger: Callable[[], bool]) -> None:
        with self._lock:
            self._nodes[ident] = NodeState(ident, pinger)

    def remove_node(self, ident: str) -> None:
        with self._lock:
            self._nodes.pop(ident, None)

    def add_listener(self, fn: Callable[[str, str], None]) -> None:
        """fn(event, ident), event in {'node_down', 'node_up'}."""
        self._listeners.append(fn)

    def on_change(self, fn: Callable[[List[str]], None]) -> None:
        """Recovery hook: called with the live-node list after any up/down
        transition (the changeMaster/reshard trigger)."""
        self._on_change = fn

    # -- state --------------------------------------------------------------

    def live_nodes(self) -> List[str]:
        with self._lock:
            return [n.ident for n in self._nodes.values() if n.up]

    def is_up(self, ident: str) -> bool:
        with self._lock:
            st = self._nodes.get(ident)
            return bool(st and st.up)

    # -- scanning -----------------------------------------------------------

    def scan_once(self) -> bool:
        """One probe round; returns True if topology changed."""
        with self._lock:
            nodes = list(self._nodes.values())
        changed = False
        for st in nodes:
            try:
                ok = bool(st.pinger())
            except Exception:
                ok = False
            if ok:
                if not st.up:
                    st.up = True
                    changed = True
                    self._fire("node_up", st.ident)
                st.failures = 0
            else:
                st.failures += 1
                if st.up and st.failures >= self.failed_attempts:
                    st.up = False
                    changed = True
                    self._fire("node_down", st.ident)
        self.scans += 1
        if changed and self._on_change is not None:
            try:
                self._on_change(self.live_nodes())
            except Exception:
                pass
        return changed

    def _fire(self, event: str, ident: str) -> None:
        for fn in list(self._listeners):
            try:
                fn(event, ident)
            except Exception:
                pass

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.scan_interval_s):
                self.scan_once()

        self._thread = threading.Thread(target=loop, name="redisson-torch-topology",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
