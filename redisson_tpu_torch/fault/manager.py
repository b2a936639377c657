"""FaultManager: wires the fault subsystem into one client (counterpart
of `redisson_tpu.fault.manager`).

Config.use_faults() -> the client constructs a FaultManager after the
executor, the serving layer and persistence are up (the rebuild path needs
all three), and tears it down first in shutdown (the watchdog and rebuild
threads must stop before the executor they poll does). With a serving
layer, the watchdog's deadlines come from its cost model and both the
watchdog and the rebuild drive its breaker board; without one, deadlines
are the floor and there is no board. Other observers of retired device
faults (the replica tier's DeviceLost failover trigger) register with
`add_fault_listener`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from redisson_tpu_torch.fault import inject, taxonomy
from redisson_tpu_torch.fault.inject import FaultInjector, FaultPlan
from redisson_tpu_torch.fault.rebuild import RebuildCoordinator
from redisson_tpu_torch.fault.watchdog import RunWatchdog


class FaultManager:
    def __init__(self, client, cfg):
        self._client = client
        self.cfg = cfg
        self.injector: Optional[FaultInjector] = None
        self.watchdog: Optional[RunWatchdog] = None
        self.rebuild: Optional[RebuildCoordinator] = None
        self._extra_listeners: List[Callable] = []
        self._started = False

    def start(self) -> None:
        client = self._client
        cfg = self.cfg
        executor = client._executor
        serve = getattr(client, "serve", None)
        breakers = getattr(serve, "_breakers", None) if serve else None
        if cfg.plan:
            self.injector = FaultInjector(
                FaultPlan.from_dicts(cfg.plan, seed=cfg.seed))
            inject.install(self.injector)
        if cfg.rebuild:
            self.rebuild = RebuildCoordinator(client, breakers=breakers)
            executor.fault_guard = self.rebuild.guard
        executor.fault_listener = self._on_fault
        if cfg.watchdog:
            cost_model = getattr(serve, "cost_model", None) if serve else None
            estimate = cost_model.estimate if cost_model is not None else None
            self.watchdog = RunWatchdog(
                executor,
                estimate=estimate,
                margin=cfg.watchdog_margin,
                floor_s=cfg.watchdog_floor_s,
                poll_s=cfg.watchdog_poll_s,
                on_trip=self._on_fault,
                breakers=breakers,
            )
            self.watchdog.start()
        self._started = True
        from redisson_tpu_torch.observability import register_fault

        register_fault(client.metrics, self)

    def add_fault_listener(self, fn) -> None:
        """Register `fn(kind, targets, exc)` to observe retired device
        faults alongside the rebuild coordinator (the ReplicaManager's
        DeviceLost failover trigger)."""
        self._extra_listeners.append(fn)

    def remove_fault_listener(self, fn) -> None:
        if fn in self._extra_listeners:
            self._extra_listeners.remove(fn)

    def _on_fault(self, kind, targets, exc) -> None:
        if self.rebuild is not None:
            self.rebuild.on_fault(kind, targets, exc)
        for fn in list(self._extra_listeners):
            try:
                fn(kind, targets, exc)
            except Exception:
                # Fan-out is best-effort: one observer's crash must not
                # starve the rest or the retire path.
                pass

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        if self.watchdog is not None:
            self.watchdog.stop()
        executor = getattr(self._client, "_executor", None)
        if executor is not None:
            executor.fault_listener = None
        if self.rebuild is not None:
            self.rebuild.close()
        # Leave fault_guard installed until after close(): a rebuild that
        # raced shutdown keeps its degraded/quarantine semantics to the end.
        if executor is not None:
            executor.fault_guard = None
        if self.injector is not None and inject.installed() is self.injector:
            inject.uninstall()

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"taxonomy": taxonomy.stats()}
        if self.injector is not None:
            out["injector"] = self.injector.snapshot()
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        if self.rebuild is not None:
            out["rebuild"] = self.rebuild.snapshot()
        return out
