"""FaultManager: wires the fault subsystem into one client (counterpart
of `redisson_tpu.fault.manager`).

Config.use_faults() -> the client constructs a FaultManager after the
executor and persistence are up (the rebuild path needs both), and tears it
down first in shutdown (the watchdog and rebuild threads must stop before
the executor they poll does). The port has no serving layer yet: no breaker
board and no cost model, so watchdog deadlines are the floor.
"""

from __future__ import annotations

from typing import Optional

from redisson_tpu_torch.fault import inject
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
        self._started = False

    def start(self) -> None:
        client = self._client
        cfg = self.cfg
        executor = client._executor
        if cfg.plan:
            self.injector = FaultInjector(
                FaultPlan.from_dicts(cfg.plan, seed=cfg.seed))
            inject.install(self.injector)
        if cfg.rebuild:
            self.rebuild = RebuildCoordinator(client)
            executor.fault_guard = self.rebuild.guard
        executor.fault_listener = self._on_fault
        if cfg.watchdog:
            self.watchdog = RunWatchdog(
                executor,
                estimate=None,
                margin=cfg.watchdog_margin,
                floor_s=cfg.watchdog_floor_s,
                poll_s=cfg.watchdog_poll_s,
                on_trip=self._on_fault,
            )
            self.watchdog.start()
        self._started = True

    def _on_fault(self, kind, targets, exc) -> None:
        if self.rebuild is not None:
            self.rebuild.on_fault(kind, targets, exc)

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
