"""Fault subsystem: error taxonomy, seeded injection, run watchdog, and
self-healing HBM rebuild (counterpart of `redisson_tpu.fault`).

The analogue of "the connection died" is "the device run died" — a failed
staging transfer, a kernel launch error, a wedged run, or lost HBM state.
This package closes that loop:

  * taxonomy.py — the classification boundary (`RetryableFault`,
    `StateUncertainFault`, `DeviceLostFault`, `FatalFault`) and
    `classify()`, which maps raw CUDA/IO exceptions into it at every seam
    that completes futures;
  * inject.py — deterministic seeded fault injection at named seams
    (`FaultPlan` -> `FaultInjector`; `fire()` is a no-op costing one
    global read when no injector is installed);
  * watchdog.py — per-run deadlines over the executor's in-flight window;
    a stuck run trips `StateUncertainFault`;
  * rebuild.py — quarantine + re-materialize lost HBM planes from host
    truth (newest snapshot + journal-suffix replay), or degrade targets
    to read-only when rebuild is impossible (after a sticky CUDA error,
    a restart with auto-recovery is the way back).

`FaultManager` (manager.py) wires all four into a client from
`Config.use_faults()`.
"""

from redisson_tpu_torch.fault.taxonomy import (  # noqa: F401
    DeviceLostFault,
    Fault,
    FatalFault,
    RetryableFault,
    StateUncertainFault,
    TargetDegradedError,
    TargetQuarantinedError,
    classify,
)
from redisson_tpu_torch.fault.inject import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    FaultRule,
    fire,
    install,
    installed,
    uninstall,
)
from redisson_tpu_torch.fault.watchdog import RunWatchdog  # noqa: F401
from redisson_tpu_torch.fault.rebuild import RebuildCoordinator  # noqa: F401
from redisson_tpu_torch.fault.manager import FaultManager  # noqa: F401
