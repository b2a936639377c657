"""memstat — device byte accounting and capacity observability
(counterpart of `redisson_tpu.memstat`).

An exact, always-on ledger of device bytes held by the sketch tier
(`accounting.MemLedger`), a Redis `MEMORY` command-family parity surface
(`report.MemoryReport`), and a pressure monitor that forecasts
time-to-watermark and sheds writes above a configurable high-watermark
while reads keep flowing (`pressure.PressureMonitor`).

The ledger is updated at the store seam (create/swap/delete/rename/
flushall fire lifecycle events under the registry lock) plus the backend
bank hooks, so its total equals the sum of live ``tensor.nbytes`` at all
times — ``verify()`` walks the registry and reports any drift.
Auxiliary byte consumers (read cache, bloom mirrors, delta scratch,
pipeline staging, journal/snapshot files) register lazy meters: they
cost nothing on the hot path and are sampled only at report time.
"""
from redisson_tpu_torch.memstat.accounting import MemLedger
from redisson_tpu_torch.memstat.pressure import PressureMonitor
from redisson_tpu_torch.memstat.report import MemoryReport

__all__ = ["MemLedger", "MemoryReport", "PressureMonitor"]
