"""Deadline-aware adaptive batching policy + the online cost model
(counterpart of `redisson_tpu.serve.policy`).

The seed executor drains greedily: whatever is queued goes to the device
immediately, up to `max_batch_keys`. That is right for bulk ingest and wrong
for a serving mix — a lone 1-key op pays a full device dispatch, and the
next tick's ops pay another. The sketch-accelerator literature assumes the
opposite shape upstream of the device (continuous batching under a latency
budget); this policy implements it:

  * an online **CostModel** learns ns/key and per-dispatch overhead per op
    kind from the executor's own completions (EWMA over measured batches —
    the same measured-not-modeled stance as `ingest/planner.py`, which can
    seed it: see `seed_from_planner`);
  * `batch_key_limit` sizes the batch so its *service time* fits
    `target_batch_service_s` — batches grow only while the device call
    stays short enough that queue wait behind it is bounded;
  * `linger_s` holds a partially filled batch open up to
    `min(deadline slack, max_linger)`: the batch closes early when any
    member op's deadline would be at risk, and never waits once the target
    size is reached.

Stdlib-only and clock-free (the executor passes `now`), so tests drive it
deterministically.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence


class CostModel:
    """EWMA service-cost model: seconds/key + per-dispatch overhead, per kind.

    `estimate(kind, nkeys)` answers "how long would the device spend on
    nkeys keys of this kind", falling back to a cross-kind generic rate
    (kind=None or an unmeasured kind) so admission has an answer before the
    first batch of a kind completes.

    The default rate and overhead are the JAX package's priors, kept so
    both packages decide alike under a fake clock; they are not figures of
    any card. The EWMA replaces them with what the executor measures at
    completion within a few batches (`snapshot()` shows what it learned).
    """

    def __init__(self, alpha: float = 0.2,
                 default_s_per_key: float = 25e-9,
                 default_overhead_s: float = 150e-6):
        self._alpha = float(alpha)
        self._default_s_per_key = float(default_s_per_key)
        self._default_overhead_s = float(default_overhead_s)
        self._lock = threading.Lock()
        self._s_per_key: Dict[str, float] = {}
        self._overhead_s: Dict[str, float] = {}
        self._generic_s_per_key: Optional[float] = None
        self._observations = 0
        self._stage_s: Dict[str, float] = {}

    def observe(self, kind: str, nkeys: int, seconds: float) -> None:
        if seconds <= 0.0:
            return
        nkeys = max(1, nkeys)
        with self._lock:
            a = self._alpha
            prev_oh = self._overhead_s.get(kind, self._default_overhead_s)
            # Split the sample: time beyond the current overhead estimate is
            # attributed to keys; small batches mostly update the overhead.
            per_key = max(0.0, seconds - prev_oh) / nkeys
            prev = self._s_per_key.get(kind)
            self._s_per_key[kind] = (per_key if prev is None
                                     else (1 - a) * prev + a * per_key)
            if nkeys <= 16:  # overhead-dominated sample
                self._overhead_s[kind] = (1 - a) * prev_oh + a * seconds
            whole = seconds / nkeys
            self._generic_s_per_key = (
                whole if self._generic_s_per_key is None
                else (1 - a) * self._generic_s_per_key + a * whole)
            self._observations += 1

    def observe_stage(self, kind: str, nkeys: int, seconds: float) -> None:
        """Host-side staging cost (pad + device_put + enqueue) from the
        pipelined executor's dispatcher. Tracked separately — it must NOT
        feed the service-time EWMA, which with async dispatch would
        otherwise collapse to ~staging time and starve batch sizing."""
        if seconds <= 0.0:
            return
        with self._lock:
            prev = self._stage_s.get(kind)
            self._stage_s[kind] = (seconds if prev is None
                                   else (1 - self._alpha) * prev
                                   + self._alpha * seconds)

    def s_per_key(self, kind: Optional[str]) -> float:
        with self._lock:
            if kind is not None and kind in self._s_per_key:
                return max(self._s_per_key[kind], 1e-12)
            if self._generic_s_per_key is not None:
                return max(self._generic_s_per_key, 1e-12)
            return self._default_s_per_key

    def estimate(self, kind: Optional[str], nkeys: int) -> float:
        """Estimated service seconds for nkeys keys of `kind`."""
        with self._lock:
            oh = self._overhead_s.get(kind, self._default_overhead_s)
        return oh + max(0, nkeys) * self.s_per_key(kind)

    def seed_from_planner(self, planner=None, nkeys: int = 1 << 16,
                          device=None) -> None:
        """Seed sketch-kind rates from the ingest planner's measured cost
        table (ns/key per path) instead of the static defaults. The port's
        planner has no default device: without `planner`, pass the
        client's `device`. Imported lazily: the planner pulls in torch,
        which admission/policy unit tests do not need."""
        try:
            if planner is None:
                from redisson_tpu_torch.ingest.planner import default_planner
                planner = default_planner(device)
            plan = planner.plan("hll", nkeys)
            s_per_key = (plan.costs.get(plan.path) or 0.0) * 1e-9
        except Exception:
            return  # stay on defaults; the EWMA corrects within a few batches
        if s_per_key > 0.0:
            with self._lock:
                for kind in ("hll_add", "bloom_add", "bitset_set"):
                    self._s_per_key.setdefault(kind, s_per_key)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "observations": self._observations,
                "s_per_key": dict(self._s_per_key),
                "overhead_s": dict(self._overhead_s),
                "generic_s_per_key": self._generic_s_per_key,
                "stage_s": dict(self._stage_s),
            }


class AdaptiveBatchPolicy:
    """Executor batch policy: cost-model batch sizing + bounded linger.

    Implements the `CommandExecutor` policy protocol (`batch_key_limit`,
    `linger_s`, `observe`, `snapshot`) — see `executor.GreedyBatchPolicy`
    for the null implementation this replaces.
    """

    def __init__(self, cost_model: CostModel = None,
                 max_linger_s: float = 0.002,
                 target_batch_service_s: float = 0.005,
                 min_batch_keys: int = 4096):
        self.cost_model = cost_model or CostModel()
        self._max_linger_s = float(max_linger_s)
        self._target_service_s = float(target_batch_service_s)
        self._min_batch_keys = int(min_batch_keys)

    def batch_key_limit(self, kind: str, default_cap: int) -> int:
        """Keys whose estimated service time fits the target budget."""
        if self._target_service_s <= 0.0:
            return default_cap
        fit = int(self._target_service_s / self.cost_model.s_per_key(kind))
        return max(self._min_batch_keys, min(default_cap, fit))

    def linger_s(self, kind: str, keys: int, cap: int,
                 run: Sequence, now: float) -> float:
        """How much longer to hold this batch open (<= 0 = dispatch now)."""
        if self._max_linger_s <= 0.0 or keys >= cap:
            return 0.0
        # Age bound: the oldest member op caps total linger at max_linger.
        oldest = min(op.enqueued_at for op in run)
        close_at = oldest + self._max_linger_s
        # Deadline bound: leave every member enough slack to be *served*.
        est_service = self.cost_model.estimate(kind, cap)
        for op in run:
            if op.deadline is not None:
                close_at = min(close_at, op.deadline - est_service)
        return close_at - now

    def observe(self, kind: str, nkeys: int, seconds: float) -> None:
        """Completion latency of a run (stage + device + D2H) — the service
        time the EWMA sizes batches against. With the pipelined executor
        this fires from the completion callback, not the dispatcher."""
        self.cost_model.observe(kind, nkeys, seconds)

    def observe_dispatch(self, kind: str, nkeys: int, seconds: float) -> None:
        """Dispatcher staging time for a run (non-blocking backend.run)."""
        self.cost_model.observe_stage(kind, nkeys, seconds)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "policy": "adaptive",
            "max_linger_s": self._max_linger_s,
            "target_batch_service_s": self._target_service_s,
            "min_batch_keys": self._min_batch_keys,
            "cost_model": self.cost_model.snapshot(),
        }
