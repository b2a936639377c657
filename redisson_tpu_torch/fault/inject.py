"""Deterministic, seeded fault injection at named seams (counterpart of
`redisson_tpu.fault.inject`, same seams and plan format).

Faults must be *reproducible*: a failing seed must replay bit-identically.
So injection is driven by a declarative `FaultPlan` — an ordered list of
`FaultRule`s, each naming a seam, an optional kind/target match, which hit
to fire on, and which taxonomy class to raise — and the only
nondeterminism allowed is the plan's own seeded RNG (used by
`FaultPlan.random()` to *generate* plans, never to decide at fire time).

Seams (each is one `fire()` call placed in product code; the tuple is the
JAX package's, so its plans run here unchanged):

  stage_h2d       ingest/pipeline.py — the staging worker, before a
                  chunk's pinned copy and H2D
  kernel_launch   executor._dispatch — immediately before backend.run;
                  backend_torch — before each delta / tape merge
  d2h_complete    backend_torch completion closures — where a Readback
                  is waited for and the result materialized
  journal_fsync   persist/journal.py — before the durability fsync
  snapshot_io     persist/snapshotter.py — the snapshot write
  replica_tail    persist/follower.py — each pass of the follower's tail
                  loop (a fault there freezes the replica's watermark)
  health_probe    replica/manager.py — the primary's health probe (a fault
                  there is a failed probe)
  wire_conn       wire/server.py — each socket read of a RESP connection
  geo_link        geo/link.py — the top of every SiteLink tick, with
                  target=<peer site id> (a fault there is a cross-site
                  partition: the tick aborts and the cursor holds)
  mesh_collective the mesh data plane's collectives, which the port has
                  not reached yet; plans may name it, nothing fires it

Cost when disabled: `fire()` reads one module global and returns — no
lock, no allocation — so the instrumentation stays under the <1%
fault-free-overhead gate with room to spare.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from redisson_tpu_torch.fault import taxonomy

SEAMS = (
    "stage_h2d",
    "kernel_launch",
    "d2h_complete",
    "journal_fsync",
    "snapshot_io",
    "mesh_collective",
    "replica_tail",
    "health_probe",
    "wire_conn",
    "geo_link",
)

#: fault-class name (as written in plans/config dicts) -> taxonomy class
FAULT_CLASSES = {
    "retryable": taxonomy.RetryableFault,
    "state_uncertain": taxonomy.StateUncertainFault,
    "device_lost": taxonomy.DeviceLostFault,
    "fatal": taxonomy.FatalFault,
}


@dataclass
class FaultRule:
    """One injection decision: at `seam`, on the `nth` matching hit
    (1-based), raise `fault`; repeat for `times` consecutive matches
    (so a rule can model a fault that persists across retries)."""

    seam: str
    fault: str = "retryable"  # key into FAULT_CLASSES, or "stall"
    nth: int = 1
    times: int = 1
    kind: str = ""    # "" matches any op kind
    target: str = ""  # "" matches any target
    # For fault="stall": sleep this long at the seam instead of raising —
    # models a slow fsync / stuck transfer rather than a failed one (the
    # trace smoke gate uses a journal_fsync stall to pin slowlog stage
    # attribution).
    delay_s: float = 0.0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; one of {SEAMS}")
        if self.fault == "stall":
            if self.delay_s <= 0.0:
                raise ValueError("stall rules need delay_s > 0")
        elif self.fault not in FAULT_CLASSES:
            raise ValueError(
                f"unknown fault class {self.fault!r}; "
                f"one of {tuple(FAULT_CLASSES) + ('stall',)}")
        if self.nth < 1 or self.times < 1:
            raise ValueError("nth and times are 1-based and positive")

    def matches(self, seam: str, kind: str, target: str) -> bool:
        return (seam == self.seam
                and (not self.kind or kind == self.kind)
                and (not self.target or target == self.target))

    def make(self, seam: str, kind: str, target: str) -> taxonomy.Fault:
        cls = FAULT_CLASSES[self.fault]
        return cls(
            f"injected {self.fault} fault at {seam}"
            f" (kind={kind or '*'} target={target or '*'} nth={self.nth})",
            seam=seam)


@dataclass
class FaultPlan:
    """A declarative injection schedule. `seed` only documents how a
    random plan was generated; execution is a pure function of the rules
    and the hit order."""

    rules: List[FaultRule] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_dicts(cls, entries: Sequence[Dict[str, Any]],
                   seed: int = 0) -> "FaultPlan":
        """Build from config-style dicts (Config.faults.plan)."""
        return cls(rules=[FaultRule(**e) for e in entries], seed=seed)

    @classmethod
    def random(cls, seed: int, seams: Sequence[str] = SEAMS,
               n_rules: int = 3, max_nth: int = 20,
               faults: Sequence[str] = ("retryable", "retryable",
                                        "state_uncertain")) -> "FaultPlan":
        """Deterministic chaos-plan generator (the property test's input):
        same seed -> same plan, always. Fault classes are drawn from
        `faults`, retryable-weighted by default so most runs exercise the
        serve retry path and some the rebuild path."""
        rng = random.Random(seed)
        rules = [
            FaultRule(
                seam=rng.choice(list(seams)),
                fault=rng.choice(list(faults)),
                nth=rng.randint(1, max_nth),
                times=rng.randint(1, 2),
            )
            for _ in range(n_rules)
        ]
        return cls(rules=rules, seed=seed)


class FaultInjector:
    """Executes a FaultPlan: counts hits per (rule, seam match) and
    raises the configured taxonomy class on the scheduled ones. All
    counting is under one lock — injection is a test/chaos facility, not
    a hot-path feature, and determinism beats throughput here."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._hits = [0] * len(plan.rules)  # matching hits seen per rule
        self.injected = 0
        self.fired: List[Dict[str, Any]] = []  # audit log for tests

    def fire(self, seam: str, kind: str = "", target: str = "") -> None:
        fired_rule: Optional[FaultRule] = None
        with self._lock:
            for i, rule in enumerate(self.plan.rules):
                if not rule.matches(seam, kind, target):
                    continue
                self._hits[i] += 1
                n = self._hits[i]
                if rule.nth <= n < rule.nth + rule.times:
                    self.injected += 1
                    self.fired.append({
                        "seam": seam, "kind": kind, "target": target,
                        "rule": i, "hit": n, "fault": rule.fault,
                    })
                    fired_rule = rule
                    break
        if fired_rule is None:
            return
        if fired_rule.fault == "stall":
            # Act OUTSIDE the lock: a stall models a slow (not failed)
            # operation, and sleeping under the injector lock would
            # serialize unrelated seams behind it.
            time.sleep(fired_rule.delay_s)
            return
        raise fired_rule.make(seam, kind, target)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "injected": self.injected,
                "hits": list(self._hits),
                # Copy the entries too, not just the list: handing callers
                # references to the live audit dicts lets a mutated snapshot
                # corrupt the injector's own log.
                "fired": [dict(e) for e in self.fired],
            }


# ---------------------------------------------------------------------------
# Module-level install point (what the seams call)
# ---------------------------------------------------------------------------

_INJECTOR: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> None:
    """Install the process-wide injector (Config.use_faults -> client)."""
    global _INJECTOR
    _INJECTOR = injector


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None


def installed() -> Optional[FaultInjector]:
    return _INJECTOR


def fire(seam: str, kind: str = "", target: str = "") -> None:
    """The seam hook. With no injector installed this is one global read
    and a return — cheap enough to leave in production dispatch paths."""
    inj = _INJECTOR
    if inj is not None:
        inj.fire(seam, kind, target)
