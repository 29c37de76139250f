"""Deterministic fault injection for the streaming front end.

Everything the serving layer claims to survive is injected here, on a
fixed schedule keyed by driver cycle, so every chaos run is exactly
reproducible (no wall clock, no RNG shared with the scene):

* **shard crashes** — ``FaultPlan.kill_shards``: at cycle f the shard
  dies silently (``StreamFrontEnd.kill_shard``) and recovery must come
  from the heartbeat timeout + checkpoint/WAL failover path;
* **sensor dropout** — ``dropouts``: during the window the tenant's
  sensor is dark; its frames arrive *empty* (clock ticks with zero
  detections), so its tracks coast and eventually prune — exactly the
  paper's coast-only valid-mask path;
* **corrupt payloads** — ``corruptions``: NaN/inf values overwrite the
  frame; the tracker's ``nan_guard`` must coast those measurements
  instead of poisoning the bank;
* **duplicate / late frames** — ``duplicates``: the previous frame is
  re-submitted with its old sequence number and must be dropped at
  admission;
* **clock skew** — ``skews_s``: the tenant computes its deadlines from
  a skewed clock (``SkewedClock``), so frames can arrive pre-expired;
  the front end must shed them and keep serving everyone else.

``ChaosDriver`` drives a ``StreamFrontEnd`` through the plan and
collects a ``ChaosReport``: every admission decision, every applied
update per tenant, every uncaught exception (the chaos suite asserts
this list is EMPTY), and when each killed shard's tenants recovered.
The plan, the injector and the driver are the JAX package's, over the
port's ``StreamFrontEnd``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.stream import (Admission, StreamFrontEnd,
                                        TenantUpdate)


class SkewedClock:
    """A clock whose reading is offset from the reference clock — the
    classic mis-synced edge device. Deadlines computed against it are
    wrong by ``skew_s`` in the coordinator's frame."""

    def __init__(self, base: Callable[[], float], skew_s: float):
        self.base = base
        self.skew_s = skew_s

    def __call__(self) -> float:
        return self.base() + self.skew_s


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule, all keyed by driver cycle."""

    # cycle -> shard (idx or name) to kill at the START of that cycle
    kill_shards: Dict[int, object] = field(default_factory=dict)
    # tenant -> (start, end) cycles of sensor dropout (dark sensor)
    dropouts: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # (tenant, cycle) -> "nan" | "inf": poison that frame's payload
    corruptions: Dict[Tuple[str, int], str] = field(default_factory=dict)
    # (tenant, cycle): re-submit the previous frame with its old seq
    duplicates: Tuple[Tuple[str, int], ...] = ()
    # tenant -> clock skew (s) used for its deadline computation
    skews_s: Dict[str, float] = field(default_factory=dict)


class FaultInjector:
    """Applies a ``FaultPlan`` to one tenant's submissions."""

    def __init__(self, plan: FaultPlan,
                 clock: Callable[[], float]):
        self.plan = plan
        self.clock = clock
        self._clocks = {t: SkewedClock(clock, s)
                        for t, s in plan.skews_s.items()}

    def tenant_clock(self, tenant: str) -> Callable[[], float]:
        return self._clocks.get(tenant, self.clock)

    def payload(self, tenant: str, cycle: int,
                z: np.ndarray) -> np.ndarray:
        """Dropout blanks the frame; corruption poisons it."""
        window = self.plan.dropouts.get(tenant)
        if window is not None and window[0] <= cycle < window[1]:
            return np.zeros((0, z.shape[-1] if z.ndim else 1),
                            np.float32)
        kind = self.plan.corruptions.get((tenant, cycle))
        if kind is not None and len(z):
            z = np.array(z, np.float32, copy=True)
            z[0, 0] = math.nan if kind == "nan" else math.inf
        return z

    def duplicate_of(self, tenant: str, cycle: int) -> bool:
        return (tenant, cycle) in self.plan.duplicates

    def deadline(self, tenant: str, budget_s: Optional[float]
                 ) -> Optional[float]:
        """Absolute deadline as the TENANT computes it — through its
        (possibly skewed) clock."""
        if budget_s is None:
            return None
        return self.tenant_clock(tenant)() + budget_s


@dataclass
class ChaosReport:
    decisions: Dict[str, List[Tuple[int, Admission]]] = field(
        default_factory=dict)
    updates: Dict[str, List[TenantUpdate]] = field(default_factory=dict)
    exceptions: List[BaseException] = field(default_factory=list)
    killed_at: Dict[str, int] = field(default_factory=dict)
    # tenant -> first cycle an update landed after its shard was killed
    recovered_at: Dict[str, int] = field(default_factory=dict)

    def frames_applied(self, tenant: str) -> int:
        return len(self.updates.get(tenant, []))

    def served_fraction(self, tenant: str) -> float:
        ups = self.updates.get(tenant, [])
        if not ups:
            return 0.0
        return sum(u.kind == "served" for u in ups) / len(ups)


class ChaosDriver:
    """Drives a ``StreamFrontEnd`` through a deterministic scenario.

    ``scenes`` maps tenant -> ``scene(cycle) -> (k, m) measurements``.
    Each cycle: scheduled shard kills fire, every tenant submits its
    (fault-injected) frame, the front end pumps once, and the clock
    advances ``dt_s``. Nothing here may raise — any exception is
    captured into the report, because "no uncaught exceptions under
    chaos" is an acceptance criterion, not an aspiration."""

    def __init__(self, front: StreamFrontEnd, plan: FaultPlan,
                 scenes: Dict[str, Callable[[int], np.ndarray]],
                 clock_advance: Callable[[float], None],
                 dt_s: float = 0.1,
                 deadline_budget_s: Optional[float] = None,
                 offered_rate: int = 1):
        self.front = front
        self.plan = plan
        self.scenes = scenes
        self.advance = clock_advance
        self.dt_s = dt_s
        self.budget_s = deadline_budget_s
        # frames submitted per tenant per cycle; the front end serves
        # at most one per pump, so rate > 1 is sustained overload
        self.offered_rate = offered_rate
        self.inject = FaultInjector(plan, front.clock)
        self._subs: Dict[str, int] = {}

    def run(self, cycles: int) -> ChaosReport:
        rep = ChaosReport()
        prev: Dict[str, Tuple[int, np.ndarray]] = {}
        watch: Dict[str, int] = {}  # tenant -> cycle its shard died
        for t in self.scenes:
            rep.decisions[t] = []
            rep.updates[t] = []
        for cycle in range(cycles):
            try:
                self._cycle(cycle, rep, prev, watch)
            except Exception as e:  # noqa: BLE001 — report, never raise
                rep.exceptions.append(e)
            self.advance(self.dt_s)
        return rep

    def _cycle(self, cycle: int, rep: ChaosReport,
               prev: Dict[str, Tuple[int, np.ndarray]],
               watch: Dict[str, int]) -> None:
        shard = self.plan.kill_shards.get(cycle)
        if shard is not None:
            sh = self.front._shard(shard)
            rep.killed_at[sh.name] = cycle
            for t in self.front.alloc.tenants_on(sh.idx):
                watch.setdefault(t, cycle)
            self.front.kill_shard(shard)
        for tenant, scene in self.scenes.items():
            if self.inject.duplicate_of(tenant, cycle) and tenant in prev:
                old_seq, old_z = prev[tenant]
                d = self.front.submit(tenant, old_z, seq=old_seq)
                rep.decisions[tenant].append((cycle, d))
            for _ in range(self.offered_rate):
                i = self._subs.get(tenant, 0)
                self._subs[tenant] = i + 1
                z = self.inject.payload(tenant, cycle,
                                        np.asarray(scene(i), np.float32))
                deadline = self.inject.deadline(tenant, self.budget_s)
                seq = self.front.tenants[tenant].next_seq
                d = self.front.submit(tenant, z, deadline=deadline)
                rep.decisions[tenant].append((cycle, d))
                if d in (Admission.ACCEPTED, Admission.REPLACED_OLDEST):
                    prev[tenant] = (seq, z)
        for tenant, up in self.front.pump().items():
            rep.updates[tenant].append(up)
            if tenant in watch and tenant not in rep.recovered_at:
                if cycle > watch[tenant]:
                    rep.recovered_at[tenant] = cycle
