"""Fault tolerance: heartbeats, straggler detection, crash-restart
supervision. Pure Python: the port keeps its own copy of the JAX
package's ``runtime/ft.py`` (the port imports nothing of that package).

On a real multi-pod deployment each host runs a heartbeat reporter and
the coordinator holds this logic; here the machinery is host-simulated
(and unit-tested with induced failures) while the state it protects —
checkpoint/restore, data-stream resume, elastic re-shard — is fully
real.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class HeartbeatMonitor:
    """Tracks last-seen timestamps per host; hosts silent for longer
    than `timeout_s` are declared dead."""

    def __init__(self, hosts: List[str], timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str) -> None:
        self.last_seen[host] = self.clock()

    def remove(self, host: str) -> None:
        """Decommission a host (it was failed over / drained): it must
        stop showing up in ``dead_hosts`` forever after."""
        self.last_seen.pop(host, None)

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_hosts()


class StragglerDetector:
    """Flags hosts whose step time exceeds k x the fleet median (EWMA-
    smoothed). At scale the remediation is re-sharding the straggler's
    slice away or preemptive restart; the detector emits the decision."""

    def __init__(self, hosts: List[str], k: float = 2.0, alpha: float = 0.3):
        self.k = k
        self.alpha = alpha
        self.ewma: Dict[str, Optional[float]] = {h: None for h in hosts}

    def record(self, host: str, step_time_s: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (step_time_s if prev is None
                           else self.alpha * step_time_s
                           + (1 - self.alpha) * prev)

    def remove(self, host: str) -> None:
        """Drop a decommissioned host from the fleet statistics (its
        stale EWMA must not skew the median for the survivors)."""
        self.ewma.pop(host, None)

    def stragglers(self) -> List[str]:
        vals = [v for v in self.ewma.values() if v is not None]
        if len(vals) < 2:
            return []
        med = sorted(vals)[len(vals) // 2]
        return [h for h, v in self.ewma.items()
                if v is not None and v > self.k * med]


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    restored_steps: List[int] = field(default_factory=list)


class TrainSupervisor:
    """Crash-restart driver around a step function.

    run() executes `step_fn(step_idx)` in a loop; on exception it calls
    `restore_fn()` (which must return the step index to resume from)
    and retries, up to `max_restarts`. Used by the training launcher and
    exercised with induced failures in tests/test_torch_ft.py.
    """

    def __init__(self, step_fn: Callable[[int], None],
                 restore_fn: Callable[[], int], total_steps: int,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.total = total_steps
        self.max_restarts = max_restarts

    def run(self, start_step: int = 0) -> SupervisorReport:
        report = SupervisorReport()
        step = start_step
        while step < self.total:
            try:
                self.step_fn(step)
                step += 1
                report.steps_run += 1
            except Exception:  # noqa: BLE001
                if report.restarts >= self.max_restarts:
                    raise
                report.restarts += 1
                step = self.restore_fn()
                report.restored_steps.append(step)
        return report
