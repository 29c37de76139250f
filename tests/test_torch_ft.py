"""The port's fault-tolerance primitives (``repro_torch/runtime/ft.py``),
the twin of ``tests/test_ft.py``: the same cases against the port's
own copy, driven with injected clocks and induced failures so every
path is deterministic, and the same seeded sequences through both
packages give the same answers:

  * HeartbeatMonitor — silence past the timeout declares a host dead,
    a beat resurrects it, remove() decommissions it for good;
  * StragglerDetector — EWMA-smoothed step times vs the fleet median,
    with removal of decommissioned hosts from the statistics;
  * TrainSupervisor — crash-restart around a step function with a
    bounded restart budget that re-raises once exhausted.
"""
import pytest

import numpy as np

from repro.runtime import ft as jft
from repro_torch.runtime.ft import (HeartbeatMonitor, StragglerDetector,
                                    TrainSupervisor)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# --------------------------------------------------------------- heartbeat
class TestHeartbeatMonitor:
    def test_all_healthy_at_start(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a", "b"], timeout_s=1.0, clock=clk)
        assert mon.dead_hosts() == []
        assert mon.healthy()

    def test_silence_past_timeout_is_death(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a", "b"], timeout_s=1.0, clock=clk)
        clk.advance(0.9)
        mon.beat("a")
        clk.advance(0.5)  # a silent 0.5s, b silent 1.4s
        assert mon.dead_hosts() == ["b"]
        assert not mon.healthy()

    def test_beat_recovers_a_dead_host(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a"], timeout_s=1.0, clock=clk)
        clk.advance(2.0)
        assert mon.dead_hosts() == ["a"]
        mon.beat("a")  # the host came back before anyone failed it over
        assert mon.dead_hosts() == []

    def test_exact_timeout_is_not_dead(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a"], timeout_s=1.0, clock=clk)
        clk.advance(1.0)  # contract is strictly-greater-than
        assert mon.dead_hosts() == []

    def test_remove_decommissions_forever(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a", "b"], timeout_s=1.0, clock=clk)
        clk.advance(5.0)
        assert set(mon.dead_hosts()) == {"a", "b"}
        mon.remove("a")
        assert mon.dead_hosts() == ["b"]
        clk.advance(100.0)
        assert mon.dead_hosts() == ["b"]  # a never comes back
        mon.remove("missing")  # idempotent on unknown hosts

    def test_beats_keep_fleet_alive_indefinitely(self):
        clk = FakeClock()
        mon = HeartbeatMonitor(["a", "b"], timeout_s=1.0, clock=clk)
        for _ in range(10):
            clk.advance(0.9)
            mon.beat("a")
            mon.beat("b")
        assert mon.healthy()


# --------------------------------------------------------------- straggler
class TestStragglerDetector:
    def test_needs_two_samples(self):
        det = StragglerDetector(["a", "b"])
        det.record("a", 1.0)
        assert det.stragglers() == []

    def test_flags_slow_host(self):
        det = StragglerDetector(["a", "b", "c"], k=2.0)
        for _ in range(5):
            det.record("a", 1.0)
            det.record("b", 1.0)
            det.record("c", 5.0)  # 5x the median
        assert det.stragglers() == ["c"]

    def test_ewma_smoothing_ignores_one_blip(self):
        det = StragglerDetector(["a", "b"], k=2.0, alpha=0.3)
        for _ in range(10):
            det.record("a", 1.0)
            det.record("b", 1.0)
        det.record("b", 3.0)  # one slow step: EWMA ~1.6 < 2x median
        assert det.stragglers() == []

    def test_ewma_converges_on_sustained_slowness(self):
        det = StragglerDetector(["a", "b", "c"], k=2.0, alpha=0.3)
        for _ in range(3):
            det.record("a", 1.0)
            det.record("b", 1.0)
            det.record("c", 1.0)
        for _ in range(20):  # c degrades for good
            det.record("a", 1.0)
            det.record("b", 1.0)
            det.record("c", 10.0)
        assert det.stragglers() == ["c"]

    def test_remove_drops_host_from_statistics(self):
        det = StragglerDetector(["a", "b", "c"], k=2.0)
        for _ in range(5):
            det.record("a", 1.0)
            det.record("b", 1.0)
            det.record("c", 9.0)
        assert det.stragglers() == ["c"]
        det.remove("c")  # failed over: its EWMA must not skew the rest
        assert det.stragglers() == []
        det.record("unknown", 1.0)  # late sample from a removed host
        det.remove("unknown")


# -------------------------------------------------------------- supervisor
class TestTrainSupervisor:
    def test_clean_run_no_restarts(self):
        ran = []
        sup = TrainSupervisor(ran.append, lambda: 0, total_steps=5)
        rep = sup.run()
        assert ran == [0, 1, 2, 3, 4]
        assert rep.steps_run == 5
        assert rep.restarts == 0

    def test_crash_restores_and_resumes(self):
        ran = []
        crashed = []

        def step(i):
            if i == 3 and not crashed:
                crashed.append(i)
                raise RuntimeError("induced")
            ran.append(i)

        sup = TrainSupervisor(step, lambda: 2, total_steps=5,
                              max_restarts=3)
        rep = sup.run()
        # restored to 2, re-ran 2 and 3, finished
        assert ran == [0, 1, 2, 2, 3, 4]
        assert rep.restarts == 1
        assert rep.restored_steps == [2]

    def test_restart_budget_exhaustion_reraises(self):
        def step(i):
            if i == 1:
                raise RuntimeError("persistent fault")

        sup = TrainSupervisor(step, lambda: 0, total_steps=3,
                              max_restarts=2)
        with pytest.raises(RuntimeError, match="persistent fault"):
            sup.run()

    def test_budget_counts_restarts_not_steps(self):
        crashes = []

        def step(i):
            # crash once at each of three different steps
            if i in (1, 2, 3) and i not in crashes:
                crashes.append(i)
                raise RuntimeError("induced")

        sup = TrainSupervisor(step, lambda: max(crashes) - 1,
                              total_steps=5, max_restarts=3)
        rep = sup.run()
        assert rep.restarts == 3
        # a fourth induced crash would have exceeded the budget
        assert rep.steps_run >= 5


# ------------------------------------------------- parity with the reference
def test_same_sequences_give_the_reference_answers():
    """A seeded interleaving of beats, removals, clock steps and step
    times through both packages: identical dead hosts, EWMAs and
    stragglers after every operation."""
    rng = np.random.default_rng(5)
    hosts = ["a", "b", "c", "d"]
    clocks = (FakeClock(), FakeClock())
    mons = (HeartbeatMonitor(hosts, 1.0, clocks[0]),
            jft.HeartbeatMonitor(hosts, 1.0, clocks[1]))
    dets = (StragglerDetector(hosts, k=2.0, alpha=0.3),
            jft.StragglerDetector(hosts, k=2.0, alpha=0.3))
    for _ in range(200):
        op, h = int(rng.integers(0, 5)), hosts[int(rng.integers(0, 4))]
        dt = float(rng.uniform(0.0, 0.8))
        drop = rng.random() < 0.05
        for mon, det, clk in zip(mons, dets, clocks):
            if op == 0:
                mon.beat(h)
            elif op == 1:
                clk.advance(dt)
            elif op == 2:
                det.record(h, dt * (10.0 if h == "d" else 1.0))
            elif op == 3 and drop:
                mon.remove(h)
                det.remove(h)
        assert mons[0].dead_hosts() == mons[1].dead_hosts()
        assert dets[0].ewma == dets[1].ewma
        assert dets[0].stragglers() == dets[1].stragglers()
