"""The port's streaming front end against the reference's under the same
chaos scenarios (``ChaosDriver`` on a fake clock, ``walker_scene`` of
``tests/test_torch_chaos.py``): a shard kill, a dark sensor, NaN/inf
frames, duplicates and a skewed tenant; 2x offered load through the
degradation ladder with a kill in the middle; a single-model (cv6 LKF)
front end. Per tenant: identical admission decisions, updates (frame,
seq, tier, kind, shard), track ids, hits and ages, and ``StreamStats``;
states and mode probabilities within ``TOL``. The reference runs its
einsum route (``fused_frame=False``), and its fused route (its Pallas
frame kernel in interpret mode) in one short case.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.tracker import TrackerConfig as JCfg
from repro.serving import faults as jfaults
from repro.serving import stream as jstream
from repro_torch.serving.faults import ChaosDriver, FaultPlan
from repro_torch.serving.stream import (ServiceTier, StreamConfig,
                                        StreamFrontEnd)

from _torch_parity import models
from test_torch_chaos import TENANTS, TRACKER, FakeClock, drive

TOL = 5e-4  # tests/test_torch_sharded.py's
SCENARIOS = {
    # a kill at cycle 7, a dark sensor, NaN/inf frames, duplicates and a
    # tenant whose clock runs 0.5 s behind (its backlog expires while its
    # shard is dead), all at the FULL tier
    "faults": dict(
        plan=dict(kill_shards={7: 0}, dropouts={"bravo": (3, 6)},
                  corruptions={("alpha", 4): "nan", ("charlie", 5): "inf",
                               ("bravo", 10): "nan"},
                  duplicates=(("alpha", 3), ("bravo", 9)),
                  skews_s={"charlie": -0.5}),
        cycles=16, budget=1.2, rate=1, cfg={}),
    # 2x offered load under the ladder: every tier, drop-oldest and
    # overload rejects, and a kill at cycle 9 in the middle of it
    "overload": dict(
        plan=dict(kill_shards={9: 0}, dropouts={"bravo": (4, 8)},
                  corruptions={("charlie", 5): "nan",
                               ("charlie", 6): "inf"},
                  duplicates=(("alpha", 3), ("bravo", 11)),
                  skews_s={"charlie": 0.5}),
        cycles=20, budget=30.0, rate=2,
        cfg=dict(queue_depth=6, degrade_at=0.4, coast_at=0.7,
                 reject_at=0.95)),
}


def _pair_run(tmp_path, kind, scenario, fused_ref=False, cycles=None):
    """The same scenario through the port and the reference, each on its
    own fake clock: (port front, port report, ref front, ref report)."""
    sc = SCENARIOS[scenario]
    cycles = cycles or sc["cycles"]
    jmodel, model, _, _ = models(kind)
    kw = dict(n_shards=2, lanes_per_shard=4, queue_depth=8,
              checkpoint_every=4, heartbeat_timeout_s=1.0, degrade_at=5.0,
              coast_at=6.0, reject_at=7.0)
    kw.update(sc["cfg"])
    out = []
    for pkg in ("port", "ref"):
        clk = FakeClock(t=50.0)
        if pkg == "port":
            front = StreamFrontEnd(model, StreamConfig(**kw), TRACKER,
                                   ckpt_dir=str(tmp_path / pkg), clock=clk,
                                   devices=("cpu",))
            plan, driver = FaultPlan(**sc["plan"]), ChaosDriver
        else:
            front = jstream.StreamFrontEnd(
                jmodel, jstream.StreamConfig(**kw),
                JCfg(capacity=8, max_meas=4, fused_frame=fused_ref),
                ckpt_dir=str(tmp_path / pkg), clock=clk)
            plan, driver = jfaults.FaultPlan(**sc["plan"]), \
                jfaults.ChaosDriver
        rep = drive(front, plan, cycles, rate=sc["rate"],
                    budget=sc["budget"], driver=driver)
        assert rep.exceptions == []
        out += [front, rep]
    return out


def _assert_like_reference(front, rep, jfront, jrep):
    assert dataclasses.asdict(front.stats) == dataclasses.asdict(
        jfront.stats)
    assert front.shards_alive() == jfront.shards_alive()
    assert rep.killed_at == jrep.killed_at
    assert rep.recovered_at == jrep.recovered_at
    n_tracks = 0
    for t in TENANTS:
        assert [(c, d.value) for c, d in rep.decisions[t]] == \
            [(c, d.value) for c, d in jrep.decisions[t]], t
        ups, jups = rep.updates[t], jrep.updates[t]
        assert [(u.frame, u.seq, int(u.tier), u.kind, u.shard)
                for u in ups] == \
            [(u.frame, u.seq, int(u.tier), u.kind, u.shard)
             for u in jups], t
        for u, ju in zip(ups, jups):
            assert [(s.track_id, s.hits, s.age) for s in u.snapshots] == \
                [(s.track_id, s.hits, s.age) for s in ju.snapshots], \
                (t, u.frame)
            for s, js in zip(u.snapshots, ju.snapshots):
                np.testing.assert_allclose(s.state, js.state, atol=TOL,
                                           rtol=0)
                if js.mode_probs is None:
                    assert s.mode_probs is None
                else:
                    np.testing.assert_allclose(s.mode_probs, js.mode_probs,
                                               atol=TOL, rtol=0)
            n_tracks += len(u.snapshots)
    assert n_tracks > 0


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chaos_scenario_matches_reference(tmp_path, scenario):
    """IMM, the reference's stream model, against the reference's einsum
    route (fused_frame=False)."""
    front, rep, jfront, jrep = _pair_run(tmp_path, "imm", scenario)
    s = front.stats
    assert s.shards_lost == 1 and s.failovers == 2
    if scenario == "faults":
        assert s.duplicates == 2 and s.expired > 0 and s.coasted == 3
    else:
        assert {u.tier for ups in rep.updates.values() for u in ups} >= {
            ServiceTier.FULL, ServiceTier.WIDE_GATE}
        assert s.shed > 0 and s.replaced_oldest + s.rejected_overload > 0
    _assert_like_reference(front, rep, jfront, jrep)


def test_chaos_matches_reference_fused_route(tmp_path):
    """The reference's fused route (its Pallas frame kernel in interpret
    mode) over a short run of the fault scenario, the kill included."""
    _assert_like_reference(*_pair_run(tmp_path, "imm", "faults",
                                      fused_ref=True, cycles=10))


def test_single_model_front_end_matches_reference(tmp_path):
    """A single-model (cv6 LKF) front end through the fault scenario."""
    front, rep, jfront, jrep = _pair_run(tmp_path, "lkf", "faults")
    assert front.stats.failovers == 2 and not front.is_imm
    _assert_like_reference(front, rep, jfront, jrep)
