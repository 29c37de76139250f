"""The port's chaos suite (``repro_torch/serving/stream.py`` +
``serving/faults.py``) on the CPU, the twin of ``tests/test_chaos.py``.
Its acceptance criteria, held within the port:

  * kill a shard mid-run: its tenants fail over (checkpoint restore +
    WAL replay onto a surviving shard) and the resumed per-tenant
    FrameResult stream is BITWISE identical to an uninterrupted run,
    track ids preserved;
  * offer 2x sustained capacity: the front end walks the degradation
    ladder and sheds load with ZERO uncaught exceptions and no tenant
    starved;
  * sensor dropout: tracks coast, prune, and respawn cleanly when the
    sensor returns;
  * NaN/inf payloads never poison a bank; duplicates and clock skew
    are absorbed at admission.

Everything is driven by ``ChaosDriver`` on a fake clock — a failing
case replays exactly. The two-device case runs here on two CPU shards
(``devices=["cpu", "cpu"]``). ``tests/test_torch_stream_parity.py``
holds the port to the reference under the same scenarios.
"""
import numpy as np
import pytest

from repro_torch.core.filters import make_imm
from repro_torch.core.tracker import TrackerConfig
from repro_torch.serving.faults import ChaosDriver, FaultPlan
from repro_torch.serving.stream import (Admission, NS_STRIDE, ServiceTier,
                                        StreamConfig, StreamFrontEnd)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


MODEL = make_imm()
TRACKER = TrackerConfig(capacity=8, max_meas=4)
TENANTS = ("alpha", "bravo", "charlie")


def walker_scene(tenant_seed, n_targets=2, m=3, drop_every=7):
    """Deterministic per-tenant random-walk targets; every
    ``drop_every``-th frame one detection goes missing."""
    rng = np.random.default_rng(tenant_seed)
    pos = rng.normal(scale=10.0, size=(n_targets, m)).astype(np.float32)
    steps = rng.normal(scale=0.3,
                       size=(256, n_targets, m)).astype(np.float32)

    def scene(i):
        z = pos + steps[: (i % 256) + 1].sum(0)
        if drop_every and i % drop_every == drop_every - 1:
            z = z[1:]
        return z

    return scene


def make_front(tmp_path, clk, tag, **kw):
    kw.setdefault("n_shards", 2)
    kw.setdefault("lanes_per_shard", 4)  # a survivor must be able to
    # absorb every tenant of a dead shard
    kw.setdefault("queue_depth", 8)
    kw.setdefault("checkpoint_every", 4)
    kw.setdefault("heartbeat_timeout_s", 1.0)
    # bitwise runs must stay at FULL tier while a dead shard's queues
    # back up, so the default thresholds are pushed out of reach
    kw.setdefault("degrade_at", 5.0)
    kw.setdefault("coast_at", 6.0)
    kw.setdefault("reject_at", 7.0)
    return StreamFrontEnd(MODEL, StreamConfig(**kw), TRACKER,
                          ckpt_dir=str(tmp_path / tag), clock=clk,
                          devices=("cpu",))


def drive(front, plan, cycles, dt=0.5, rate=1, budget=None,
          driver=ChaosDriver):
    clk = front.clock
    scenes = {t: walker_scene(100 + i) for i, t in enumerate(TENANTS)}
    for t in TENANTS:
        assert front.attach(t).value == Admission.ACCEPTED.value
    drv = driver(front, plan, scenes, clk.advance, dt_s=dt,
                 deadline_budget_s=budget, offered_rate=rate)
    rep = drv.run(cycles)
    # drain the backlog a dead period left behind (updates keep
    # accumulating so streams can be compared end-to-end)
    for _ in range(40):
        ups = front.pump()
        if not ups:
            break
        for t, u in ups.items():
            rep.updates[t].append(u)
        clk.advance(dt)
    return rep


def assert_streams_bitwise(ref, got):
    """Per-tenant update streams must match frame-for-frame: same
    kinds, same seqs, same track ids, bitwise-identical states."""
    for t in TENANTS:
        ru, gu = ref.updates[t], got.updates[t]
        assert len(ru) == len(gu), \
            f"{t}: {len(gu)} frames applied vs {len(ru)} uninterrupted"
        for r, g in zip(ru, gu):
            assert (r.frame, r.seq, r.kind) == (g.frame, g.seq, g.kind)
            assert len(r.snapshots) == len(g.snapshots), \
                f"{t} frame {r.frame}: track count diverged"
            for rs, gs in zip(r.snapshots, g.snapshots):
                assert rs.track_id == gs.track_id
                assert (rs.hits, rs.age) == (gs.hits, gs.age)
                np.testing.assert_array_equal(rs.state, gs.state)
                np.testing.assert_array_equal(rs.mode_probs,
                                              gs.mode_probs)


# ---------------------------------------------------------------- failover
class TestFailover:
    def test_shard_kill_resumes_bitwise(self, tmp_path):
        """THE acceptance test: kill the shard under two tenants
        mid-run; the failed-over streams are bitwise identical to an
        uninterrupted run, ids preserved."""
        clk_ref = FakeClock()
        ref_front = make_front(tmp_path, clk_ref, "ref")
        ref = drive(ref_front, FaultPlan(), cycles=16)
        assert not ref.exceptions

        clk = FakeClock()
        front = make_front(tmp_path, clk, "chaos")
        got = drive(front, FaultPlan(kill_shards={7: 0}), cycles=16)
        assert got.exceptions == []
        assert front.stats.shards_lost == 1
        assert front.stats.failovers > 0
        assert "shard0" in got.killed_at
        assert got.recovered_at, "no tenant ever recovered"
        assert_streams_bitwise(ref, got)
        # the dead shard is gone for good
        assert front.shards_alive() == ["shard1"]

    def test_failover_with_stale_checkpoint_replays_long_wal(
            self, tmp_path):
        """checkpoint_every larger than the run: failover must rebuild
        the whole lane from the frame-0 snapshot + full WAL replay —
        still bitwise."""
        clk_ref = FakeClock()
        ref = drive(make_front(tmp_path, clk_ref, "ref",
                               checkpoint_every=1000),
                    FaultPlan(), cycles=12)
        clk = FakeClock()
        front = make_front(tmp_path, clk, "chaos", checkpoint_every=1000)
        got = drive(front, FaultPlan(kill_shards={6: 0}), cycles=12)
        assert got.exceptions == []
        assert_streams_bitwise(ref, got)

    def test_track_ids_keep_their_namespace_across_failover(
            self, tmp_path):
        clk = FakeClock()
        front = make_front(tmp_path, clk, "ns")
        got = drive(front, FaultPlan(kill_shards={7: 0}), cycles=16)
        assert got.exceptions == []
        for i, t in enumerate(TENANTS):
            ns = front.tenants[t].ns_base
            assert ns == i * NS_STRIDE  # attach order pins the base
            for u in got.updates[t]:
                for s in u.snapshots:
                    assert s.track_id // NS_STRIDE == i

    def test_second_kill_parks_when_no_lanes_survive(self, tmp_path):
        clk = FakeClock()
        front = make_front(tmp_path, clk, "park", lanes_per_shard=2)
        with pytest.warns(RuntimeWarning, match="parked"):
            got = drive(front, FaultPlan(kill_shards={5: 0, 10: 1}),
                        cycles=16)
        assert got.exceptions == []
        assert front.shards_alive() == []
        assert front.stats.parked > 0


# ---------------------------------------------------------------- overload
class TestOverload:
    def test_2x_capacity_sheds_via_ladder_no_starvation(self, tmp_path):
        """Twice the sustainable load: the ladder engages, shedding is
        explicit, nothing raises, every tenant keeps being served."""
        clk = FakeClock()
        front = make_front(tmp_path, clk, "load", queue_depth=4,
                           degrade_at=0.375, coast_at=0.8,
                           reject_at=0.95)
        got = drive(front, FaultPlan(), cycles=24, rate=2)
        assert got.exceptions == []
        s = front.stats
        # overload was actually shed, through the ladder and admission
        shed_total = (s.shed + s.replaced_oldest + s.rejected_overload
                      + s.rejected_queue_full)
        assert shed_total > 0, "2x load but nothing was shed"
        assert s.accepted < s.submitted
        # no tenant starves: everyone keeps a live stream, and the
        # anti-starvation floor bounds every coast streak
        for t in TENANTS:
            assert got.frames_applied(t) >= 12
            assert got.served_fraction(t) > 0.15
            streak, longest = 0, 0
            for u in got.updates[t]:
                streak = streak + 1 if u.kind == "shed" else 0
                longest = max(longest, streak)
            assert longest <= front.cfg.starve_limit
        # and the ladder was the mechanism, not luck
        decisions = {d for dec in got.decisions.values()
                     for _, d in dec}
        assert decisions & {Admission.REJECTED_OVERLOAD,
                            Admission.REPLACED_OLDEST}

    def test_recovers_to_full_tier_when_load_drops(self, tmp_path):
        clk = FakeClock()
        front = make_front(tmp_path, clk, "recover", queue_depth=4,
                           degrade_at=0.375, coast_at=0.8,
                           reject_at=0.95)
        drive(front, FaultPlan(), cycles=12, rate=2)
        # backlog drained by drive(); offered load is now zero
        assert front.effective_tier() == ServiceTier.FULL


# ----------------------------------------------------------- sensor faults
class TestSensorFaults:
    def test_dropout_coasts_prunes_respawns(self, tmp_path):
        clk = FakeClock()
        front = make_front(tmp_path, clk, "dropout")
        plan = FaultPlan(dropouts={"alpha": (8, 16)})
        got = drive(front, plan, cycles=24)
        assert got.exceptions == []
        ups = got.updates["alpha"]
        kinds = [u.kind for u in ups]
        assert kinds[8:16] == ["coast"] * 8
        # confirmed tracks before the window, none by its end (pruned),
        # respawned after the sensor comes back
        assert len(ups[7].snapshots) > 0
        assert len(ups[15].snapshots) == 0
        assert len(ups[-1].snapshots) > 0
        # the other tenants never noticed
        assert all(u.kind == "served" for u in got.updates["bravo"])

    def test_nan_inf_bursts_never_poison_the_banks(self, tmp_path):
        clk = FakeClock()
        front = make_front(tmp_path, clk, "nan")
        plan = FaultPlan(corruptions={("alpha", c): ("nan" if c % 2
                                                     else "inf")
                                      for c in range(4, 12)})
        got = drive(front, plan, cycles=16)
        assert got.exceptions == []
        for sh in front.shards:
            if sh.alive:
                assert np.isfinite(np.asarray(sh.banks.x)).all()
                assert np.isfinite(np.asarray(sh.banks.P)).all()
        # the corrupted tenant still has a live, finite stream
        for u in got.updates["alpha"]:
            for s in u.snapshots:
                assert np.isfinite(s.state).all()

    def test_duplicates_are_dropped_and_change_nothing(self, tmp_path):
        clk_ref = FakeClock()
        ref = drive(make_front(tmp_path, clk_ref, "ref"), FaultPlan(),
                    cycles=12)
        clk = FakeClock()
        front = make_front(tmp_path, clk, "dup")
        plan = FaultPlan(duplicates=tuple(("alpha", c)
                                          for c in range(3, 9)))
        got = drive(front, plan, cycles=12)
        assert got.exceptions == []
        assert front.stats.duplicates == 6
        assert_streams_bitwise(ref, got)

    def test_clock_skew_expires_only_the_skewed_tenant(self, tmp_path):
        clk = FakeClock(t=100.0)
        front = make_front(tmp_path, clk, "skew")
        # alpha's clock is 10s behind: its deadlines are already past
        plan = FaultPlan(skews_s={"alpha": -10.0})
        got = drive(front, plan, cycles=12, budget=2.0)
        assert got.exceptions == []
        assert front.stats.expired > 0
        assert got.frames_applied("alpha") == 0  # all pre-expired
        for t in ("bravo", "charlie"):
            assert got.frames_applied(t) == 12  # untouched


# ------------------------------------------------------------ the kitchen sink
def test_everything_at_once(tmp_path):
    """All fault classes in one run: still zero uncaught exceptions and
    every un-parked tenant keeps a stream."""
    clk = FakeClock(t=50.0)
    front = make_front(tmp_path, clk, "sink", queue_depth=6,
                       degrade_at=0.4, coast_at=0.7, reject_at=0.95)
    plan = FaultPlan(
        kill_shards={9: 0},
        dropouts={"bravo": (4, 8)},
        corruptions={("charlie", 5): "nan", ("charlie", 6): "inf"},
        duplicates=(("alpha", 3), ("bravo", 11)),
        skews_s={"charlie": 0.5},
    )
    got = drive(front, plan, cycles=20, rate=2, budget=30.0)
    assert got.exceptions == []
    assert front.stats.shards_lost == 1
    for t in TENANTS:
        assert got.frames_applied(t) > 0
    for sh in front.shards:
        if sh.alive:
            assert np.isfinite(np.asarray(sh.banks.x)).all()


# --------------------------------------------------------- device placement
def test_shards_pin_to_distinct_devices_and_failover_migrates(tmp_path):
    """The reference's two-device case (skipped there on one XLA device)
    on two CPU shards: each shard's banks sit on its own device entry,
    and every migrated tenant ends on the survivor."""
    clk = FakeClock()
    front = StreamFrontEnd(MODEL,
                           StreamConfig(n_shards=2, lanes_per_shard=4,
                                        degrade_at=5.0, coast_at=6.0,
                                        reject_at=7.0),
                           TRACKER, ckpt_dir=str(tmp_path),
                           clock=clk, devices=["cpu", "cpu"])
    assert [sh.device.type for sh in front.shards] == ["cpu", "cpu"]
    for sh in front.shards:
        assert all(leaf.device == sh.device for leaf in sh.banks)
    assert front.shards[0].banks.x.data_ptr() != \
        front.shards[1].banks.x.data_ptr()
    got = drive(front, FaultPlan(kill_shards={5: 0}), cycles=12)
    assert got.exceptions == []
    survivor = front.shards[1]
    assert front.shards[0].banks is None
    assert all(leaf.device == survivor.device for leaf in survivor.banks)
    for t in TENANTS:
        assert front.tenants[t].shard == 1
