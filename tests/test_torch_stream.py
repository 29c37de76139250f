"""The port's streaming front end (``repro_torch/serving/stream.py``) on
the CPU, the twin of ``tests/test_stream.py``: the same units and
properties against the port on ``devices=("cpu",)``, then the same
seeded operation sequences through the allocator, the ladder and the
circuit breaker of both packages with identical results, and the
default device (the card) refused without one.

Property layer (via tests/_hypothesis_compat.py, so it runs with or
without hypothesis installed):

  * the slot allocator NEVER hands two tenants the same (shard, lane)
    and NEVER exceeds the live lane pool, across any interleaving of
    acquire/release/drop_shard;
  * track-id namespaces are never reissued;
  * the degradation ladder is monotone: more load never yields a
    better service tier.

Unit layer: admission decisions (duplicates, drop-oldest, queue-full,
overload reject, deadline expiry), the circuit breaker state machine,
cross-tenant isolation of the fused dispatch, idle-lane freezing, the
NaN guard coasting corrupt payloads, and checkpoint cadence.
"""
import numpy as np
import pytest

import torch

from repro.serving import stream as jstream
from repro_torch.serving import stream as tstream
from repro_torch.core.filters import make_cv_lkf, make_imm
from repro_torch.core.tracker import TrackerConfig
from repro_torch.serving.stream import (Admission, CircuitBreaker,
                                        DegradationLadder, NS_STRIDE,
                                        ServiceTier, SlotAllocator,
                                        StreamConfig, StreamFrontEnd)

from _hypothesis_compat import given, settings, st


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


MODEL = make_imm()
CV = make_cv_lkf()
TRACKER = TrackerConfig(capacity=8, max_meas=4)


def make_front(tmp_path, clk=None, **kw):
    kw.setdefault("n_shards", 2)
    kw.setdefault("lanes_per_shard", 2)
    kw.setdefault("queue_depth", 3)
    kw.setdefault("checkpoint_every", 4)
    return StreamFrontEnd(MODEL, StreamConfig(**kw), TRACKER,
                          ckpt_dir=str(tmp_path),
                          clock=clk or FakeClock(), devices=("cpu",))


def scene(seed, k=2, m=3):
    return np.random.default_rng(seed).normal(
        scale=5.0, size=(k, m)).astype(np.float32)


# ---------------------------------------------------- allocator properties
@settings(max_examples=25)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
def test_allocator_slots_unique_and_bounded(n_shards, lanes, seed):
    """Random interleavings of acquire/release/drop_shard: no slot is
    ever shared, the pool never over-allocates, namespaces are never
    reissued."""
    rng = np.random.default_rng(seed)
    alloc = SlotAllocator(n_shards, lanes)
    live = {}
    seen_ns = set()
    dropped = set()
    for i in range(60):
        op = rng.integers(0, 10)
        if op < 5:  # acquire
            t = f"t{i}"
            loc = alloc.acquire(t)
            if loc is not None:
                assert loc not in live.values(), "slot double-booked"
                assert loc[0] not in dropped, "dead shard's lane reused"
                assert loc[1] < lanes
                live[t] = loc
                ns = alloc.next_namespace()
                assert ns not in seen_ns, "namespace reissued"
                assert ns % NS_STRIDE == 0
                seen_ns.add(ns)
            else:
                # full is the only reason to refuse
                free_live = sum(
                    1 for s in range(n_shards) if s not in dropped
                ) * lanes - len(live)
                assert free_live == 0
        elif op < 8 and live:  # release
            t = list(live)[int(rng.integers(0, len(live)))]
            alloc.release(t)
            del live[t]
        elif op == 9 and len(dropped) < n_shards - 1:  # drop a shard
            s = int(rng.integers(0, n_shards))
            if s not in dropped:
                for t in alloc.tenants_on(s):
                    alloc.release(t)
                    del live[t]
                alloc.drop_shard(s)
                dropped.add(s)
        assert len(set(alloc.where.values())) == len(alloc.where)
        assert len(live) <= (n_shards - len(dropped)) * lanes


def test_allocator_rejects_double_acquire():
    alloc = SlotAllocator(1, 2)
    alloc.acquire("a")
    with pytest.raises(ValueError, match="already holds"):
        alloc.acquire("a")


def test_allocator_balances_across_shards():
    alloc = SlotAllocator(2, 2)
    shards = [alloc.acquire(f"t{i}")[0] for i in range(4)]
    assert sorted(shards[:2]) == [0, 1]  # spread before packing


# ------------------------------------------------------- ladder properties
@settings(max_examples=25)
@given(st.integers(1, 999), st.integers(1, 999), st.integers(0, 1000))
def test_ladder_monotone_in_load(a_millis, b_millis, n):
    """For any valid thresholds and any pair of loads, more load never
    yields a lower (better) tier."""
    lo, hi = sorted((a_millis / 1000.0, b_millis / 1000.0))
    ladder = DegradationLadder(lo, (lo + hi) / 2.0, hi)
    loads = np.linspace(0.0, 1.5, 61)
    tiers = [ladder.tier_for(l) for l in loads]
    assert all(t2 >= t1 for t1, t2 in zip(tiers, tiers[1:]))
    # and the single sampled pair, for the shrunk counterexample
    l1 = n / 1000.0
    assert ladder.tier_for(l1 + 0.25) >= ladder.tier_for(l1)


def test_ladder_hits_every_tier():
    ladder = DegradationLadder(0.25, 0.5, 0.75)
    assert ladder.tier_for(0.0) == ServiceTier.FULL
    assert ladder.tier_for(0.3) == ServiceTier.WIDE_GATE
    assert ladder.tier_for(0.6) == ServiceTier.COAST_ONLY
    assert ladder.tier_for(0.9) == ServiceTier.REJECT


def test_config_rejects_unsorted_thresholds():
    with pytest.raises(ValueError, match="sorted"):
        StreamConfig(degrade_at=0.8, coast_at=0.5, reject_at=0.9)


# --------------------------------------------------------- circuit breaker
def test_breaker_state_machine():
    clk = FakeClock()
    br = CircuitBreaker(failure_threshold=2, cooldown_s=5.0, clock=clk)
    assert br.allow() and br.state == br.CLOSED
    br.record_failure()
    assert br.allow()  # one failure is not a trip
    br.record_failure()
    assert not br.allow() and br.state == br.OPEN
    clk.advance(5.0)
    assert br.state == br.HALF_OPEN and br.allow()  # probe allowed
    br.record_failure()  # probe failed: re-open with fresh cooldown
    assert not br.allow()
    clk.advance(5.0)
    br.record_success()  # probe succeeded
    assert br.state == br.CLOSED and br.failures == 0


# --------------------------------------------------------------- admission
class TestAdmission:
    def test_duplicate_and_stale_seqs_dropped(self, tmp_path):
        fe = make_front(tmp_path)
        fe.attach("a")
        assert fe.submit("a", scene(0)) == Admission.ACCEPTED
        assert fe.submit("a", scene(0), seq=0) == Admission.DUPLICATE
        fe.pump()
        assert fe.submit("a", scene(1)) == Admission.ACCEPTED  # seq 1
        assert fe.submit("a", scene(0), seq=0) == Admission.DUPLICATE
        assert fe.stats.duplicates == 2

    def test_drop_oldest_replaces(self, tmp_path):
        fe = make_front(tmp_path, queue_depth=2, degrade_at=1.5,
                        coast_at=1.75, reject_at=2.0)
        fe.attach("a")
        fe.submit("a", scene(0))
        fe.submit("a", scene(1))
        assert fe.submit("a", scene(2)) == Admission.REPLACED_OLDEST
        assert [r.seq for r in fe.tenants["a"].queue] == [1, 2]

    def test_queue_full_rejects_without_drop_oldest(self, tmp_path):
        fe = make_front(tmp_path, queue_depth=2, drop_oldest=False,
                        degrade_at=1.5, coast_at=2.0, reject_at=3.0)
        fe.attach("a")
        fe.submit("a", scene(0))
        fe.submit("a", scene(1))
        assert fe.submit("a", scene(2)) == Admission.REJECTED_QUEUE_FULL
        assert [r.seq for r in fe.tenants["a"].queue] == [0, 1]

    def test_overload_rejects_at_ladder_top(self, tmp_path):
        fe = make_front(tmp_path, queue_depth=4, degrade_at=0.2,
                        coast_at=0.3, reject_at=0.5)
        fe.attach("a")
        fe.submit("a", scene(0))
        fe.submit("a", scene(1))  # load now 0.5 -> REJECT
        assert fe.effective_tier() == ServiceTier.REJECT
        assert fe.submit("a", scene(2)) == Admission.REJECTED_OVERLOAD

    def test_attach_beyond_capacity_rejected(self, tmp_path):
        fe = make_front(tmp_path, n_shards=1, lanes_per_shard=2)
        assert fe.attach("a") == Admission.ACCEPTED
        assert fe.attach("b") == Admission.ACCEPTED
        assert fe.attach("c") == Admission.REJECTED_NO_CAPACITY
        fe.detach("a")
        assert fe.attach("c") == Admission.ACCEPTED

    def test_expired_deadline_shed_before_dispatch(self, tmp_path):
        clk = FakeClock()
        fe = make_front(tmp_path, clk=clk)
        fe.attach("a")
        fe.submit("a", scene(0), deadline=clk() + 0.05)
        clk.advance(0.1)
        ups = fe.pump()
        assert "a" not in ups
        assert fe.stats.expired == 1 and fe.stats.applied == 0


# --------------------------------------------------------------- the pump
class TestPump:
    def test_tenant_isolation_identical_scenes(self, tmp_path):
        """Two tenants fed the SAME measurements produce bitwise the
        same independent streams — the fused dispatch leaks nothing
        across lanes (the no-shared-C-slot property, observed)."""
        fe = make_front(tmp_path, n_shards=1, lanes_per_shard=2)
        fe.attach("a")
        fe.attach("b")
        for f in range(6):
            z = scene(f)
            fe.submit("a", z)
            fe.submit("b", z)
            ups = fe.pump()
            sa, sb = ups["a"].snapshots, ups["b"].snapshots
            assert len(sa) == len(sb)
            for ta, tb in zip(sa, sb):
                np.testing.assert_array_equal(ta.state, tb.state)
                # same local id, disjoint global namespaces
                assert ta.track_id % NS_STRIDE == tb.track_id % NS_STRIDE
                assert ta.track_id // NS_STRIDE != tb.track_id // NS_STRIDE

    def test_idle_lane_frozen_not_coasted(self, tmp_path):
        """A tenant with nothing queued must not have its tracks aged
        by other tenants' pumps: its stream is frame-indexed."""
        fe = make_front(tmp_path, n_shards=1, lanes_per_shard=2)
        fe.attach("a")
        fe.attach("b")
        for f in range(4):  # a confirms some tracks
            fe.submit("a", scene(f))
            fe.submit("b", scene(f + 100))
            fe.pump()
        lane_before = np.asarray(
            fe.shards[0].banks.age)[..., fe.tenants["a"].lane, :]
        for f in range(3):  # only b pumps
            fe.submit("b", scene(f + 200))
            fe.pump()
        lane_after = np.asarray(
            fe.shards[0].banks.age)[..., fe.tenants["a"].lane, :]
        np.testing.assert_array_equal(lane_before, lane_after)

    def test_empty_frame_coasts(self, tmp_path):
        fe = make_front(tmp_path)
        fe.attach("a")
        for f in range(4):
            fe.submit("a", scene(f))
            fe.pump()
        fe.submit("a", np.zeros((0, 3), np.float32))  # dark sensor
        ups = fe.pump()
        assert ups["a"].kind == "coast"
        assert fe.stats.coasted == 1

    def test_nan_payload_coasts_instead_of_poisoning(self, tmp_path):
        fe = make_front(tmp_path)
        fe.attach("a")
        for f in range(3):
            fe.submit("a", scene(f))
            fe.pump()
        bad = scene(3)
        bad[0, 0] = np.nan
        bad[1, 1] = np.inf
        fe.submit("a", bad)
        ups = fe.pump()
        lane = fe.tenants["a"].lane
        x = np.asarray(fe.shards[fe.tenants["a"].shard].banks.x)
        assert np.isfinite(x[:, lane]).all(), "NaN reached the bank"
        assert ups["a"].kind == "served"

    def test_ladder_sheds_measurements_under_load(self, tmp_path):
        fe = make_front(tmp_path, queue_depth=4, degrade_at=0.1,
                        coast_at=0.4, reject_at=0.9)
        fe.attach("a")
        for f in range(3):
            fe.submit("a", scene(f))
        assert fe.effective_tier() == ServiceTier.COAST_ONLY
        ups = fe.pump()
        assert ups["a"].kind == "shed"
        assert fe.stats.shed == 1

    def test_checkpoint_cadence(self, tmp_path):
        fe = make_front(tmp_path, checkpoint_every=3)
        fe.attach("a")
        assert fe.stats.checkpoints == 1  # the frame-0 baseline
        for f in range(7):
            fe.submit("a", scene(f))
            fe.pump()
        # baselines at frames 3 and 6 on top of frame 0
        assert fe.stats.checkpoints == 3
        assert len(fe.tenants["a"].wal) == 1  # frame 7 since last snap

    def test_single_model_front_end(self, tmp_path):
        fe = StreamFrontEnd(CV, StreamConfig(n_shards=1,
                                             lanes_per_shard=2),
                            TRACKER, ckpt_dir=str(tmp_path),
                            clock=FakeClock(), devices=("cpu",))
        fe.attach("a")
        for f in range(4):
            fe.submit("a", scene(f))
            ups = fe.pump()
        assert fe.stats.served == 4
        for snap in ups["a"].snapshots:
            assert snap.mode_probs is None


# ------------------------------------------------------- wide-gate variant
def test_wide_gate_tier_uses_scaled_config(tmp_path):
    fe = make_front(tmp_path, queue_depth=4, degrade_at=0.2,
                    coast_at=0.9, reject_at=0.95)
    fe.attach("a")
    fe.submit("a", scene(0))
    fe.submit("a", scene(1))  # load 0.5 -> WIDE_GATE
    assert fe.effective_tier() == ServiceTier.WIDE_GATE
    ups = fe.pump()
    assert ups["a"].tier == ServiceTier.WIDE_GATE
    wide = fe._tier_cfg[ServiceTier.WIDE_GATE]
    assert wide.gate_scale == pytest.approx(
        TRACKER.gate_scale * fe.cfg.wide_gate_scale)
    # the base config is untouched — tiers are separate static configs
    assert fe._tier_cfg[ServiceTier.FULL].gate_scale == TRACKER.gate_scale


# ------------------------------------------------ parity with the reference
def test_public_surface_matches_the_reference():
    import dataclasses
    assert NS_STRIDE == jstream.NS_STRIDE
    assert dataclasses.asdict(StreamConfig()) == dataclasses.asdict(
        jstream.StreamConfig())
    assert [(t.name, int(t)) for t in ServiceTier] == \
        [(t.name, int(t)) for t in jstream.ServiceTier]
    assert [(a.name, a.value) for a in Admission] == \
        [(a.name, a.value) for a in jstream.Admission]
    for cls in ("FrameRequest", "TenantUpdate", "StreamStats"):
        assert [f.name for f in dataclasses.fields(getattr(tstream, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jstream, cls))]


@pytest.mark.parametrize("seed", range(6))
def test_allocator_sequence_matches_the_reference(seed):
    """One seeded interleaving of acquire (with and without a preferred
    shard), release, drop_shard and next_namespace through both
    allocators: every answer and the free lists after every operation
    are identical."""
    rng = np.random.default_rng(seed)
    n_shards, lanes = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    a, b = SlotAllocator(n_shards, lanes), jstream.SlotAllocator(n_shards,
                                                                 lanes)
    for i in range(80):
        op = int(rng.integers(0, 10))
        prefer = (int(rng.integers(0, n_shards)) if rng.random() < 0.3
                  else None)
        if op < 5:
            t = f"t{i}"
            assert a.acquire(t, prefer) == b.acquire(t, prefer)
            assert a.next_namespace() == b.next_namespace()
        elif op < 8 and a.where:
            t = sorted(a.where)[int(rng.integers(0, len(a.where)))]
            assert a.release(t) == b.release(t)
        elif op == 9:
            s = int(rng.integers(0, n_shards))
            for t in a.tenants_on(s):
                assert a.release(t) == b.release(t)
            a.drop_shard(s)
            b.drop_shard(s)
        assert a.free == b.free and a.where == b.where
        assert a.capacity() == b.capacity()
        for s in range(n_shards):
            assert a.tenants_on(s) == b.tenants_on(s)


@pytest.mark.parametrize("seed", range(4))
def test_ladder_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    lo, mid, hi = np.sort(rng.uniform(0.01, 1.0, 3))
    ours = DegradationLadder(lo, mid, hi)
    theirs = jstream.DegradationLadder(lo, mid, hi)
    loads = np.concatenate([rng.uniform(0.0, 1.5, 200), [lo, mid, hi]])
    assert [int(ours.tier_for(x)) for x in loads] == \
        [int(theirs.tier_for(x)) for x in loads]


@pytest.mark.parametrize("seed", range(4))
def test_breaker_sequence_matches_the_reference(seed):
    """A seeded sequence of failures, successes and clock steps: the
    same state, allow(), failure count and trips after every step."""
    rng = np.random.default_rng(seed)
    clocks = (FakeClock(), FakeClock())
    ours = CircuitBreaker(3, 5.0, clocks[0])
    theirs = jstream.CircuitBreaker(3, 5.0, clocks[1])
    for _ in range(300):
        op, dt = int(rng.integers(0, 3)), float(rng.uniform(0.0, 3.0))
        for br, clk in ((ours, clocks[0]), (theirs, clocks[1])):
            if op == 0:
                br.record_failure()
            elif op == 1:
                br.record_success()
            else:
                clk.advance(dt)
        assert (ours.state, ours.allow(), ours.failures, ours.trips) == \
            (theirs.state, theirs.allow(), theirs.failures, theirs.trips)


def test_default_device_needs_a_card(tmp_path):
    """Without ``devices`` the front end serves on the card: it raises
    without one instead of running on the CPU."""
    if torch.cuda.is_available():
        fe = StreamFrontEnd(MODEL, StreamConfig(n_shards=1), TRACKER,
                            ckpt_dir=str(tmp_path), clock=FakeClock())
        assert fe.shards[0].banks.x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            StreamFrontEnd(MODEL, StreamConfig(n_shards=1), TRACKER,
                           ckpt_dir=str(tmp_path), clock=FakeClock())
    fe = StreamFrontEnd(MODEL, StreamConfig(n_shards=2), TRACKER,
                        ckpt_dir=str(tmp_path), clock=FakeClock(),
                        devices=("cpu",))
    assert [sh.device.type for sh in fe.shards] == ["cpu", "cpu"]
    assert all(sh.banks.x.device.type == "cpu" for sh in fe.shards)
