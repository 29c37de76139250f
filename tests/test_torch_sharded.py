"""The port's multi-sensor serving (``core.bank``'s sensor-axis helpers,
``core.tracker.make_multi_sensor_step``, ``serving.engine.
ShardedBankEngine``) on the CPU, at the reference's test sizes
(``tests/test_sharded_imm.py``: capacity 8, max_meas 4, S = 2-8):

  * the fleet is bit for bit a loop of the port's own single-sensor frame
    steps (assoc, ids, x, P, mu, x_est) for imm, lkf and ekf;
  * it matches the reference's ShardedBankEngine without a mesh: its
    einsum fleet (``fused_frame=False``) over every workload and, in one
    short case, its fused fleet (identical assoc, ids and confirmed;
    states within 5e-4);
  * four CPU shards are bit for bit one shard; sensors that do not divide
    over the devices raise;
  * the K = 1 IMM reduces to the single-model fleet, and sensors that
    disagree on spawn and prune keep their own ids, on one shard and four;
  * ``replay`` equals per-sensor ``replay_imm_bank`` on a coasting-masked
    stream and the reference's sharded replay;
  * the four sensor-axis helpers equal the reference's, and the lifecycle
    glue without a sensor axis is bit for bit the op stream it replaced.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import filters as jf
from repro.core.tracker import TrackerConfig as JCfg
from repro.serving.engine import ShardedBankEngine as JEngine
from repro_torch.core import bank as tb
from repro_torch.core import filters as tf
from repro_torch.core import tracker as ttr
from repro_torch.serving.engine import ShardedBankEngine

from _torch_parity import models, np_, t32

CFG = ttr.TrackerConfig(capacity=8, max_meas=4)
JCFG = JCfg(capacity=8, max_meas=4)
TOL = 5e-4


def _fleet_scene(S, T, m=3, seed=0, targets=2, drop=()):
    """(T, S, max_meas, m) streams of ``targets`` slow walkers per sensor
    (the reference test's scene); ``drop`` lists (sensor, first frame)
    pairs after which that sensor sees nothing."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(S, targets, m)) * 3
    z = np.zeros((T, S, CFG.max_meas, m), np.float32)
    v = np.zeros((T, S, CFG.max_meas), bool)
    for t in range(T):
        pos = pos + 0.05
        z[t, :, :targets] = pos + rng.normal(size=pos.shape) * 0.05
        v[t, :, :targets] = True
        for s, t0 in drop:
            if t >= t0:
                v[t, s] = False
    return z, v


def _single_steps(model, z, v, cfg=CFG):
    """The port's single-sensor frame steps per sensor, banks never
    stacked: yields each frame's list of S FrameResults."""
    is_imm = isinstance(model, tf.IMMModel)
    init = tb.init_imm_bank if is_imm else tb.init_bank
    step = ttr.imm_frame_step if is_imm else ttr.frame_step
    banks = [init(model, cfg.capacity, device="cpu")
             for _ in range(z.shape[1])]
    for t in range(z.shape[0]):
        out = []
        for s, bank in enumerate(banks):
            r = step(model, cfg, bank, torch.from_numpy(z[t, s]),
                     torch.from_numpy(v[t, s]))
            banks[s] = r.bank
            out.append(r)
        yield out


def _assert_sensor_equal(res, s, r):
    """Sensor s of a fleet FrameResult bit for bit one sensor's."""
    assert torch.equal(res.assoc[s], r.assoc)
    assert torch.equal(res.confirmed[s], r.confirmed)
    assert torch.equal(res.unassigned[s], r.unassigned)
    for a, b in zip(tb.slice_sensor_bank(res.bank, s), r.bank):
        assert torch.equal(a, b)
    if r.x_est is not None:
        assert torch.equal(res.x_est[s], r.x_est)
        assert torch.equal(res.mode_probs[s], r.mode_probs)


@pytest.mark.parametrize("kind", ["imm", "lkf", "ekf"])
def test_fleet_is_the_per_sensor_loop_bitwise(kind):
    _, model, _, _ = models(kind)
    z, v = _fleet_scene(S=3, T=10, m=model.m, seed=1, drop=((1, 5),))
    eng = ShardedBankEngine(model, 3, CFG, devices=("cpu",))
    assert eng.is_imm == (kind == "imm")
    assert eng.banks.track_id.shape == (3, CFG.capacity)
    if kind == "imm":
        assert eng.banks.x.shape == (model.K, 3, CFG.capacity, model.n)
    for t, singles in enumerate(_single_steps(model, z, v)):
        res = eng.frame(z[t], v[t])
        for s, r in enumerate(singles):
            _assert_sensor_equal(res, s, r)
    assert eng.stats.frames == 10
    assert eng.stats.measurements == int(v.sum())


def _j_engine(jmodel, S, fused):
    return JEngine(jmodel, S, dataclasses.replace(JCFG, fused_frame=fused))


def _assert_like_reference(res, jres, is_imm):
    np.testing.assert_array_equal(np_(res.assoc), np.asarray(jres.assoc))
    np.testing.assert_array_equal(np_(res.bank.track_id),
                                  np.asarray(jres.bank.track_id))
    np.testing.assert_array_equal(np_(res.confirmed),
                                  np.asarray(jres.confirmed))
    np.testing.assert_allclose(np_(res.bank.x), np.asarray(jres.bank.x),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(np_(res.bank.P), np.asarray(jres.bank.P),
                               atol=TOL, rtol=0)
    if is_imm:
        np.testing.assert_allclose(np_(res.x_est), np.asarray(jres.x_est),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(np_(res.mode_probs),
                                   np.asarray(jres.mode_probs), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["imm", "lkf", "ekf"])
def test_fleet_matches_reference_einsum_fleet(kind):
    """Against the reference's unsharded fleet on its einsum route (plain
    XLA; its own tests hold it equal in assoc and ids to its fused
    fleet)."""
    jmodel, model, _, _ = models(kind)
    S, T = 3, 10
    z, v = _fleet_scene(S=S, T=T, m=model.m, seed=2, drop=((2, 6),))
    eng = ShardedBankEngine(model, S, CFG, devices=("cpu",))
    jeng = _j_engine(jmodel, S, fused=False)
    for t in range(T):
        _assert_like_reference(eng.frame(z[t], v[t]),
                               jeng.frame(z[t], v[t]), kind == "imm")


def test_fleet_matches_reference_fused_fleet():
    """One short case against the reference's fused fleet (its
    katana_imm_frame_step vmapped over the sensors, Pallas in interpret
    mode)."""
    jmodel, model, _, _ = models("imm")
    z, v = _fleet_scene(S=2, T=6, seed=3)
    eng = ShardedBankEngine(model, 2, CFG, devices=("cpu",))
    jeng = _j_engine(jmodel, 2, fused=True)
    for t in range(6):
        _assert_like_reference(eng.frame(z[t], v[t]),
                               jeng.frame(z[t], v[t]), True)


@pytest.mark.parametrize("kind", ["imm", "lkf"])
def test_four_cpu_shards_equal_one_bitwise(kind):
    _, model, _, _ = models(kind)
    S, T = 8, 8
    z, v = _fleet_scene(S=S, T=T, m=model.m, seed=4, drop=((5, 3),))
    one = ShardedBankEngine(model, S, CFG, devices=("cpu",))
    four = ShardedBankEngine(model, S, CFG, devices=("cpu",) * 4)
    assert [sl.stop - sl.start for _, sl in four._blocks] == [2] * 4
    for t in range(T):
        r1, r4 = one.frame(z[t], v[t]), four.frame(z[t], v[t])
        for a, b in zip(r1.bank, r4.bank):
            assert torch.equal(a, b)
        for a, b in zip(r1[1:], r4[1:]):
            assert (a is None and b is None) or torch.equal(a, b)
    zs = np.random.default_rng(5).normal(
        size=(6, S, CFG.capacity, model.m)).astype(np.float32)
    np.testing.assert_array_equal(one.replay(zs), four.replay(zs))


def test_sensors_must_divide_over_the_devices():
    with pytest.raises(ValueError, match="n_sensors=6 must divide"):
        ShardedBankEngine(tf.make_imm(), 6, CFG, devices=("cpu",) * 4)


def test_engine_defaults_to_the_card():
    """devices defaults to ("cuda",): without a card it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        eng = ShardedBankEngine(tf.get_filter("lkf"), 2, CFG)
        assert eng.banks.x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedBankEngine(tf.get_filter("lkf"), 2, CFG)
        with pytest.raises(RuntimeError, match="cuda"):
            ttr.make_multi_sensor_step(tf.get_filter("lkf"), CFG)


@pytest.mark.parametrize("shards", [1, 4])
def test_k1_reduces_to_the_single_model_fleet(shards):
    """as_imm(cv9) at K = 1 runs the single-model frame with mu passed
    through: ids, confirmed and the combined estimate bit for bit the
    cv9 fleet's, mode probabilities all one."""
    cv9 = tf.get_filter("cv9")
    S, T = 4, 8
    z, v = _fleet_scene(S=S, T=T, seed=6)
    devs = ("cpu",) * shards
    plain = ShardedBankEngine(cv9, S, CFG, devices=devs)
    k1 = ShardedBankEngine(tf.as_imm(cv9), S, CFG, devices=devs)
    assert not plain.is_imm and k1.is_imm
    for t in range(T):
        rp, rk = plain.frame(z[t], v[t]), k1.frame(z[t], v[t])
        assert torch.equal(rp.bank.track_id, rk.bank.track_id)
        assert torch.equal(rp.confirmed, rk.confirmed)
        assert torch.equal(rk.x_est, rp.bank.x)
    assert rp.mode_probs is None
    assert torch.equal(rk.mode_probs, torch.ones((S, CFG.capacity, 1)))


@pytest.mark.parametrize("shards", [1, 4])
def test_multi_sensor_lifecycle_disagreement(shards):
    """Sensor 1 goes dark at frame 4 (coast, then prune), sensor 2 sees
    nothing until frame 6 (late spawn): per-sensor ids and activity stay
    those of the single-sensor steps every frame, live ids unique, the
    id counters independent."""
    imm = tf.make_imm()
    cfg = ttr.TrackerConfig(capacity=8, max_meas=4, max_misses=3)
    S, T = 4, 14
    z, v = _fleet_scene(S=S, T=T, seed=9, drop=((1, 4),))
    v[:6, 2] = False
    eng = ShardedBankEngine(imm, S, cfg, devices=("cpu",) * shards)
    for t, singles in enumerate(_single_steps(imm, z, v, cfg)):
        res = eng.frame(z[t], v[t])
        for s, r in enumerate(singles):
            _assert_sensor_equal(res, s, r)
        ids, act = res.bank.track_id, res.bank.active
        for s in range(S):
            live = ids[s][act[s]].tolist()
            assert len(live) == len(set(live))
    active = eng.banks.active
    assert not bool(active[1].any())
    assert int(active[2].sum()) == 2
    assert int(active[0].sum()) == 2 and int(active[3].sum()) == 2
    assert eng.banks.next_id.shape == (S,)
    assert eng.banks.next_id.dtype == torch.int32
    assert int(eng.banks.next_id[0]) == 2 and int(eng.banks.next_id[2]) == 2
    mu = eng.banks.mu[active]
    torch.testing.assert_close(mu.sum(-1), torch.ones(mu.shape[0]),
                               atol=1e-5, rtol=0)


def _live_fleet(S, T=4, seed=6):
    imm = tf.make_imm()
    z, v = _fleet_scene(S=S, T=T, seed=seed)
    eng = ShardedBankEngine(imm, S, CFG, devices=("cpu",) * (S // 2))
    for t in range(T):
        eng.frame(z[t], v[t])
    return imm, eng


@pytest.mark.parametrize("S", [2, 8])
def test_replay_matches_per_sensor_replay_imm_bank(S):
    """One katana_imm_sequence per shard over its sensors flattened onto
    the track axis, seeded from the live banks, against per-sensor
    replay_imm_bank on a coasting-masked stream; the live banks are
    untouched and the frames count apart."""
    imm, eng = _live_fleet(S)
    rng = np.random.default_rng(8)
    T2 = 10
    zs = (rng.normal(size=(T2, S, CFG.capacity, imm.m)) * 0.5
          ).astype(np.float32)
    valid = rng.random((T2, S, CFG.capacity)) > 0.4
    valid[3] = False  # a whole coasted frame, fleet-wide
    before = [t.clone() for t in eng.banks]
    out = eng.replay(zs, valid)
    assert out.shape == (T2, S, CFG.capacity, imm.n)
    assert np.isfinite(out).all()
    for s in range(S):
        want = tb.replay_imm_bank(imm, tb.slice_sensor_bank(eng.banks, s),
                                  torch.from_numpy(zs[:, s]),
                                  valid=torch.from_numpy(valid[:, s]))
        np.testing.assert_allclose(out[:, s], np_(want), atol=1e-6,
                                   rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(before, eng.banks))
    assert eng.stats.replay_frames == T2 and eng.stats.frames == 4


def _to_jax_bank(bank):
    cls = jbank.IMMBankState if isinstance(bank, tb.IMMBankState) \
        else jbank.BankState
    return cls(*(jnp.asarray(np_(leaf)) for leaf in bank))


def test_replay_matches_the_reference_sharded_replay():
    """The same live banks through the reference's ShardedBankEngine.replay
    (its katana_imm_sequence over the flattened sensors)."""
    imm, eng = _live_fleet(2)
    jeng = _j_engine(jf.make_imm(), 2, fused=False)
    jeng.banks = _to_jax_bank(eng.banks)
    rng = np.random.default_rng(12)
    zs = (rng.normal(size=(8, 2, CFG.capacity, imm.m)) * 0.5
          ).astype(np.float32)
    valid = rng.random((8, 2, CFG.capacity)) > 0.3
    np.testing.assert_allclose(eng.replay(zs, valid),
                               jeng.replay(zs, valid), atol=1e-5, rtol=1e-5)


def _random_bank(kind, C=5, seed=0):
    """A port bank with every leaf drawn from a seed."""
    rng = np.random.default_rng(seed)
    _, model, _, _ = models(kind)
    n = model.n
    i32 = dict(dtype=torch.int32)
    life = dict(active=torch.from_numpy(rng.random(C) < 0.5),
                hits=torch.as_tensor(rng.integers(0, 5, C), **i32),
                misses=torch.as_tensor(rng.integers(0, 5, C), **i32),
                age=torch.as_tensor(rng.integers(0, 9, C), **i32),
                track_id=torch.as_tensor(rng.integers(-1, 9, C), **i32),
                next_id=torch.tensor(int(rng.integers(0, 9)), **i32))
    if kind == "imm":
        K = model.K
        return tb.IMMBankState(
            x=t32(rng.normal(size=(K, C, n))),
            P=t32(rng.normal(size=(K, C, n, n))),
            mu=t32(rng.dirichlet(np.ones(K), size=C)), **life)
    return tb.BankState(x=t32(rng.normal(size=(C, n))),
                        P=t32(rng.normal(size=(C, n, n))), **life)


@pytest.mark.parametrize("kind", ["lkf", "imm"])
def test_sensor_axis_helpers_match_the_reference(kind):
    """bank_sensor_axes, stack_sensor_banks, slice_sensor_bank and
    place_sensor_bank against the reference's on the same banks; the
    round trip slice(place(stack, s, one), s) == one, and place leaves
    its inputs untouched."""
    one, other = _random_bank(kind, seed=1), _random_bank(kind, seed=2)
    j_one, j_other = _to_jax_bank(one), _to_jax_bank(other)
    assert tuple(tb.bank_sensor_axes(one)) == tuple(
        jbank.bank_sensor_axes(j_one))
    stack = tb.stack_sensor_banks(one, 3)
    j_stack = jbank.stack_sensor_banks(j_one, 3)
    for a, b in zip(stack, j_stack):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
        assert a.is_contiguous()
    before = [t.clone() for t in stack]
    placed = tb.place_sensor_bank(stack, 1, other)
    j_placed = jbank.place_sensor_bank(j_stack, 1, j_other)
    for a, b in zip(placed, j_placed):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in zip(before, stack))
    for s in range(3):
        got = tb.slice_sensor_bank(placed, s)
        want = jbank.slice_sensor_bank(j_placed, s)
        for a, b, c in zip(got, want, other if s == 1 else one):
            np.testing.assert_array_equal(np_(a), np.asarray(b))
            assert torch.equal(a, c)
    # the slice shares no memory with the stack
    cut = tb.slice_sensor_bank(placed, 0)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(cut, placed))


# The lifecycle glue's op stream before it took a sensor axis, copied
# as it was: the glue without a sensor axis must stay bit for bit this.

def _old_spawn_plan(active, unassigned):
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    meas_rank = torch.cumsum(unassigned.to(torch.int32), 0,
                             dtype=torch.int32) - 1
    take = (free[:, None] & unassigned[None, :]
            & (free_rank[:, None] == meas_rank[None, :]))
    return take, take.any(dim=1), free_rank


def _old_spawn_init_state(model, take, z):
    j = take.to(torch.int32).argmax(dim=1)
    zsel = torch.where(take.any(dim=1)[:, None], z[j.long()],
                       torch.zeros((), dtype=z.dtype))
    Ht = t32(np.asarray(model.H).T)
    unobs = 1.0 - Ht.sum(dim=1)
    return zsel @ Ht.T + t32(model.x0) * unobs


def _old_spawn_fields(bank, takes_any, free_rank):
    i32 = dict(dtype=torch.int32)
    return dict(
        active=bank.active | takes_any,
        hits=torch.where(takes_any, torch.ones((), **i32), bank.hits),
        misses=torch.where(takes_any, torch.zeros((), **i32), bank.misses),
        age=torch.where(takes_any, torch.zeros((), **i32), bank.age),
        track_id=torch.where(takes_any, bank.next_id + free_rank,
                             bank.track_id),
        next_id=bank.next_id + takes_any.sum(dtype=torch.int32))


def _old_spawn(model, bank, z, unassigned):
    take, takes_any, free_rank = _old_spawn_plan(bank.active, unassigned)
    mdl = model.models[0] if isinstance(model, tf.IMMModel) else model
    x_init = _old_spawn_init_state(mdl, take, z)
    fields = _old_spawn_fields(bank, takes_any, free_rank)
    if isinstance(bank, tb.IMMBankState):
        return bank._replace(
            x=torch.where(takes_any[None, :, None], x_init[None], bank.x),
            P=torch.where(takes_any[None, :, None, None], t32(model.P0),
                          bank.P),
            mu=torch.where(takes_any[:, None], t32(model.mu0), bank.mu),
            **fields)
    return bank._replace(
        x=torch.where(takes_any[:, None], x_init, bank.x),
        P=torch.where(takes_any[:, None, None], t32(model.P0), bank.P),
        **fields)


def _old_unassigned(assoc, z_valid, max_meas):
    taken = torch.zeros((max_meas,), dtype=torch.int32)
    taken = taken.scatter_reduce(0, assoc.clamp(0, max_meas - 1).long(),
                                 (assoc >= 0).to(torch.int32), reduce="amax")
    return z_valid & ~taken.bool()


def _glue_inputs(kind, seed, S=None):
    """A bank, z (M, m), unassigned (M,) and assoc (C,), or S of each
    stacked on the sensor axis."""
    if S is not None:
        per = [_glue_inputs(kind, seed + s) for s in range(S)]
        bank = tb.stack_sensor_banks(per[0][0], S)
        for s in range(1, S):
            bank = tb.place_sensor_bank(bank, s, per[s][0])
        return (bank,) + tuple(torch.stack([p[i] for p in per])
                               for i in (1, 2, 3))
    rng = np.random.default_rng(seed)
    bank = _random_bank(kind, C=9, seed=seed)
    _, model, _, _ = models(kind)
    M = 6
    z = t32(rng.normal(size=(M, model.m)))
    unassigned = torch.from_numpy(rng.random(M) < 0.6)
    assoc = torch.as_tensor(rng.integers(-1, M, 9), dtype=torch.int32)
    return bank, z, unassigned, assoc


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_glue_without_a_sensor_axis_is_the_old_op_stream(kind):
    _, model, _, _ = models(kind)
    spawn = tb.spawn_imm_tracks if kind == "imm" else tb.spawn_tracks
    for seed in range(4):
        bank, z, unassigned, assoc = _glue_inputs(kind, seed)
        got, want = spawn(model, bank, z, unassigned), _old_spawn(
            model, bank, z, unassigned)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(ttr._unassigned(assoc, unassigned, z.shape[0]),
                           _old_unassigned(assoc, unassigned, z.shape[0]))


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_glue_over_a_sensor_axis_is_per_sensor(kind):
    """lifecycle_counters, spawn, prune and the unassigned mask over a
    leading sensor axis: each sensor bit for bit its own call."""
    _, model, _, _ = models(kind)
    spawn = tb.spawn_imm_tracks if kind == "imm" else tb.spawn_tracks
    S = 3
    bank, z, unassigned, assoc = _glue_inputs(kind, 10, S=S)
    fleet = dict(
        counters=tb.lifecycle_counters(bank, assoc),
        spawn=spawn(model, bank, z, unassigned),
        prune=tb.prune_bank(bank, 2),
        unassigned=ttr._unassigned(assoc, unassigned, z.shape[-2]))
    for s in range(S):
        one = tb.slice_sensor_bank(bank, s)
        want = dict(
            counters=tb.lifecycle_counters(one, assoc[s]),
            spawn=spawn(model, one, z[s], unassigned[s]),
            prune=tb.prune_bank(one, 2),
            unassigned=ttr._unassigned(assoc[s], unassigned[s],
                                       z.shape[-2]))
        for a, b in zip(fleet["counters"], want["counters"]):
            assert torch.equal(a[s], b)
        for key in ("spawn", "prune"):
            for a, b in zip(tb.slice_sensor_bank(fleet[key], s), want[key]):
                assert torch.equal(a, b), key
        assert torch.equal(fleet["unassigned"][s], want["unassigned"])


def test_einsum_route_fleet_stacks_the_single_steps():
    """fused_frame=False (the oracle) runs the single-sensor step per
    sensor and stacks the results: the same FrameResult layout, and the
    same assoc and ids as the fused fleet."""
    imm = tf.make_imm()
    cfg_e = dataclasses.replace(CFG, fused_frame=False)
    one, axes, step = ttr.make_multi_sensor_step(imm, cfg_e, device="cpu")
    assert tuple(axes) == tuple(tb.bank_sensor_axes(one))
    _, _, fused = ttr.make_multi_sensor_step(imm, CFG, device="cpu")
    z, v = _fleet_scene(S=2, T=5, seed=14)
    be = bf = tb.stack_sensor_banks(one, 2)
    for t in range(5):
        re = step(be, torch.from_numpy(z[t]), torch.from_numpy(v[t]))
        rf = fused(bf, torch.from_numpy(z[t]), torch.from_numpy(v[t]))
        assert re.mode_probs.shape == (2, CFG.capacity, imm.K)
        assert re.x_est.shape == (2, CFG.capacity, imm.n)
        assert torch.equal(re.assoc, rf.assoc)
        assert torch.equal(re.bank.track_id, rf.bank.track_id)
        torch.testing.assert_close(re.x_est, rf.x_est, atol=TOL, rtol=0)
        be, bf = re.bank, rf.bank
