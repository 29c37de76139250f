"""Port tracker lifecycles against the JAX package, frame by frame over
a 60-frame birth/death/clutter scene: the port's fused route (the plain
versions of the frame kernels on the CPU) and JAX's fused
``frame_step`` (Pallas in interpret mode) give identical assoc,
unassigned, confirmed, track ids, hits and next_id, and states within
the reference's own tolerances; the port's einsum route agrees with its
fused route the same way; a NaN measurement row coasts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jb
from repro.core import tracker as jtr
from repro_torch.core import bank as tb
from repro_torch.core import tracker as ttr
from repro_torch.data import trajectories as tt

from _torch_parity import KINDS, models, np_, t32

T = 60
CFG_J = jtr.TrackerConfig(capacity=32, max_meas=16)
CFG_T = ttr.TrackerConfig(capacity=32, max_meas=16)
CFG_T_EINSUM = dataclasses.replace(CFG_T, fused_frame=False)
ATOL = {"lkf": 1e-4, "ekf": 1e-4, "imm": 5e-4}


def scene(kind, seed=11):
    _, _, smodel, _ = models(kind)
    cfg = tt.SceneConfig(T=T, max_targets=5, max_meas=16, clutter_rate=0.8,
                         death_rate=0.03)
    z, valid, _ = tt.mot_scene(smodel, cfg, seed=seed)
    return z.astype(np.float32), valid


def port_step(kind, cfg):
    _, tm, _, _ = models(kind)
    if kind == "imm":
        return tm, tb.init_imm_bank(tm, cfg.capacity, device="cpu"), \
            lambda b, z, v: ttr.imm_frame_step(tm, cfg, b, z, v)
    return tm, tb.init_bank(tm, cfg.capacity, device="cpu"), \
        lambda b, z, v: ttr.frame_step(tm, cfg, b, z, v)


def assert_frames_equal(ra, rb, atol, imm):
    """ra, rb: FrameResults of either framework."""
    for f in ("assoc", "unassigned", "confirmed"):
        np.testing.assert_array_equal(np_(getattr(ra, f)),
                                      np_(getattr(rb, f)), err_msg=f)
    for f in ("track_id", "hits", "next_id", "active"):
        np.testing.assert_array_equal(np_(getattr(ra.bank, f)),
                                      np_(getattr(rb.bank, f)), err_msg=f)
    np.testing.assert_allclose(np_(ra.bank.x), np_(rb.bank.x), atol=atol)
    np.testing.assert_allclose(np_(ra.bank.P), np_(rb.bank.P), atol=atol)
    if imm:
        np.testing.assert_allclose(np_(ra.mode_probs), np_(rb.mode_probs),
                                   atol=atol)
        np.testing.assert_allclose(np_(ra.x_est), np_(rb.x_est), atol=atol)


def run_against_jax(kind, seed=11):
    jm, _, _, _ = models(kind)
    z, valid = scene(kind, seed)
    if kind == "imm":
        jbank = jb.init_imm_bank(jm, CFG_J.capacity)
        jstep = jax.jit(lambda b, z, v: jtr.imm_frame_step(jm, CFG_J, b, z, v))
    else:
        jbank = jb.init_bank(jm, CFG_J.capacity)
        jstep = jax.jit(lambda b, z, v: jtr.frame_step(jm, CFG_J, b, z, v))
    _, tbank, tstep = port_step(kind, CFG_T)
    spawned = coasted = 0
    for t in range(T):
        rj = jstep(jbank, jnp.asarray(z[t]), jnp.asarray(valid[t]))
        rt = tstep(tbank, t32(z[t]), torch.as_tensor(valid[t]))
        assert_frames_equal(rt, rj, ATOL[kind], kind == "imm")
        spawned += int(np_(rt.unassigned).sum())
        coasted += int(((np_(rt.assoc) < 0) & np_(tbank.active)).sum())
        jbank, tbank = rj.bank, rt.bank
    assert spawned > 5 and coasted > 0  # the lifecycle really ran


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_fused_lifecycle_matches_jax(kind):
    run_against_jax(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_route_matches_einsum_route(kind):
    z, valid = scene(kind, seed=5)
    _, bf, step_f = port_step(kind, CFG_T)
    _, be, step_e = port_step(kind, CFG_T_EINSUM)
    for t in range(T):
        zt, vt = t32(z[t]), torch.as_tensor(valid[t])
        rf, re = step_f(bf, zt, vt), step_e(be, zt, vt)
        assert_frames_equal(rf, re, ATOL[kind], kind == "imm")
        bf, be = rf.bank, re.bank
    assert int(bf.next_id) > 5


def test_nan_row_coasts():
    """A measurement row holding NaN is no detection: the track it would
    have hit coasts (its state stays finite) and nothing spawns from it,
    on both routes alike."""
    _, tm, _, _ = models("lkf")
    for cfg in (CFG_T, CFG_T_EINSUM):
        bank = tb.init_bank(tm, cfg.capacity, device="cpu")
        z = torch.zeros(cfg.max_meas, 3)
        v = torch.zeros(cfg.max_meas, dtype=torch.bool)
        z[0] = torch.tensor([1.0, 2.0, 3.0])
        v[0] = True
        res = ttr.frame_step(tm, cfg, bank, z, v)
        assert int(res.bank.next_id) == 1
        z[0, 1] = float("nan")
        res2 = ttr.frame_step(tm, cfg, res.bank, z, v)
        assert int(res2.assoc[0]) == -1 and not bool(res2.unassigned.any())
        assert int(res2.bank.misses[0]) == 1
        assert torch.isfinite(res2.bank.x).all()
        assert torch.isfinite(res2.bank.P).all()
