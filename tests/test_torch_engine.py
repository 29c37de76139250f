"""The port's serving engine against the JAX engine over the same scene
(snapshot ids, hits, ages, states, mode probabilities), and carrying a
JAX bank across to the port mid-scene (``convert``) continues with
identical association."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jb
from repro.core import tracker as jtr
from repro.serving.engine import TrackingEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import tracker as ttr
from repro_torch.serving.engine import TrackingEngine

from _torch_parity import models, np_, t32
from test_torch_tracker import ATOL, scene

CFG_J = jtr.TrackerConfig(capacity=24, max_meas=16)
CFG_T = ttr.TrackerConfig(capacity=24, max_meas=16)
CFG32_J = jtr.TrackerConfig(capacity=32, max_meas=16)
CFG32_T = dataclasses.replace(CFG_T, capacity=32)


@pytest.mark.parametrize("kind", ["lkf", "imm"])
def test_engine_snapshots_match_jax(kind):
    jm, tm, _, _ = models(kind)
    z, valid = scene(kind, seed=21)
    ej = JaxEngine(jm, CFG_J)
    et = TrackingEngine(tm, CFG_T, device="cpu")
    seen = 0
    for t in range(40):
        meas = z[t][valid[t]]
        sj, st = ej.submit(meas), et.submit(meas)
        assert [s.track_id for s in st] == [s.track_id for s in sj]
        assert [(s.hits, s.age) for s in st] == [(s.hits, s.age) for s in sj]
        for a, b in zip(sj, st):
            np.testing.assert_allclose(b.state, a.state, atol=ATOL[kind])
            if kind == "imm":
                np.testing.assert_allclose(b.mode_probs, a.mode_probs,
                                           atol=ATOL[kind])
            else:
                assert b.mode_probs is None
        seen += len(st)
    assert seen > 5
    assert et.stats.frames == 40 and et.stats.fps > 0
    assert et.stats.measurements == ej.stats.measurements


@pytest.mark.parametrize("kind", ["ekf", "imm"])
def test_convert_carries_a_jax_bank_across(kind):
    jm, _, _, _ = models(kind)
    z, valid = scene(kind, seed=8)
    is_imm = kind == "imm"
    if is_imm:
        tm = convert.imm_model_from_numpy(
            jm.name, [dict(vars(m)) for m in jm.models], jm.trans, jm.mu0)
        jbank = jb.init_imm_bank(jm, 32)
        jstep = jax.jit(lambda b, z, v: jtr.imm_frame_step(jm, CFG32_J, b, z,
                                                           v))
        tstep = ttr.imm_frame_step
    else:
        tm = convert.filter_model_from_numpy(jm)
        jbank = jb.init_bank(jm, 32)
        jstep = jax.jit(lambda b, z, v: jtr.frame_step(jm, CFG32_J, b, z, v))
        tstep = ttr.frame_step
    for t in range(15):
        jbank = jstep(jbank, jnp.asarray(z[t]), jnp.asarray(valid[t])).bank
    fields = {k: np.asarray(v) for k, v in jbank._asdict().items()}
    tbank = convert.bank_from_numpy(fields, device="cpu")
    back = convert.bank_to_numpy(tbank)
    for k, v in fields.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    for t in range(15, 35):
        rj = jstep(jbank, jnp.asarray(z[t]), jnp.asarray(valid[t]))
        rt = tstep(tm, CFG32_T, tbank, t32(z[t]), torch.as_tensor(valid[t]))
        np.testing.assert_array_equal(np_(rt.assoc), np.asarray(rj.assoc))
        np.testing.assert_array_equal(np_(rt.bank.track_id),
                                      np.asarray(rj.bank.track_id))
        np.testing.assert_allclose(np_(rt.bank.x), np.asarray(rj.bank.x),
                                   atol=ATOL[kind])
        jbank, tbank = rj.bank, rt.bank


def test_convert_rejects_an_unknown_nonlinear_model():
    jm, _, _, _ = models("ekf")
    with pytest.raises(KeyError):
        convert.filter_model_from_numpy(dict(vars(jm), name="mystery"))
