"""Twins of the reference's jitted-tracker tests
(``tests/test_tracker.py::test_mot_end_to_end`` and
``::test_bank_static_shapes_single_jit``) on the port's
``make_jitted_tracker`` with ``device="cpu"``. Each keeps the reference
test's assertions and is also held, frame by frame, to the reference's
jitted tracker on the same inputs (``_torch_parity.run_jitted_both``:
identical assoc, track ids and lifecycle, states within 1e-5 of their
scale). The CUDA-graph capture itself (one capture, captured equal to
eager bit for bit) needs the card: ``tests/test_torch_gpu.py``; the IMM
twins are ``test_torch_jitted_imm_*.py``."""
import numpy as np
import pytest
import torch

from repro.core import filters as jf
from repro.core import tracker as jtr
from repro.data import trajectories as jt
from repro_torch.core import filters as tf
from repro_torch.core import tracker as ttr
from repro_torch.core import make_jitted_tracker

from _torch_parity import np_, run_jitted_both


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_mot_end_to_end(kind):
    """Tracker locks onto the true number of targets in a noisy scene."""
    cfg = ttr.TrackerConfig(capacity=32, max_meas=16)
    jcfg = jtr.TrackerConfig(capacity=32, max_meas=16)
    scene = jt.SceneConfig(T=80, max_targets=4, max_meas=16,
                           clutter_rate=0.3, death_rate=0.0)
    z, valid, truth = jt.mot_scene(jf.get_filter(kind), scene, seed=7)
    init, step = make_jitted_tracker(tf.get_filter(kind), cfg, device="cpu")
    jinit, jstep = jtr.make_jitted_tracker(jf.get_filter(kind), jcfg)
    res, _ = run_jitted_both(jstep, jinit(), step, init(),
                             [(z[t], valid[t]) for t in range(scene.T)],
                             False)
    bank = res.bank
    assert abs(int(res.confirmed.sum()) - len(truth[-1])) <= 1
    # slot-conservation invariant: ids never reused while active
    ids = np_(bank.track_id)[np_(bank.active)]
    assert len(ids) == len(set(ids.tolist()))
    assert step.captures == 0  # the CPU step is the frame step itself


def test_bank_static_shapes_single_jit():
    """The whole frame step is one call per frame with static shapes; on
    the CPU it is the frame step itself (no graph: one capture on a card
    is ``test_torch_gpu.py::test_jitted_tracker_captures_once``)."""
    model = tf.get_filter("lkf")
    cfg = ttr.TrackerConfig(capacity=16, max_meas=8)
    init, step = make_jitted_tracker(model, cfg, device="cpu")
    jinit, jstep = jtr.make_jitted_tracker(
        jf.get_filter("lkf"), jtr.TrackerConfig(capacity=16, max_meas=8))
    bank, jbank = init(), jinit()
    shapes = [tuple(t.shape) for t in bank]
    z = np.zeros((8, 3), np.float32)
    v = np.zeros((8,), bool)
    rt, _ = run_jitted_both(jstep, jbank, step, bank, [(z, v)] * 4, False)
    assert [tuple(t.shape) for t in rt.bank] == shapes
    assert (step.captures, step.replays) == (0, 0)
    eager = ttr.frame_step(model, cfg, bank, torch.as_tensor(z),
                           torch.as_tensor(v))
    for a, b in zip(step(bank, z, v).bank, eager.bank):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
