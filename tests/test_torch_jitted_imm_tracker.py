"""Twin of the reference's
``tests/test_imm.py::test_imm_tracker_confirms_maneuvering_targets`` on the
port's ``make_jitted_imm_tracker`` with ``device="cpu"``: the
reference test's assertions, and every frame held to the reference's
jitted IMM tracker on the same inputs (``_torch_parity.run_jitted_both``:
identical assoc, track ids and lifecycle; x, P, mu, x_est within 1e-5 of
their scale)."""
import numpy as np

from repro.core import filters as jf
from repro.core import tracker as jtr
from repro.data import trajectories as jt
from repro_torch.core import filters as tf
from repro_torch.core import tracker as ttr
from repro_torch.core import make_jitted_imm_tracker

from _torch_parity import np_, run_jitted_both


def test_imm_tracker_confirms_maneuvering_targets():
    cfg = ttr.TrackerConfig(capacity=16, max_meas=8)
    jcfg = jtr.TrackerConfig(capacity=16, max_meas=8)
    T, N = 60, 3
    truth, zs = jt.maneuvering_batch(T, N, seed=5)
    init, step = make_jitted_imm_tracker(tf.make_imm(), cfg, device="cpu")
    jinit, jstep = jtr.make_jitted_imm_tracker(jf.make_imm(), jcfg)
    frames = []
    for t in range(T):
        z = np.zeros((cfg.max_meas, 3), np.float32)
        v = np.zeros(cfg.max_meas, bool)
        z[:N] = zs[t]
        v[:N] = True
        frames.append((z, v))
    res, _ = run_jitted_both(jstep, jinit(), step, init(), frames, True)
    conf = np_(res.confirmed)
    assert int(conf.sum()) == N
    # combined estimate lands near the truth for each confirmed track
    est = np_(res.x_est)[conf]
    err = np.abs(est[:, None, :3] - truth[-1][None, :, :3]).sum(-1).min(1)
    assert (err < 1.0).all(), err
    # mode probabilities are a distribution per track
    np.testing.assert_allclose(np_(res.mode_probs)[conf].sum(1), 1.0,
                               atol=1e-5)
