"""Twin of the reference's
``tests/test_imm.py::test_imm_tracker_mode_probs_stay_normalized_under_coasting``
on the port's ``make_jitted_imm_tracker`` with ``device="cpu"``: the
reference test's assertions, and every frame held to the reference's
jitted IMM tracker on the same inputs (``_torch_parity.run_jitted_both``:
identical assoc, track ids and lifecycle; x, P, mu, x_est within 1e-5 of
their scale)."""
import numpy as np

from repro.core import filters as jf
from repro.core import tracker as jtr
from repro_torch.core import filters as tf
from repro_torch.core import tracker as ttr
from repro_torch.core import make_jitted_imm_tracker

from _torch_parity import np_, run_jitted_both


def test_imm_tracker_mode_probs_stay_normalized_under_coasting():
    """With no measurements at all (pure coasting) the mode probability
    update is the Markov prediction cbar: rows keep summing to 1 and
    never go NaN, until the tracks prune away."""
    cfg = ttr.TrackerConfig(capacity=8, max_meas=4, max_misses=20)
    jcfg = jtr.TrackerConfig(capacity=8, max_meas=4, max_misses=20)
    init, step = make_jitted_imm_tracker(tf.make_imm(), cfg, device="cpu")
    jinit, jstep = jtr.make_jitted_imm_tracker(jf.make_imm(), jcfg)
    # spawn two tracks
    z = np.zeros((4, 3), np.float32)
    z[:2] = [[1.0, 2.0, 0.0], [-3.0, 0.5, 1.0]]
    v = np.array([True, True, False, False])
    res, jres = run_jitted_both(jstep, jinit(), step, init(), [(z, v)], True)
    bank, jbank = res.bank, jres.bank
    # coast for 10 frames
    for _ in range(10):
        res, jres = run_jitted_both(jstep, jbank, step, bank,
                                    [(np.zeros((4, 3), np.float32),
                                      np.zeros(4, bool))], True)
        bank, jbank = res.bank, jres.bank
        mu = np_(bank.mu)
        assert np.isfinite(mu).all()
        act = np_(bank.active)
        assert act[:2].all()  # max_misses=20: still alive
        np.testing.assert_allclose(mu[act].sum(1), 1.0, atol=1e-5)
