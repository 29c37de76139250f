"""``examples/torch_mot_demo.py`` against the reference example's loop
(``examples/mot_demo.py``) over 40 frames: the same confirmed counts of
the IMM and the CV engine every frame, the final position errors within
1e-5."""
import numpy as np

from repro.core.filters import get_filter, make_imm
from repro.core.tracker import TrackerConfig
from repro.data.trajectories import maneuvering_batch
from repro.serving.engine import TrackingEngine

from _torch_examples import load_example

T, N = 40, 3


def test_mot_demo_matches_reference():
    demo = load_example("torch_mot_demo")
    out = demo.run(T, N, device="cpu")
    truth, zs = maneuvering_batch(T, N, seed=11)
    cfg = TrackerConfig(capacity=16, max_meas=8, min_hits=3)
    imm_engine = TrackingEngine(make_imm(), cfg)
    cv_engine = TrackingEngine(get_filter("lkf"), cfg)
    n_imm, n_cv = [], []
    for t in range(T):
        snaps = imm_engine.submit(zs[t])
        cv_snaps = cv_engine.submit(zs[t])
        n_imm.append(len(snaps))
        n_cv.append(len(cv_snaps))
    assert out["n_imm"] == n_imm and out["n_cv"] == n_cv
    assert n_imm[-1] == N
    np.testing.assert_allclose(
        [out["err_imm"], out["err_cv"]],
        [demo.final_position_error(snaps, truth[-1]),
         demo.final_position_error(cv_snaps, truth[-1])], rtol=0, atol=1e-5)
