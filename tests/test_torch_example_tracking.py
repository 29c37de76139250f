"""``examples/torch_tracking_pipeline.py`` against the reference example's
loop (``examples/tracking_pipeline.py``) at a small size: the same count
error every frame, the same localization errors within 1e-5."""
import numpy as np
import pytest

from repro.core.filters import get_filter
from repro.core.tracker import TrackerConfig
from repro.data.trajectories import SceneConfig, mot_scene
from repro.serving.engine import TrackingEngine

from _torch_examples import load_example

FRAMES, TARGETS, CLUTTER = 40, 4, 1.0


def reference_run(kind):
    """The reference example's loop, returning its per-frame numbers."""
    model = get_filter(kind)
    engine = TrackingEngine(model, TrackerConfig(capacity=64, max_meas=32))
    scene = SceneConfig(T=FRAMES, max_targets=TARGETS, clutter_rate=CLUTTER,
                        max_meas=32)
    z, valid, truth = mot_scene(model, scene, seed=3)
    errs, count_err = [], []
    for t in range(scene.T):
        k = int(valid[t].sum())
        tracks = engine.submit(z[t][valid[t]][:k])
        count_err.append(abs(len(tracks) - len(truth[t])))
        for _, xt in truth[t]:
            if tracks:
                errs.append(min(np.linalg.norm(tr.state[:3] - xt[:3])
                                for tr in tracks))
    return count_err, errs


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_tracking_pipeline_matches_reference(kind):
    out = load_example("torch_tracking_pipeline").run(
        kind, FRAMES, TARGETS, CLUTTER, device="cpu")
    count_err, errs = reference_run(kind)
    assert out["count_err"] == count_err
    assert len(out["loc_err"]) == len(errs) > 0
    np.testing.assert_allclose(out["loc_err"], errs, rtol=0, atol=1e-5)
    assert out["fps"] > 0
