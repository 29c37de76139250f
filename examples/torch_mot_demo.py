"""End-to-end MOT walkthrough of the PyTorch/CUDA port: maneuvering scene
-> TrackingEngine -> confirmed tracks with IMM mode probabilities.

Three maneuvering targets (CV / coordinated-turn / acceleration segment
switching) are detected with noise each frame and fed to an IMM
TrackingEngine. The demo prints the confirmed track table every 20
frames — watch the mode probabilities shift between CV / CA / CT(+w) /
CT(-w) as each target maneuvers — and compares the final IMM position
error against a single-model CV engine on the same detections.

  PYTHONPATH=src python examples/torch_mot_demo.py [--device cpu]

The twin of ``examples/mot_demo.py``. It runs on the card by default;
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core.filters import get_filter, make_imm  # noqa: E402
from repro_torch.core.tracker import TrackerConfig  # noqa: E402
from repro_torch.data.trajectories import maneuvering_batch  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402

MODE_NAMES = ("CV", "CA", "CT+", "CT-")


def final_position_error(snaps, truth_t):
    """Mean distance from each confirmed track to its nearest truth."""
    if not snaps:
        return float("nan")
    est = np.stack([s.state[:3] for s in snaps])
    d = np.linalg.norm(est[:, None] - truth_t[None, :, :3], axis=-1)
    return float(d.min(axis=1).mean())


def run(T: int = 120, N: int = 3, device: str = "cuda",
        verbose: bool = False) -> dict:
    """Run both engines over the scene; returns the final mean position
    errors (``err_imm``, ``err_cv``), the confirmed counts of every frame
    (``n_imm``, ``n_cv``) and the IMM engine's FPS."""
    truth, zs = maneuvering_batch(T, N, seed=11)
    cfg = TrackerConfig(capacity=16, max_meas=8, min_hits=3)
    imm_engine = TrackingEngine(make_imm(), cfg, device=device)
    cv_engine = TrackingEngine(get_filter("lkf"), cfg, device=device)
    n_imm, n_cv = [], []
    for t in range(T):
        snaps = imm_engine.submit(zs[t])
        cv_snaps = cv_engine.submit(zs[t])
        n_imm.append(len(snaps))
        n_cv.append(len(cv_snaps))
        if verbose and (t + 1) % 20 == 0:
            print(f"frame {t + 1:3d}: {len(snaps)} confirmed IMM tracks")
            for s in snaps:
                modes = " ".join(f"{name}={p:.2f}" for name, p in
                                 zip(MODE_NAMES, s.mode_probs))
                px, py, pz = s.state[:3]
                print(f"  track {s.track_id}: pos=({px:+6.2f},{py:+6.2f},"
                      f"{pz:+6.2f}) hits={s.hits:3d}  {modes}")
    return dict(err_imm=final_position_error(snaps, truth[-1]),
                err_cv=final_position_error(cv_snaps, truth[-1]),
                n_imm=n_imm, n_cv=n_cv, fps=imm_engine.stats.fps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    T, N = args.frames, 3
    print(f"scene: {N} maneuvering targets, {T} frames "
          f"(segments switch between CV / turns / acceleration)\n")
    out = run(T, N, args.device, verbose=True)
    print(f"\nfinal mean position error: IMM {out['err_imm']:.3f} vs "
          f"single-model CV {out['err_cv']:.3f}")
    print(f"IMM engine fps (fused frame steps): {out['fps']:.1f}")
    return out


if __name__ == "__main__":
    main()
