"""End-to-end MOT serving driver of the PyTorch/CUDA port: the paper's
Fig. 5 scenario.

A (stub) detector produces noisy centroids per frame for a scene with
target births, deaths and clutter; the port's ``TrackingEngine`` (one
frame step: predict -> gate -> greedy associate -> update -> spawn ->
prune, the measurement cycle in the fused frame kernels) maintains the
track table. Reports throughput and MOTA-style counts.

  PYTHONPATH=src python examples/torch_tracking_pipeline.py --filter ekf \\
      [--device cpu]

The twin of ``examples/tracking_pipeline.py``. It runs on the card by
default; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core.filters import get_filter  # noqa: E402
from repro_torch.core.tracker import TrackerConfig  # noqa: E402
from repro_torch.data.trajectories import SceneConfig, mot_scene  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402


def run(kind: str = "lkf", frames: int = 150, targets: int = 6,
        clutter: float = 1.0, device: str = "cuda") -> dict:
    """Serve the scene; returns the per-frame count errors
    (``count_err``: |confirmed - true|), the localization error of every
    true target to its nearest confirmed track (``loc_err``), the
    engine's FPS and the model."""
    model = get_filter(kind)
    engine = TrackingEngine(model, TrackerConfig(capacity=64, max_meas=32),
                            device=device)
    scene = SceneConfig(T=frames, max_targets=targets, clutter_rate=clutter,
                        max_meas=32)
    z, valid, truth = mot_scene(model, scene, seed=3)
    errs, count_err = [], []
    for t in range(scene.T):
        k = int(valid[t].sum())
        tracks = engine.submit(z[t][valid[t]][:k])
        count_err.append(abs(len(tracks) - len(truth[t])))
        # localization error of matched (nearest) tracks
        for _, xt in truth[t]:
            if tracks:
                errs.append(min(np.linalg.norm(tr.state[:3] - xt[:3])
                                for tr in tracks))
    return dict(count_err=count_err, loc_err=errs, fps=engine.stats.fps,
                model=model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--filter", default="lkf", choices=["lkf", "ekf"])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--targets", type=int, default=6)
    ap.add_argument("--clutter", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = run(args.filter, args.frames, args.targets, args.clutter,
              args.device)
    fps = out["fps"]
    print(f"filter={args.filter} frames={args.frames} "
          f"throughput={fps:.1f} FPS ({1e3 / fps:.2f} ms/frame)")
    print(f"mean count error (last 50 frames): "
          f"{np.mean(out['count_err'][-50:]):.2f}")
    print(f"mean localization error (matched): {np.mean(out['loc_err']):.3f} "
          f"(measurement noise sigma ~{np.sqrt(out['model'].R[0, 0]):.3f})")
    frame_budget_pct = 100.0 * (1.0 / fps) / (1.0 / 30.0)
    print(f"tracker consumes {frame_budget_pct:.1f}% of a 30 FPS frame "
          f"budget (paper: <1% on the NPU)")
    return out


if __name__ == "__main__":
    main()
