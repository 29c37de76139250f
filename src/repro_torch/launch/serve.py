"""Serving launcher: the paper's workload — a KATANA tracking engine fed
by batched measurement requests.

A port of ``repro/launch/serve.py`` with an explicit ``--device`` (the
card by default; ``--device cpu`` runs every kernel's plain version):

  PYTHONPATH=src python -m repro_torch.launch.serve --filter ekf --frames 120
"""
from __future__ import annotations

import argparse

from repro_torch.core.filters import get_filter
from repro_torch.core.tracker import TrackerConfig
from repro_torch.data.trajectories import SceneConfig, mot_scene
from repro_torch.serving.engine import TrackingEngine


def main(argv=None):
    """Serve one scene frame by frame; returns the confirmed-track count
    of every frame."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--filter", default="lkf", choices=["lkf", "ekf"])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--targets", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = get_filter(args.filter)
    cfg = TrackerConfig(capacity=args.capacity, max_meas=64)
    scene = SceneConfig(T=args.frames, max_targets=args.targets, max_meas=64)
    z, valid, truth = mot_scene(model, scene, seed=args.seed)
    engine = TrackingEngine(model, cfg, device=args.device)
    n_conf_hist = []
    for t in range(args.frames):
        k = int(valid[t].sum())
        tracks = engine.submit(z[t][valid[t]][:k])
        n_conf_hist.append(len(tracks))
    fps = engine.stats.fps
    print(f"[serve] {args.filter} frames={engine.stats.frames} "
          f"throughput={fps:.1f} FPS "
          f"({1e3 / max(fps, 1e-9):.2f} ms/frame) "
          f"confirmed at end={n_conf_hist[-1]} true={len(truth[-1])}")
    return n_conf_hist


if __name__ == "__main__":
    main()
