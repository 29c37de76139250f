"""Quickstart of the PyTorch/CUDA port: KATANA in five minutes.

1. Build the paper's two filters (LKF cv-6, EKF ctra-8).
2. Run every stage of the rewrite ladder over the same measurement stream
   and check that each gives the float64 oracle's track (the rewrites are
   exact).
3. Run the ``katana_bank`` kernel over a 200-filter bank, the paper's
   batched configuration (``configs/katana.py``), against the oracle.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py``. It runs on the card by default;
``--device cpu`` runs the kernels' plain PyTorch versions. It exits
non-zero if a stage or the kernel leaves 1e-4 of the oracle.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.katana import EKF_BATCHED, LKF_BATCHED  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.filters import get_filter  # noqa: E402
from repro_torch.core.rewrites import STAGES, run_sequence  # noqa: E402
from repro_torch.data.trajectories import (batched_targets,  # noqa: E402
                                           single_target)
from repro_torch.kernels.katana_bank.ops import katana_bank  # noqa: E402

TOL = 1e-4  # float32 against the float64 oracle


def main(device: str = "cuda") -> float:
    """Print each stage's and the kernel's deviation from the oracle;
    return the largest."""
    dev = resolve_device(device)
    worst = 0.0
    for kind, cfg in (("lkf", LKF_BATCHED), ("ekf", EKF_BATCHED)):
        model = get_filter(kind, dt=cfg.dt)
        print(f"\n=== {model.name} (n={model.n}, m={model.m}) on {dev} ===")
        truth, zs = single_target(model, 150, seed=0)
        est, _ = ref.run(model, zs)
        rmse_meas = np.sqrt(np.mean((zs[:, :3] - truth[:, :3]) ** 2))
        rmse_filt = np.sqrt(np.mean((est[30:, :3] - truth[30:, :3]) ** 2))
        print(f"measurement rmse {rmse_meas:.4f} -> filtered {rmse_filt:.4f}")

        x0 = np.tile(model.x0, (1, 1))
        P0 = np.tile(model.P0, (1, 1, 1))
        for stage in STAGES:
            got = run_sequence(model, stage, zs[:, None, :], x0, P0,
                               device=dev)[:, 0].cpu().numpy()
            d = float(np.max(np.abs(got - est)))
            worst = max(worst, d)
            print(f"  stage {stage:20s} max deviation vs oracle {d:.2e}")

        # the batched bank through the katana_bank kernel (N=200)
        N = cfg.batch
        _, zsN = batched_targets(model, 20, N, seed=1)
        x = torch.as_tensor(np.tile(model.x0, (N, 1)), dtype=torch.float32,
                            device=dev)
        P = torch.as_tensor(np.tile(model.P0, (N, 1, 1)),
                            dtype=torch.float32, device=dev)
        for t in range(20):
            z = torch.as_tensor(zsN[t], dtype=torch.float32, device=dev)
            x, P = katana_bank(model, x, P, z)
        want, _, _ = ref.run_batched(model, zsN, np.tile(model.x0, (N, 1)),
                                     np.tile(model.P0, (N, 1, 1)))
        d = float(np.max(np.abs(x.cpu().numpy() - want[-1])))
        worst = max(worst, d)
        print(f"  katana_bank kernel (N={N}) max dev vs float64 oracle: "
              f"{d:.2e}")
    return worst


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu")
    worst = main(ap.parse_args().device)
    sys.exit(0 if worst <= TOL else 1)
