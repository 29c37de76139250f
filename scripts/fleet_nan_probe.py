"""The imm fleet replay of ``chip_smoke.py`` phase 3b after a shorter live
run, on one NVIDIA GPU.

    python3 scripts/fleet_nan_probe.py [--frames 100] [--out FILE]

Phase 3b serves 8 sensors of C = 1,024 (the dense-sky scene of seed 7 + s)
through ``ShardedBankEngine`` for ``--frames`` frames, then replays T = 300
frames of the replay stream's first 8,192 lanes (30% coasting) from the
live banks in one ``katana_imm_sequence`` launch. This prints the lanes
whose combined estimates go non-finite, each one's live-bank state, and
the same lane alone through the kernel and through its plain version
(on the CPU). ``--out`` gets the first 16 such lanes' seeds and streams
(an npz with ``{s}_{c}_{x0,P0,mu0,zs,valid}``), small enough to run
through the JAX package and the float64 oracle on a CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import bank as bank_lib  # noqa: E402
from repro_torch.kernels.katana_bank import ops  # noqa: E402
from repro_torch.serving.engine import ShardedBankEngine  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", help="npz of the non-finite lanes' inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet_nan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi_line())
    cs.T_FLEET = args.frames
    model = cs.replay_model("imm")
    S, C, M = cs.S_FLEET, cs.C_SERVE, cs.M_SERVE
    cfg = cs.tracker.TrackerConfig(capacity=C, max_meas=M)
    z, valid = cs.fleet_scene("imm")
    eng = ShardedBankEngine(model, S, cfg, devices=("cuda",))
    for t in range(cs.T_FLEET):
        eng.frame(z[t], valid[t])
    Tr = cs.T_FLEET_REPLAY
    zs = cs.replay_stream("imm")[0][:Tr, :S * C].reshape(Tr, S, C, model.m)
    vmask = np.random.default_rng(23).random((Tr, S, C)) >= cs.FLEET_DROP
    zs = np.where(vmask[..., None], zs, np.nan).astype(np.float32)
    xs = eng.replay(zs, vmask)
    bad = ~np.isfinite(xs).all(-1)                     # (T, S, C)
    lanes = sorted({(int(s), int(c)) for _, s, c in zip(*np.nonzero(bad))})
    print(f"after {cs.T_FLEET} live frames: non-finite entries "
          f"{int(bad.sum())} over {len(lanes)} lanes")
    imm1 = cs.filters.as_imm(model)
    keep = {}
    for s, c in lanes[:16]:
        first = int(np.nonzero(bad[:, s, c])[0][0])
        b = bank_lib.slice_sensor_bank(eng.banks, s)
        Pd = np.stack([np.diag(p) for p in b.P[:, c].cpu().numpy()])
        print(f"lane (s={s}, c={c}): first non-finite frame {first}; active "
              f"{bool(b.active[c])} hits {int(b.hits[c])} misses "
              f"{int(b.misses[c])} age {int(b.age[c])}; mu "
              f"{b.mu[c].cpu().numpy().tolist()}; |x| max "
              f"{float(b.x[:, c].abs().max()):.4g}; P diagonal max "
              f"{float(Pd.max()):.4g} min {float(Pd.min()):.4g}")
        x0 = b.x[:, c:c + 1].contiguous()
        P0 = b.P[:, c:c + 1].contiguous()
        mu0 = b.mu[c:c + 1].contiguous()
        zl = torch.from_numpy(zs[:, s, c:c + 1]).cuda().contiguous()
        vl = torch.from_numpy(vmask[:, s, c:c + 1]).cuda().contiguous()
        k = ops.katana_imm_sequence(imm1, zl, x0, P0, mu0=mu0, valid=vl)
        p = ops.katana_imm_sequence(imm1, zl.cpu(), x0.cpu(), P0.cpu(),
                                    mu0=mu0.cpu(), valid=vl.cpu())
        kb = np.nonzero(~torch.isfinite(k).all(-1).cpu().numpy()[:, 0])[0]
        pb = np.nonzero(~torch.isfinite(p).all(-1).numpy()[:, 0])[0]
        print(f"  alone: first non-finite frame of the kernel {kb[:1]}, of "
              f"the plain version on the CPU {pb[:1]}")
        keep[f"{s}_{c}"] = dict(x0=x0.cpu().numpy(), P0=P0.cpu().numpy(),
                                mu0=b.mu[c].cpu().numpy(),
                                zs=zs[:, s, c], valid=vmask[:, s, c])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.out, **{f"{k}_{f}": v for k, d in keep.items()
                              for f, v in d.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
