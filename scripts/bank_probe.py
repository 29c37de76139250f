"""The single-model bank step of one checkout, on one NVIDIA GPU.

    python3 scripts/bank_probe.py --root DIR [--out FILE]

Builds the katana_bank kernels of the port under ``DIR/src`` and prints
the ptxas lines of the step's source. Then holds ``katana_bank`` and
``katana_bank_soa`` bit for bit against ``ref.katana_bank_step_plain``
on the card (lkf and ekf, N of 1, 33 and 4097 tracks), and times both
at the replay size of ``chip_smoke.py`` (N = 131,072, one frame of
``replay_inputs``): CUDA events around 50 wrapper calls queued behind
~50 ms of device spin, so they time the device. The byte bound is each
input read once and each output written once over 3.35 TB/s. Run it on
two checkouts in one call (A, B, B, A) to compare them on one card.

The last line is one JSON object with the card's name and power limit;
``--out`` gets it too.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BPS = 3.35e12


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    import numpy as np
    import torch

    import repro_torch
    assert root in Path(repro_torch.__file__).resolve().parents, root
    from repro_torch.core import filters
    from repro_torch.kernels import build
    from repro_torch.kernels.katana_bank import ops, ref
    from _torch_inputs import replay_inputs

    sources = [s for s, d in build.SOURCES.items()
               if d.parent.name == "katana_bank"]
    logs = build.build(sources)
    step_src = "scan.cu" if hasattr(build.load("scan.cu"),
                                    "katana_bank_step_run") else "imm_step.cu"
    print(f"{step_src} (the step's source):")
    for ln in logs[step_src]["ptxas"]:
        print(f"  {ln}")
    dev = torch.device("cuda")
    checks = []
    for kind in ("lkf", "ekf"):
        model = filters.get_filter(kind)
        for N in (1, 33, 4097):
            x0, P0, zs, _ = (torch.as_tensor(a).to(dev) for a in
                             replay_inputs(np.random.default_rng(N), model,
                                           N, 1))
            a = ops.katana_bank(model, x0, P0, zs[0])
            want = ref.katana_bank_step_plain(model, x0, P0, zs[0])
            soa = ops.katana_bank_soa(model, x0.T.contiguous(),
                                      P0.permute(1, 2, 0).contiguous(),
                                      zs[0].T.contiguous())
            eq = all(torch.equal(g, w) for g, w in zip(a, want))
            eq_soa = (torch.equal(soa[0].T, a[0])
                      and torch.equal(soa[1].permute(2, 0, 1), a[1]))
            d = max(float((g.double() - w.double()).abs().max())
                    for g, w in zip(a, want))
            checks.append(dict(kind=kind, N=N, bitwise=eq, soa_bitwise=eq_soa,
                               max_abs=d))
            print(f"  {kind} N={N}: vs plain "
                  f"{'bitwise' if eq else f'max|d| {d:.3g}'}; soa == "
                  f"canonical {eq_soa}")

    def device_ms(call, n=50):
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # clock cycles
        start.record()
        for _ in range(n):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    N = 131_072
    times = {}
    for kind in ("lkf", "ekf"):
        model = filters.get_filter(kind)
        n, m = model.n, model.m
        x0, P0, zs, _ = (torch.as_tensor(a).to(dev) for a in replay_inputs(
            np.random.default_rng(5), model, N, 1))
        xT, PT, zT = (x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
                      zs[0].T.contiguous())
        bound = (2 * N * (n + n * n) + N * m) * 4 / HBM_BPS * 1e3
        ms = device_ms(lambda: ops.katana_bank(model, x0, P0, zs[0]))
        ms_soa = device_ms(lambda: ops.katana_bank_soa(model, xT, PT, zT))
        times[kind] = dict(ms=ms, soa_ms=ms_soa, bound_ms=bound,
                           share=bound / ms, soa_share=bound / ms_soa)
        print(f"{kind} N={N}: katana_bank {ms:.4f} ms ({bound / ms:.1%} of "
              f"the {bound:.5f} ms byte bound), katana_bank_soa "
              f"{ms_soa:.4f} ms ({bound / ms_soa:.1%})", flush=True)
    result = dict(root=str(root), card=smi_line(),
                  ptxas=logs[step_src]["ptxas"], checks=checks, times=times)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
