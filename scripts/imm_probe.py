"""The two IMM bank kernels of one checkout, on one NVIDIA GPU.

    python3 scripts/imm_probe.py --root DIR [--out FILE]

Builds ``imm_step.cu`` and ``imm_scan.cu`` of the port under
``DIR/src`` and prints their ptxas lines. Then holds
``katana_bank_imm`` and ``katana_imm_sequence`` bit for bit against
their plain versions on the card at small shapes (make_imm(), a model
set with other zeros, the K=1 CTRA-8 step; N of 1, 31, 33 and 4097
tracks; with and without a valid stream; chunked and in one launch),
and times them at the replay size of ``chip_smoke.py`` (make_imm(),
N = 131,072; one frame; T = 300 frames in chunks of 16, 64 and 150 and
in one launch): CUDA events around the wrapper calls, queued behind
~50 ms of device spin so they time the device. Run it on two
checkouts in one call (A, B, B, A) to compare them on one card.

The last line is one JSON object with the card's name and power limit;
``--out`` gets it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


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

    logs = build.build(["imm_step.cu", "imm_scan.cu"])
    for src, log in logs.items():
        print(f"{src}:")
        for ln in log["ptxas"]:
            print(f"  {ln}")
    dev = torch.device("cuda")
    pick = getattr(ops, "pick_pattern", None)

    def inst(models):
        return pick(models).name if pick else "dense"

    imm = filters.make_imm()
    cv9 = filters.make_cv9_lkf(dt=0.05)
    F = cv9.F.copy()
    F[6:9, 6:9] = 0.9 * np.eye(3)
    F[6, 0] = 0.01
    other = filters.IMMModel(
        name="other", models=(dataclasses.replace(cv9, F=F),
                              filters.make_ca9_lkf(dt=0.05),
                              filters.make_ct9_lkf(0.4, dt=0.05),
                              filters.make_ct9_lkf(-0.9, dt=0.05)),
        trans=imm.trans, mu0=imm.mu0)
    ekf1 = filters.as_imm(filters.get_filter("ekf"))
    rng = np.random.default_rng(0)
    checks = []

    def same(tag, got, want):
        eq = all(torch.equal(a, b) for a, b in zip(got, want))
        d = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want))
        checks.append(dict(case=tag, bitwise=eq, max_abs=d))
        print(f"  {tag}: {'bitwise' if eq else f'max|d| {d:.3g}'}")

    print("katana_bank_imm vs ref.katana_bank_imm_step_plain:")
    for name, mdl in (("imm", imm), ("other", other), ("ekf K=1", ekf1)):
        for N in (1, 31, 33, 4097):
            x0, P0, zs, _ = replay_inputs(rng, mdl, N, 1)
            K, n = mdl.K, mdl.n
            x = torch.as_tensor(np.tile(x0, (K, 1, 1)) + 0.05 * rng.normal(
                size=(K, N, n)), dtype=torch.float32, device=dev)
            A = rng.normal(size=(K, N, n, n)) * 0.3
            P = torch.as_tensor((A @ np.swapaxes(A, -1, -2)
                                 + 0.5 * np.eye(n)).astype(np.float32),
                                device=dev)
            z = torch.as_tensor(zs[0], device=dev)
            same(f"{name} ({inst(mdl.models)}) N={N}",
                 ops.katana_bank_imm(mdl, x, P, z),
                 ref.katana_bank_imm_step_plain(mdl, x, P, z))
    print("katana_imm_sequence vs ref.katana_bank_imm_scan_plain:")
    for name, mdl in (("imm", imm), ("other", other)):
        for N, T, drop, chunk in ((1, 9, 0.0, 0), (33, 40, 0.1, 0),
                                  (33, 40, 0.1, 7), (4097, 20, 0.1, 40)):
            x0, P0, zs, valid = replay_inputs(rng, mdl, N, T, drop=drop)
            mu0 = torch.as_tensor(rng.dirichlet(np.ones(mdl.K), size=N),
                                  dtype=torch.float32, device=dev)
            x0, P0, zs, valid = (torch.as_tensor(a).to(dev)
                                 for a in (x0, P0, zs, valid))
            vs = valid if drop else None
            got = ops.katana_imm_sequence(mdl, zs, x0, P0, mu0, vs,
                                          return_final=True,
                                          time_chunk=chunk)
            want = ref.katana_bank_imm_scan_plain(
                mdl, *ops.imm_sequence_inputs(mdl, zs, x0, P0, mu0, vs))
            same(f"{name} ({inst(mdl.models)}) N={N} T={T} valid="
                 f"{vs is not None} chunk={chunk or 'default'}",
                 (got[0],) + got[1], want)

    def device_ms(call, n):
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

    N, T = 131_072, 300
    x0, P0, zs, _ = (torch.as_tensor(a).to(dev) for a in replay_inputs(
        np.random.default_rng(5), imm, N, T))
    K = imm.K
    xK = x0[None].expand(K, N, imm.n).contiguous()
    PK = P0[None].expand(K, N, imm.n, imm.n).contiguous()
    times = dict(
        step_ms=device_ms(lambda: ops.katana_bank_imm(imm, xK, PK, zs[0]),
                          50),
        scan_chunk64_ms=device_ms(lambda: ops.katana_imm_sequence(
            imm, zs, x0, P0, time_chunk=64), 5),
        scan_one_launch_ms=device_ms(lambda: ops.katana_imm_sequence(
            imm, zs, x0, P0, time_chunk=T), 5))
    for chunk in (16, 150):
        times[f"scan_chunk{chunk}_ms"] = device_ms(
            lambda: ops.katana_imm_sequence(imm, zs, x0, P0,
                                            time_chunk=chunk), 5)
    print(f"make_imm() ({inst(imm.models)}), N={N}: katana_bank_imm "
          f"{times['step_ms']:.4f} ms a frame; katana_imm_sequence T={T}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()
                      if k.startswith("scan")))
    result = dict(root=str(root), card=smi_line(),
                  ptxas={s: log["ptxas"] for s, log in logs.items()},
                  checks=checks, **times)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
