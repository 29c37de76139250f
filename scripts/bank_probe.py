"""The single-model bank step or replay scan of one checkout, on one
NVIDIA GPU.

    python3 scripts/bank_probe.py --root DIR [--scan] [--out FILE]

Builds the katana_bank kernels of the port under ``DIR/src`` and prints
the ptxas lines of the step's source. Then holds ``katana_bank`` and
``katana_bank_soa`` bit for bit against ``ref.katana_bank_step_plain``
on the card (lkf and ekf, N of 1, 33 and 4097 tracks), and times both
at the replay size of ``chip_smoke.py`` (N = 131,072, one frame of
``replay_inputs``): CUDA events around 50 wrapper calls queued behind
~50 ms of device spin, so they time the device.

With ``--scan``, the same for ``katana_bank_sequence`` (scan.cu): its
ptxas lines; lkf, ekf and cv9 at N of 1, 31, 33, 129 and 4097 tracks
over 20 frames, with and without a valid stream (the K = 1 IMM replay),
bit for bit against ``ref.katana_bank_scan_plain`` (or max |d|); then
the stream of N = 131,072 tracks over T = 300 frames in one launch,
with and without a valid stream: CUDA events around 10 launches
(``ops._launch_scan``) queued behind ~50 ms of device spin.

The byte bound is each input read once and each output written once
over 3.35 TB/s. Run it on two checkouts in one call (A, B, B, A) to
compare them on one card. The last line is one JSON object with the
card's name and power limit; ``--out`` gets it too.
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
    ap.add_argument("--scan", action="store_true",
                    help="probe katana_bank_sequence instead of the step")
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
    if args.scan:
        return probe_scan(root, args.out, logs, np, torch, filters, ops, ref,
                          replay_inputs)
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
        ms = device_ms(torch, lambda: ops.katana_bank(model, x0, P0, zs[0]),
                       50)
        ms_soa = device_ms(torch, lambda: ops.katana_bank_soa(model, xT, PT,
                                                            zT), 50)
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


def device_ms(torch, call, n):
    """Mean device ms of n calls, queued behind ~50 ms of device spin."""
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


def probe_scan(root, out, logs, np, torch, filters, ops, ref, replay_inputs):
    """``--scan``: ptxas lines, bit-for-bit cases and times of
    katana_bank_sequence."""
    print("scan.cu:")
    for ln in logs["scan.cu"]["ptxas"]:
        print(f"  {ln}")
    dev = torch.device("cuda")

    def run(model, zs, x0, P0, vs):
        """The scan's (xs, x_T, P_T) and the plain version's; with a valid
        stream through the K = 1 IMM replay."""
        if vs is None:
            xs, (xf, Pf) = ops.katana_bank_sequence(model, zs, x0, P0,
                                                    return_final=True)
            return (xs, xf, Pf), lambda: ref.katana_bank_scan_plain(
                model, x0, P0, zs)
        one = filters.as_imm(model)
        xs, (xf, Pf, _) = ops.katana_imm_sequence(one, zs, x0, P0, valid=vs,
                                                  return_final=True)
        _, _, _, zz, vv = ops.imm_sequence_inputs(one, zs, x0, P0, None, vs)
        return (xs, xf[0], Pf[0]), lambda: ref.katana_bank_scan_plain(
            model, x0, P0, zz, vv)

    checks = []
    for kind in ("lkf", "ekf", "cv9"):
        model = filters.get_filter(kind)
        for N in (1, 31, 33, 129, 4097):
            for valid in (False, True):
                x0, P0, zs, vs = (torch.as_tensor(a).to(dev) for a in
                                  replay_inputs(np.random.default_rng(N),
                                                model, N, 20,
                                                drop=0.1 if valid else 0.0))
                got, plain = run(model, zs, x0, P0, vs if valid else None)
                want = plain()
                eq = all(torch.equal(g, w) for g, w in zip(got, want))
                d = max(float((g.double() - w.double()).abs().max())
                        for g, w in zip(got, want))
                checks.append(dict(kind=kind, N=N, valid=valid, bitwise=eq,
                                   max_abs=d))
                print(f"  {kind} N={N} T=20 valid={valid}: "
                      f"{'bitwise' if eq else f'max|d| {d:.3g}'}")

    N, T = 131_072, 300
    times = {}
    for kind in ("lkf", "ekf"):
        model = filters.get_filter(kind)
        n, m = model.n, model.m
        x0, P0, zs, vs = (torch.as_tensor(a).to(dev) for a in replay_inputs(
            np.random.default_rng(5), model, N, T, drop=0.1))
        zs = torch.nan_to_num(zs)
        xs = torch.empty((T, N, n), device=dev)
        bound = ((T * N * (m + n) + 2 * N * (n + n * n)) * 4 / HBM_BPS
                 * 1e3)
        # the launch alone (ops._launch_scan: one time chunk), without and
        # with the valid stream
        ms = device_ms(torch, lambda: ops._launch_scan(model, x0, P0, zs,
                                                       None, xs), 10)
        ms_v = device_ms(torch, lambda: ops._launch_scan(model, x0, P0, zs,
                                                         vs, xs), 10)
        times[kind] = dict(ms=ms, valid_ms=ms_v, bound_ms=bound,
                           share=bound / ms, valid_share=bound / ms_v)
        print(f"{kind} N={N} T={T}: katana_bank_sequence {ms:.4f} ms "
              f"({bound / ms:.1%} of the {bound:.4f} ms byte bound); with a "
              f"valid stream {ms_v:.4f} ms ({bound / ms_v:.1%})", flush=True)
    result = dict(root=str(root), card=smi_line(),
                  ptxas=logs["scan.cu"]["ptxas"], checks=checks, times=times)
    if out:
        Path(out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
