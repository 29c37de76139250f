"""flash_attention's backward kernel alone, on one NVIDIA GPU.

    python3 scripts/flash_bwd_probe.py [--root DIR] [--check]
        [--layers danube,granite-moe] [--dtypes bfloat16,float32]
        [--iters N] [--out FILE]

Builds flash_attention.cu and flash_attention_bwd.cu of the checkout at
``DIR`` (default: this one; e.g. the parent, ``git archive`` unpacked
under ``build/``, which ``.gitignore`` lists) and prints ptxas's
registers and spill of each backward kernel and the build's seconds.
Then at each layer, danube's (1, 8,192, 32 / 8 heads of 80, window
4,096: ``chip_smoke.GRAD_SHAPE``) and granite-moe's (1, 4,096, 16 / 8
heads of 64, causal: ``GRAD_MOE``), and each dtype: the kernel's, the
torch-op backward's and SDPA's backward's ms (CUDA events,
``chip_smoke.bwd_times``), the bound and its share, "meets" or "LOSES"
against SDPA's backward, and each of the three kernels' device ms a call
(torch.profiler over ``--iters`` calls). With ``--check`` also the checks of
``chip_smoke.hold_grads`` (the plain version by ``ref.bwd_excess``,
float64 at 2x the torch-op backward's distance, float32 within 2e-5 +
1e-4|x|) and two kernel calls bit for bit. The inputs come from numpy's
generator at seed 31, as phase 10's.

Prints one JSON object as its last line, with the card's name and power
limit, and writes it to ``--out`` too.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

LAYERS = ("danube", "granite-moe")


def kernel_ms(fn, iters):
    """Device ms a call of each kernel that ``fn`` launches, by the
    profiler's kernel names (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "flash_bwd" in e.key:
            name = e.key.split("(")[0].split("::")[-1]
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[name] = round(total / 1e3 / iters, 4)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--layers", default=",".join(LAYERS))
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the card only")
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["flash_attention.cu", "flash_attention_bwd.cu"])
    build_s = time.perf_counter() - t0
    ptxas = build.BUILD_LOG["flash_attention_bwd.cu"]["ptxas"]
    entry = None
    for ln in ptxas:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
        elif entry and "flash_bwd" in entry and ("registers" in ln
                                                 or "spill" in ln):
            print(f"  {entry}: {ln}")
    card = cs.smi_line()
    print(f"[probe] {root}: built in {build_s:.1f} s | {card}")
    shapes = {"danube": cs.GRAD_SHAPE, "granite-moe": cs.GRAD_MOE}
    rng = np.random.default_rng(31)
    out = dict(root=str(root), card=card, build_s=build_s, rows={})
    for layer in args.layers.split(","):
        B, S, H, KH, d, W = shapes[layer]
        for tag in args.dtypes.split(","):
            dtype = getattr(torch, tag)
            q, k, v, do = cs._grad_inputs(rng, B, S, H, KH, d, dtype)
            scale = d ** -0.5
            row = {}
            if args.check:
                got = cs.fa_ops.flash_attention_bwd_kernel(q, k, v, do, scale,
                                                           True, W)
                again = cs.fa_ops.flash_attention_bwd_kernel(q, k, v, do,
                                                             scale, True, W)
                row["bitwise"] = all(torch.equal(a, b)
                                     for a, b in zip(got, again))
                try:
                    row.update(cs.hold_grads(q, k, v, do, scale, W, got))
                except AssertionError as exc:  # print it, and go on
                    row["failed"] = str(exc)
                    print(f"[probe] {layer} {tag} FAILED: {exc}")
                del got, again
            row.update(cs.bwd_times(q, k, v, do, scale, W, args.iters))
            row["kernels_ms"] = kernel_ms(
                lambda: cs.fa_ops.flash_attention_bwd_kernel(
                    q, k, v, do, scale, True, W), args.iters)
            lib = row["sdpa_bwd_ms"]
            verdict = ("SDPA refused" if lib is None else
                       "meets" if row["kernel_ms"] <= lib else "LOSES")
            print(f"[probe] {layer} {tag}: kernel {row['kernel_ms']:.3f} ms "
                  f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                  f"{row['bound_share']:.4f} of it), torch-op backward "
                  f"{row['bwd_ms']:.3f} ms, SDPA's backward "
                  f"{'refused' if lib is None else f'{lib:.3f} ms'}: "
                  f"{verdict}; by kernel {row['kernels_ms']}"
                  + (f"; excess vs plain {row['excess']}, float64 kernel "
                     f"{row['err64']} torch-op {row['ops_err64']}"
                     if args.check else "") + f" | {card}")
            out["rows"][f"{layer} {tag}"] = row
            del q, k, v, do
            torch.cuda.empty_cache()
    line = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return int(any("failed" in r or not r.get("bitwise", True)
                   for r in out["rows"].values()))


if __name__ == "__main__":
    sys.exit(main())
