"""flash_attention's float32 forward kernel alone, on one NVIDIA GPU.

    python3 scripts/flash_fwd_probe.py [--root DIR]
        [--shapes granite-moe,internvl2,hubert] [--iters N] [--out FILE]

Builds flash_attention.cu of the checkout at ``DIR`` (default: this one;
e.g. the parent, ``git archive`` unpacked under ``build/``, which
``.gitignore`` lists) and prints ptxas's registers and spill of each
float32 forward kernel and the build's seconds. Then at each layer shape
of ``chip_smoke.MOE_ATTN`` (granite-moe (8, 4,096, 16 / 8, 64) causal,
internvl2 (4, 4,096, 16 / 8, 128) causal, hubert (4, 1,500, 16 / 16, 80)
non-causal; inputs from numpy's generator at seed 41, as phase 11 (a)):
the kernel's ms (CUDA events over ``--iters`` calls after one warm-up),
its device ms a call (torch.profiler), SDPA's forward's ms on the same
inputs, "meets" or "LOSES" against it, the bound (3 x 4 d operations a
visible pair at the 495 TFLOP/s TF32 peak: the 3xTF32 products) and its
share, and batch 0's largest distance from a float64 oracle beside
``ref.flash_attention_plain``'s (float32 products on the card). To set
two checkouts side by side, run it on each in turn in one call, A B B A.
The kernel's correctness checks are the ``gpu`` tests of
``tests/test_torch_gpu.py`` (``-k f32``), not this script.

Prints one JSON object as its last line, with the card's name and power
limit, and writes it to ``--out`` too.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SHAPES = ("granite-moe", "internvl2", "hubert")
TF32_OPS = 495e12  # dense TF32 tensor-core rate of an H100 SXM (data sheet)


def oracle64(q, k, v, scale, causal, window):
    """Batch 0 of attention in float64, heads a few at a time."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    Sq, H, d = q.shape[1:]
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    ok = ref.mask(Sq, Sk, causal, window, q.device)
    out = torch.empty((Sq, H, d), dtype=torch.float64, device=q.device)
    for h0 in range(0, H, 4):
        hs = torch.arange(h0, min(H, h0 + 4), device=q.device)
        qh = q[0][:, hs].double().transpose(0, 1)
        kh, vh = (t[0][:, hs // G].double().transpose(0, 1) for t in (k, v))
        s = (qh @ kh.transpose(1, 2) * scale).masked_fill(~ok, -1e30)
        out[:, hs] = (torch.softmax(s, -1) @ vh).transpose(0, 1)
    return out


def device_ms(fn, iters):
    """Device ms a call of the forward kernels ``fn`` launches."""
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
        if "flash_fwd" in e.key:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[e.key.split("(")[0][:60]] = round(total / 1e3 / iters, 4)
    return out


def ptxas_lines(build):
    entry, lines = None, []
    for ln in build.BUILD_LOG["flash_attention.cu"]["ptxas"]:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
        elif entry and "flash_fwd" in entry and "wgmma" not in entry and (
                "registers" in ln or "spill" in ln):
            lines.append(f"{entry}: {ln}")
    return lines


def run(args, cs, build, fa_ops, fa_ref, card):
    import numpy as np
    import torch

    t0 = time.perf_counter()
    build.build(["flash_attention.cu"])
    out = dict(build_s=time.perf_counter() - t0, ptxas=ptxas_lines(build),
               config={d: fa_ops.config(torch.float32, d)
                       for d in (64, 80, 128)} if hasattr(
                           fa_ops, "INSTRUCTIONS") else None,
               rows={})
    for ln in out["ptxas"]:
        print(f"  {ln}")
    print(f"[probe] built in {out['build_s']:.1f} s; config {out['config']}")
    rng = np.random.default_rng(41)
    by_name = {a.split("-")[0]: (a, B, S, H, KH, d, causal)
               for a, B, S, H, KH, d, causal in cs.MOE_ATTN}
    names = {"granite-moe": "granite", "internvl2": "internvl2",
             "hubert": "hubert"}
    for shape in args.shapes.split(","):
        arch, B, S, H, KH, d, causal = by_name[names[shape]]
        q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                                   dtype=torch.float32, device="cuda")
                   for h in (H, KH, KH))
        scale = d ** -0.5
        fn = lambda: fa_ops.flash_attention(q, k, v, scale, causal, None)  # noqa: E731
        ms = cs.cuda_ms(fn, args.iters, warmup=1)
        dev = device_ms(fn, 3)
        mask = fa_ref.mask(S, S, True, None, "cuda") if causal else None
        lib = cs.sdpa_ms(q, k, v, mask, args.iters)
        pairs = S * (S + 1) // 2 if causal else S * S
        bound = 3 * 4 * d * pairs * B * H / TF32_OPS * 1e3
        got = fn()
        o64 = oracle64(q, k, v, scale, causal, None)
        plain = fa_ref.flash_attention_plain(q[:1], k[:1], v[:1], scale,
                                             causal, None)
        e64 = float((got[0].double() - o64).abs().max())
        p64 = float((plain[0].double() - o64).abs().max())
        verdict = ("SDPA refused" if lib is None else
                   "meets" if ms <= lib else "LOSES")
        out["rows"][shape] = dict(ms=ms, device_ms=dev, sdpa_ms=lib,
                                  bound_ms=bound, bound_share=bound / ms,
                                  err64=e64, plain_err64=p64, verdict=verdict)
        print(f"[probe] {arch} B={B} S={S} H={H} KH={KH} d={d} "
              f"{'causal' if causal else 'non-causal'} float32: {ms:.3f} ms "
              f"(device {dev}), SDPA {lib if lib is None else round(lib, 3)} "
              f"ms: {verdict}; bound {bound:.4f} ms, {bound / ms:.4f} of it; "
              f"batch 0 vs float64 {e64:.3g} (plain {p64:.3g}) | {card}")
        del q, k, v, got, o64, plain
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the card only")
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi_line()
    print(f"[probe] {root} | {card}")
    out = dict(root=str(root), card=card,
               **run(args, cs, build, fa_ops, fa_ref, card))
    line = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
