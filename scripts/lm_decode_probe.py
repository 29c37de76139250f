"""Decode probes of the port's LM serving path, on one NVIDIA GPU.

    python3 scripts/lm_decode_probe.py split [--out FILE]

flash_decode's device time per wrapper call (torch.profiler: its two
launches summed, with the 50 MB L2 flushed before each call, as a
decode step finds its cache) at 128 to 1024 keys a split, at
h2o-danube-1.8b's decode shape (B=4, T=4096, H=32, KH=8, d=80, bf16)
and at one prompt of it (B=1), where ``choose_split`` halves the split;
three rounds, each split once a round, 50 calls each.

    python3 scripts/lm_decode_probe.py decode --root DIR [--out FILE]

The danube serving loop of ``chip_smoke.py`` phase 7 (full width and
depth, random bf16 weights from seed 0, B=4 prompts of 8192 tokens from
``LMDataPipeline(seed=0)``, one prefill, 32 greedy steps) run by the
port under ``DIR/src``: prefill ms, decode ms/token (mean and median of
the steps, host clock around synchronised steps), the host ms a step
spends inside the ``flash_decode_partial`` wrapper (its 24 calls) and
outside it, and one call at layer 0's cache alone: its host time (mean
of 200 calls, enqueue only) and CUDA events per call. Run it on two
checkouts in one session (A, B, B, A) to compare them on one card.

Each prints one JSON object as its last line, with the card's name and
power limit, and writes it to ``--out`` too.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def _import_port(root: Path):
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    assert root.resolve() in where.parents, (root, where)
    return repro_torch


def device_ms(fn, flush, calls: int, part: str) -> float:
    """Device ms per call of the kernels whose name holds ``part``, summed
    over their launches (torch.profiler), ``flush`` read before each
    call."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and part in e.name)
    assert us > 0, f"no device time for {part}"
    return us / 1e3 / calls


def probe_split(root: Path) -> dict:
    _import_port(root)
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import ops as fd_ops

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.ones(100 << 20, device="cuda")  # 400 MB, 8 x the L2
    H, KH, T, d = 32, 8, 4096, 80
    rng = np.random.default_rng(0)
    shapes = {}
    for B in (4, 1):
        q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                   device="cuda").bfloat16()
                   for s in ((B, H, d), (B, T, KH, d), (B, T, KH, d)))
        rounds = []
        for _ in range(3):
            rounds.append({sp: device_ms(
                lambda: fd_ops._partial_split(q, k, v, d ** -0.5, sp),
                flush, 50, "fd::decode_") for sp in (128, 256, 512, 1024)})
        chosen = fd_ops.choose_split(B, KH, T, H // KH, sms)
        shapes[f"B={B}"] = dict(
            chosen=chosen, blocks={sp: B * KH * -(-T // sp)
                                   for sp in rounds[0]},
            device_ms_rounds=rounds,
            device_ms_median={sp: statistics.median(r[sp] for r in rounds)
                              for sp in rounds[0]})
        print(f"B={B} T={T} H={H} KH={KH} d={d} bf16, {sms} SMs: "
              f"choose_split {chosen}; device ms a call by keys a split "
              f"(rounds): " + "; ".join(
                  f"{sp}: " + " ".join(f"{r[sp]:.5f}" for r in rounds)
                  for sp in rounds[0]))
    return dict(probe="split", sms=sms, shape=f"T={T} H={H} KH={KH} d={d} "
                "bf16", shapes=shapes)


def probe_decode(root: Path, steps: int = 32) -> dict:
    _import_port(root)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm import LMDataPipeline
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import init_params
    from repro_torch.sharding.rules import ShardingContext

    cfg, B, S = get_config("h2o-danube-1.8b"), 4, 8192
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda", torch.bfloat16)
    prompts = torch.as_tensor(LMDataPipeline(cfg.vocab, S, B, seed=0)
                              .next_batch()["tokens"], device="cuda").long()
    serve = ShardingContext(attn_impl="flash")
    prefill, decode = (make_prefill_step(cfg, serve),
                       make_decode_step(cfg, serve))
    prefill(params, {"tokens": prompts[:, :128]})  # load, warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True)
    # the host time spent inside the flash_decode wrapper in each step
    real, inside = fd_ops.flash_decode_partial, [0.0]

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            inside[0] += time.perf_counter() - t

    fd_ops.flash_decode_partial = timed
    step_ms, wrapper_ms = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        inside[0] = 0.0
        t0 = time.perf_counter()
        out, caches = decode(params, {"token": tok, "cache_pos": S + i},
                             caches)
        tok = out[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        wrapper_ms.append(inside[0] * 1e3)
    fd_ops.flash_decode_partial = real
    assert bool(torch.isfinite(out).all())

    # the first layer's cache: the stack keeps (layers, B, T, KH, d)
    kc, vc = caches["layer0"].k[0], caches["layer0"].v[0]
    H, d = cfg.attention.n_heads, cfg.attention.head_dim
    q = torch.randn(B, H, d, device="cuda").bfloat16()
    call = lambda: fd_ops.flash_decode_partial(  # noqa: E731
        q, kc, vc, scale=d ** -0.5, block_k=kc.shape[1])
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) * 1e6 / 200
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(200):
        call()
    end.record()
    end.synchronize()
    row = dict(probe="decode", root=str(root), B=B, S=S, steps=steps,
               prefill_ms=prefill_ms,
               decode_ms_per_token=statistics.mean(step_ms),
               decode_ms_median=statistics.median(step_ms),
               step_ms=step_ms, wrapper_ms=wrapper_ms,
               wrapper_ms_median=statistics.median(wrapper_ms),
               rest_ms_median=statistics.median(
                   a - b for a, b in zip(step_ms, wrapper_ms)),
               cache=list(kc.shape),
               flash_decode_host_us=host_us,
               flash_decode_event_ms=start.elapsed_time(end) / 200)
    print(f"{root}: prefill {prefill_ms:.1f} ms; decode "
          f"{row['decode_ms_per_token']:.3f} ms/token mean, "
          f"{row['decode_ms_median']:.3f} median ({min(step_ms):.3f}-"
          f"{max(step_ms):.3f}); median a step inside the flash_decode "
          f"wrapper {row['wrapper_ms_median']:.3f} ms, the rest "
          f"{row['rest_ms_median']:.3f} ms; flash_decode_partial alone "
          f"{host_us:.2f} us host a call, {row['flash_decode_event_ms']:.4f} "
          "ms by events")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("split", "decode"))
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="checkout whose src/repro_torch runs (default: "
                         "this one)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    row = (probe_split if args.probe == "split" else probe_decode)(args.root)
    row["card"] = smi_line()
    line = json.dumps(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
