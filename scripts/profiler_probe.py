"""Repeated torch.profiler sessions in one process, on one NVIDIA GPU.

    python3 scripts/profiler_probe.py [--sessions 6] [--out FILE]

Runs itself twice as a child process: once with the environment as it is
(PyTorch's profiler, Kineto, finalizes CUPTI at the end of every session
unless TEARDOWN_CUPTI=0), once with TEARDOWN_CUPTI=0. Each child profiles
the same work in ``--sessions`` sessions: 20 live frames
(``ops.katana_frame``, lkf, C=1024, M=256) and 20 ``torch.mm`` of
1024 x 1024; from the second session on also 20 bf16 ``ssd_scan`` calls
(B=1, S=1024, H=4, P=64, N=128, chunk 256; four launches each) and 20
float32 ones (B=2, S=16384, H=24, P=64, N=128: one long launch each),
whose library is loaded and whose kernels first run only after the first
session ended. Per session it prints the events the profiler recorded
against the launches made (20 of each kernel name), and the device ms it
recorded against the CUDA-event time of the same calls. A session whose
counts fall short of the launches dropped events.

The last line is one JSON object with both children's sessions and the
card's name and power limit; ``--out`` gets it too.

    python3 scripts/profiler_probe.py --serve [--out FILE]

runs instead the serving profiles of ``chip_smoke.py`` (its "serve" job:
one prefill and one decode step of h2o-danube-1.8b, mamba2-130m,
granite-moe-1b-a400m and internvl2-2b, one encode of hubert-xlarge, at
the phases' full sizes) one after another in ONE child, each profile its
own torch.profiler session, and counts the events of the kernels the
step launched (flash_attention's ``flash_fwd``, flash_decode's
``decode_split``, the four ``ssd_`` launches) against the launches: a
session after the first that records fewer lost events. It prints each
profile's host seconds (weights, warm-up and the session) and the child's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 20


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def child(sessions: int) -> dict:
    """The sessions of one process: per session, per kernel name, the
    events recorded and their device ms, beside the launches made."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.filters import get_filter
    from repro_torch.kernels.katana_bank import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dev = "cuda"
    rng = np.random.default_rng(0)
    C, M = 1024, 256
    model = get_filter("lkf")
    x = torch.as_tensor(rng.uniform(-20, 20, (C, 6)), dtype=torch.float32,
                        device=dev)
    A = rng.normal(size=(C, 6, 6)) * 0.3
    P = torch.as_tensor(A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6),
                        dtype=torch.float32, device=dev)
    z = torch.as_tensor(rng.uniform(-20, 20, (M, 3)), dtype=torch.float32,
                        device=dev)
    zv = torch.ones(M, dtype=torch.bool, device=dev)
    act = torch.as_tensor(rng.random(C) < 0.7, device=dev)

    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)

    ssd_args = (mk(1, 1024, 4, 64).bfloat16(),
                torch.nn.functional.softplus(mk(1, 1024, 4)) * 0.5,
                mk(1, 1024, 128).bfloat16(), mk(1, 1024, 128).bfloat16(),
                -torch.exp(mk(4)))
    long_args = (mk(2, 16384, 24, 64),
                 torch.nn.functional.softplus(mk(2, 16384, 24)) * 0.5,
                 mk(2, 16384, 128), mk(2, 16384, 128), -torch.exp(mk(24)))
    a, b = mk(1024, 1024), mk(1024, 1024)

    def work(ssd: bool):
        for _ in range(CALLS):
            ops.katana_frame(model, x, P, z, zv, act, 11.34, M)
            torch.mm(a, b)
            if ssd:
                ssd_ops.ssd_scan(*ssd_args, chunk=256)
                ssd_ops.ssd_scan(*long_args, chunk=256)

    def timed(ssd: bool) -> float:
        work(ssd)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        work(ssd)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    events_ms = timed(False)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = []
    for s in range(sessions):
        if s == 1:
            events_ms = timed(True)  # the ssd library's first use
        with torch.profiler.profile(activities=acts) as prof:
            work(s > 0)
            torch.cuda.synchronize()
        kernels = {ev.key: dict(count=ev.count,
                                device_ms=ev.device_time_total / 1e3)
                   for ev in prof.key_averages()
                   if getattr(ev, "device_time_total", 0) > 0
                   and not ev.key.startswith("cuda")}  # the API calls
        total = sum(v["device_ms"] for v in kernels.values())
        out.append(dict(session=s, kernels=kernels, device_ms=total))
        short = {k: v["count"] for k, v in kernels.items()
                 if v["count"] < CALLS}
        out[-1]["short"] = short
        print(f"  session {s}: {len(kernels)} kernel names, "
              f"{sum(v['count'] for v in kernels.values())} events "
              f"(names with fewer than {CALLS}: {short or 'none'}), "
              f"{total:.4f} device ms (CUDA events around the same work: "
              f"{events_ms:.4f} ms)", flush=True)
    return dict(teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                calls=CALLS, events_ms=events_ms, sessions=out)


SERVE = [  # (arch, batch kind, B, S) at chip_smoke.py's sizes
    ("h2o-danube-1.8b", "tokens", 4, 8192),
    ("mamba2-130m", "tokens", 8, 32768),
    ("granite-moe-1b-a400m", "tokens", 8, 4096),
    ("internvl2-2b", "vlm", 4, 3840),
    ("hubert-xlarge", "audio", 4, 1500),
]


def serve_child() -> dict:
    """Every serving profile in this one process: per profile, the events
    of the step's kernels against the launches it made."""
    import time

    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build()
    out = []
    t_child = time.perf_counter()
    for arch, kind, B, S in SERVE:
        cfg = cs.get_config(arch)
        gen = torch.Generator("cuda").manual_seed(5)
        if kind == "audio":
            batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                           device="cuda").bfloat16()}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                             generator=gen, device="cuda")}
        if kind == "vlm":
            batch["embeds"] = torch.randn(
                (B, cfg.frontend_positions, cfg.d_model), generator=gen,
                device="cuda").bfloat16()
            S += cfg.frontend_positions
        t0 = time.perf_counter()
        res = cs.profile_job(batch, "serve", arch=arch, S=S)
        seconds = time.perf_counter() - t0
        attn = sum(k == "attn" for k in cfg.layer_kinds())
        ssm = cfg.n_layers - attn
        for step, (_, _, _, count) in res.items():
            def events(part):
                return sum(n for name, n in count.items() if part in name)

            decode = step == "decode_step"
            want = {"flash_fwd": 0 if decode else attn,
                    "decode_split": attn if decode else 0,
                    "ssd_": 0 if decode else 4 * ssm}
            got = {k: events(k) for k in want}
            out.append(dict(arch=arch, step=step, events=got, want=want,
                            lost={k: want[k] - got[k] for k in want
                                  if got[k] < want[k]},
                            seconds=seconds))
            print(f"  {arch} {step}: events {got} against launches {want}"
                  f" ({seconds:.1f} s with the weights and warm-up)",
                  flush=True)
        del batch
        torch.cuda.empty_cache()
    return dict(profiles=out, child_s=time.perf_counter() - t_child)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--serve-child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.sessions)))
        return 0
    if args.serve_child:
        print(json.dumps(serve_child()))
        return 0
    if args.serve:
        import time

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--serve-child"],
                              capture_output=True, text=True, timeout=1200)
        print(proc.stdout.rsplit("\n", 2)[0])
        if proc.returncode:
            print(proc.stderr[-4000:])
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        lost = [p for p in run["profiles"] if p["lost"]]
        result = dict(card=smi_line(), serve=run,
                      wall_s=time.perf_counter() - t0,
                      sessions_that_lost_events=lost)
        print(f"one child, {len(run['profiles'])} sessions: "
              f"{len(lost)} lost events; child {run['child_s']:.1f} s, "
              f"wall {result['wall_s']:.1f} s")
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    runs = []
    for env in ({}, {"TEARDOWN_CUPTI": "0"}):
        e = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        print(f"child with {env or 'the environment as it is'}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--child",
                               "--sessions", str(args.sessions)],
                              env={**e, **env}, capture_output=True,
                              text=True, timeout=600)
        print(proc.stdout.rsplit("\n", 2)[0])
        if proc.returncode:
            print(proc.stderr[-4000:])
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for run in runs:
        names = {k for sess in run["sessions"][1:] for k in sess["kernels"]}
        for sess in run["sessions"][1:]:
            missing = sorted(names - set(sess["kernels"]))
            print(f"TEARDOWN_CUPTI={run['teardown_cupti']} session "
                  f"{sess['session']}: kernel names missing {missing or 'none'}"
                  f", short {sess['short'] or 'none'}")
    result = dict(card=smi_line(), runs=runs)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
