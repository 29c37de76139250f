"""The live tracking frame of one checkout, on one NVIDIA GPU.

    python3 scripts/frame_probe.py --root DIR [--out FILE] [--kinds imm]

The submit loop of ``chip_smoke.py`` phase 3 run by the port under
``DIR/src``, alone (no route checks between frames):
``TrackingEngine(model, TrackerConfig(capacity=1024, max_meas=256),
device="cuda").submit`` over the 300 frames of ``mot_scene(seed=7)``
(200 targets, 20 clutter detections a frame) for lkf, ekf and imm.
Per cell: frames per second and ms a frame (host clock around each
submit, the engine's own stats), and the fused frame kernel's device
time per call on the last frame's inputs (CUDA events around 50 calls
queued behind ~50 ms of device spin, so the events time the device,
not the host's pace); for a frame whose wrapper (``katana_frame``,
``katana_imm_frame``) takes ``launch_events``, also each launch's device
time (predict, cost tile, greedy, update) from events the frame records
between them; and every kernel's device time a call by torch.profiler's
kernel durations (20 calls, one session a cell, printed with the events
it recorded). Run it on two checkouts one after the other (A, B, B, A)
on one machine to compare them on one card: the host's speed moves
between machines.

The last line is one JSON object with the card's name and power limit;
``--out`` gets it too.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def launch_ms(call, torch, n: int = 50):
    """Mean device ms of each of the IMM frame's launches: ``call(events)``
    has the device record five events around them (predict, cost, greedy,
    update), n calls queued behind ~50 ms of device spin."""
    def five():
        return [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    call(five())
    sets = [five() for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # clock cycles
    for evs in sets:
        call(evs)
    torch.cuda.synchronize()
    names = ("predict", "cost", "greedy", "update")
    out = {nm: sum(e[i].elapsed_time(e[i + 1]) for e in sets) / n
           for i, nm in enumerate(names)}
    out["frame"] = sum(e[0].elapsed_time(e[4]) for e in sets) / n
    return out


def profiled_ms(call, torch, n: int = 20):
    """({kernel name: device ms a call}, {kernel name: events}) from the
    kernel durations of one torch.profiler session over n calls."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ms, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] = (ms.get(e.name, 0.0)
                          + e.time_range.elapsed_us() / 1e3 / n)
            count[e.name] = count.get(e.name, 0) + 1
    return ms, count


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    ap.add_argument("--kinds", default="lkf,ekf,imm",
                    help="the cells to run, comma-separated")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import repro_torch
    assert root in Path(repro_torch.__file__).resolve().parents, root
    from repro_torch.core import filters, tracker
    from repro_torch.data import trajectories as traj
    from repro_torch.kernels.katana_bank import ops
    from repro_torch.serving.engine import TrackingEngine

    C, M, T = 1024, 256, 300
    cells = {}
    for kind in args.kinds.split(","):
        is_imm = kind == "imm"
        model = filters.make_imm() if is_imm else filters.get_filter(kind)
        smodel = filters.get_filter("cv9") if is_imm else model
        scene = traj.SceneConfig(T=T, max_targets=200, birth_rate=1.0,
                                 death_rate=0.002, clutter_rate=20.0,
                                 extent=200.0, max_meas=M)
        z, valid, _ = traj.mot_scene(smodel, scene, seed=7)
        eng = TrackingEngine(model, tracker.TrackerConfig(capacity=C,
                                                          max_meas=M),
                             device="cuda")
        for t in range(T):
            eng.submit(z[t][valid[t]].astype(np.float32))
        fps = eng.stats.fps

        bank = eng.bank
        meas = z[T - 1][valid[T - 1]].astype(np.float32)
        zt = torch.zeros((M, model.m), device="cuda")
        zt[:len(meas)] = torch.as_tensor(meas, device="cuda")
        vt = torch.zeros((M,), dtype=torch.bool, device="cuda")
        vt[:len(meas)] = True
        gate, rounds = tracker.CHI2_99[model.m], min(C, M)
        if is_imm:
            call = lambda: ops.katana_imm_frame(  # noqa: E731
                model, bank.x, bank.P, bank.mu, zt, vt, bank.active, gate,
                rounds)
        else:
            call = lambda: ops.katana_frame(  # noqa: E731
                model, bank.x, bank.P, zt, vt, bank.active, gate, rounds)
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # clock cycles
        start.record()
        for _ in range(50):
            call()
        end.record()
        end.synchronize()
        kernel_ms = start.elapsed_time(end) / 50
        cells[kind] = dict(fps=fps, ms_per_frame=1e3 / fps,
                           frame_kernel_device_ms=kernel_ms)
        print(f"[{kind}] {T} frames: {fps:.1f} FPS, {1e3 / fps:.3f} ms a "
              f"frame; the frame kernel {kernel_ms:.4f} device ms a call",
              flush=True)
        wrapper = ops.katana_imm_frame if is_imm else ops.katana_frame
        if "launch_events" in inspect.signature(wrapper).parameters:
            if is_imm:
                parts = launch_ms(lambda evs: ops.katana_imm_frame(
                    model, bank.x, bank.P, bank.mu, zt, vt, bank.active,
                    gate, rounds, launch_events=evs), torch)
            else:
                parts = launch_ms(lambda evs: ops.katana_frame(
                    model, bank.x, bank.P, zt, vt, bank.active, gate,
                    rounds, launch_events=evs), torch)
            cells[kind]["launch_device_ms"] = parts
            print(f"[{kind}] device ms a launch (events, 50 calls): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()),
                  flush=True)
        prof, count = profiled_ms(call, torch)
        cells[kind]["profiler_ms"] = prof
        cells[kind]["profiler_events"] = count
        print(f"[{kind}] device ms a call by torch.profiler (events of 20 "
              "calls): " + ", ".join(
                  f"{k[:48]} {v:.4f} ({count[k]})"
                  for k, v in sorted(prof.items(), key=lambda kv: -kv[1])),
              flush=True)
    result = dict(root=str(root), card=smi_line(), cells=cells)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
