#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (no phase's exception is caught; any failure exits non-zero):
  1. device and build: the card's name and power limit, then every CUDA
     kernel of the live frame built from the repo's sources (build time
     and the compiler's register/spill lines);
  2. each kernel against its plain PyTorch version on the same CUDA
     tensors at the serving size (C=1024 tracks, M=256 measurements):
     identical assoc, states within 1e-4 (IMM 5e-4);
  3. the main path: ``TrackingEngine(..., device="cuda").submit`` over a
     300-frame dense-sky scene (200 targets, 20 clutter detections per
     frame) for the lkf, ekf and imm workloads, each frame held against
     the port's einsum route on the card (identical assoc and track ids)
     and the states against that route run in float64 (see ROUTE_SLACK),
     the launch counters equal to the frame count; then the kernel,
     plain-version and einsum-route times at this shape (CUDA events),
     each CUDA kernel's device time (torch.profiler) and the least time
     the frame's data needs (bound_ms);
  4. one JSON line with the kernel table, then the status line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import bank as bank_lib  # noqa: E402
from repro_torch.core import filters, tracker  # noqa: E402
from repro_torch.data import trajectories as traj  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.katana_bank import ops, ref  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402

C_SERVE, M_SERVE, T_SERVE = 1024, 256, 300
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
# kernel vs its plain version (the same op stream: measured bitwise)
TOL = {"lkf": 1e-4, "ekf": 1e-4, "imm": 5e-4}
# Route check. The two float32 routes each carry their own rounding
# error against exact arithmetic, and at this scene's scale (positions
# up to ~200, velocities estimated over dt = 1/30 s, coasting covariance
# entries in the thousands) that error alone can exceed TOL, so their
# gap is printed, not held to TOL. Each state field of the fused route
# is held to the einsum route run in float64, by the largest
# |d| / max(1, |float64 value|) over the bank and the frames: within TOL,
# or at most ROUTE_SLACK times the float32 einsum route's own error.
ROUTE_SLACK = 2.0
WINDOW = 50  # frames per line of the printed per-window errors
REPLACES = {
    "katana_frame": "src/repro/kernels/katana_bank/kernel.py:1280 "
                    "(katana_frame_step -> pallas_call :1297)",
    "katana_imm_frame": "src/repro/kernels/katana_bank/kernel.py:1323 "
                        "(katana_imm_frame_step -> pallas_call :1341)",
    "greedy_assign": "src/repro/kernels/katana_bank/kernel.py:1371 "
                     "(greedy_assign_step -> pallas_call :1391)",
}
SOURCES = {
    "katana_frame": "src/repro_torch/kernels/katana_bank/csrc/frame.cu",
    "katana_imm_frame": "src/repro_torch/kernels/katana_bank/csrc/imm_frame.cu",
    "greedy_assign": "src/repro_torch/kernels/katana_bank/csrc/greedy.cu",
}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> dict:
    """Device milliseconds per call by kernel name (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t > 0:
            out[ev.key] = t / iters / 1e3
    return out


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def max_rel(a, ref) -> float:
    """Largest |a - ref| / max(1, |ref|)."""
    ref = ref.double()
    return float(((a.double() - ref).abs() / ref.abs().clamp_min(1.0)).max())


# ---------------------------------------------------------------------------
# Least time for the work: bytes each input read once + each output written
# once over HBM, vs the float32 operations these inputs need over the peak.
# The operations are counted on the plain versions' op stream (ref.py, zero
# terms of F/Q/R pruned) and scaled by what this frame's data needs: the
# predict for each active track, the cost for each active x valid pair, the
# greedy's two argmin comparisons per such pair per wave run, the update
# for each assigned track.
# ---------------------------------------------------------------------------

class OpCount(TorchDispatchMode):
    """Counts the float operations of the torch ops run inside it: one
    per output element of each arithmetic op (``1.0 / x``, which torch
    runs as a reciprocal times 1.0, counts once)."""
    ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "exp",
             "log", "sin", "cos", "maximum", "minimum", "clamp_min"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        unit = (name == "mul" and len(args) == 2
                and isinstance(args[1], float) and args[1] == 1.0)
        if name in self.ARITH and not unit:
            self.ops += out.numel()
        return out


def _lanes(*shape):
    return [torch.rand(1) for _ in range(int(np.prod(shape)))]


def _square(n, lanes):
    return [[lanes[i * n + j] for j in range(n)] for i in range(n)]


def stream_ops(model):
    """Float operations of the frame's op stream (ref.py) per active
    track, per (active track, valid measurement) pair and per assigned
    track, for a FilterModel or a K>1 IMMModel."""
    n, m = model.n, model.m
    imm = isinstance(model, filters.IMMModel)
    obs = ref.check_selector(model.models[0] if imm else model)
    z = torch.rand(1, m)
    if imm:
        K = model.K
        entries, V = ref.plan_imm_tables(model.models)
        tabv = [torch.as_tensor(row, dtype=torch.float32) for row in V]
        Ftab, Qtab, Rtab = ([[c if isinstance(c, float) else tabv[c[1]]
                              for c in row] for row in entries[nm]]
                            for nm in ("F", "Q", "R"))
        Pi = [[float(v) for v in row] for row in np.asarray(model.trans)]
        xv = [torch.rand(K) for _ in range(n)]
        P = _square(n, [torch.rand(K) for _ in range(n * n)])
        mu = torch.full((K,), 1.0 / K)
        with OpCount() as track:
            x_mix, P_mix, cbar = ref._imm_mix(xv, P, mu, Pi, n, K, 1)
            xp = ref._matvec(Ftab, x_mix, n)
            Pp = ref._predict_cov(Ftab, P_mix, Qtab, n)
            inno = ref._innovation(Pp, Rtab, obs, n, m)
            # the combined estimate x_c of every track
            for d in range(n):
                ref._dot(cbar, [xp[d][k:k + 1] for k in range(K)], K)
        with OpCount() as pair:
            d = ref.cost_tile([xp[o] for o in obs], inno[1], z, m)
            ref._dot(cbar, [d[:, k] for k in range(K)], K)
        with OpCount() as upd:
            ll = ref._update(xp, Pp, [z[0, r].expand(K) for r in range(m)],
                             obs, n, m, inno, True)[2]
            ref._mode_posterior(cbar, ll, K, 1)
    else:
        R = [[float(v) for v in row] for row in np.asarray(model.R)]
        with OpCount() as track:
            xp, Pp = ref._predict_single(model, _lanes(n),
                                         _square(n, _lanes(n, n)))
            inno = ref._innovation(Pp, R, obs, n, m)
        with OpCount() as pair:
            ref.cost_tile([xp[o] for o in obs], inno[1], z, m)
        with OpCount() as upd:
            ref._update(xp, Pp, [z[0, r:r + 1] for r in range(m)], obs, n, m,
                        inno, False)
    # + the gate test of each pair
    return track.ops, pair.ops + 1, upd.ops


def frame_work(model, C, M, n_active, n_valid, n_assigned, waves):
    """(bytes, operations) of one frame call on this frame's data."""
    n, m, f = model.n, model.m, 4
    K = getattr(model, "K", 1)
    nbytes = (2 * K * C * (n + n * n) * f + M * m * f + M + C + C * f)
    if K > 1:
        nbytes += 2 * C * K * f + C * n * f  # mu in and out, x_c out
    per_track, per_pair, per_assigned = stream_ops(model)
    pairs = n_active * n_valid
    ops = (n_active * per_track + pairs * per_pair + 2 * pairs * waves
           + n_assigned * per_assigned)
    return nbytes, ops


def greedy_work(C, n_active, n_valid, waves):
    """The frame's greedy: one read of the active x valid cost entries per
    wave run, two argmin comparisons per entry per wave, assoc out."""
    pairs = n_active * n_valid
    return waves * pairs * 4 + C * 4, 2 * pairs * waves


def bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------

def random_bank(rng, n, m, C, M, obs, K=None, spread=100.0):
    """C tracks (70% active), M measurements, two thirds of them near a
    track's observed coordinates, as CUDA tensors."""
    x0 = rng.uniform(-spread, spread, (C, n))
    A = rng.normal(size=(K or 1, C, n, n)) * 0.3
    P = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)).astype(np.float32)
    z = rng.uniform(-spread, spread, (M, m))
    k = min(M, C) * 2 // 3
    z[:k] = x0[rng.permutation(C)[:k]][:, obs] + 0.3 * rng.normal(size=(k, m))
    dev = torch.device("cuda")
    out = dict(
        z=torch.as_tensor(z[rng.permutation(M)], dtype=torch.float32,
                          device=dev),
        z_valid=torch.as_tensor(rng.random(M) < 0.9, device=dev),
        active=torch.as_tensor(rng.random(C) < 0.7, device=dev))
    if K is None:
        out["x"] = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        out["P"] = torch.as_tensor(P[0], device=dev)
    else:
        x = x0[None] + 0.05 * rng.normal(size=(K, C, n))
        out["x"] = torch.as_tensor(x, dtype=torch.float32, device=dev)
        out["P"] = torch.as_tensor(P, device=dev)
        out["mu"] = torch.as_tensor(
            rng.dirichlet(np.ones(K), size=C), dtype=torch.float32,
            device=dev)
    return out


def phase_kernels_vs_plain():
    """Every kernel against its plain version on the same CUDA tensors."""
    rng = np.random.default_rng(0)
    C, M = C_SERVE, M_SERVE
    errs = {}
    cost = np.round(rng.uniform(0, 20, (C, M)) * 2) / 2
    cost_t = torch.as_tensor(cost, dtype=torch.float32, device="cuda")
    valid_t = torch.as_tensor(rng.random((C, M)) > 0.3, device="cuda")
    a, wa = ops.katana_greedy_assign(cost_t, valid_t, 6.0, M,
                                     return_waves=True)
    b, wb = ref.greedy_assign_plain(cost_t, valid_t, 6.0, M,
                                    return_waves=True)
    assert torch.equal(a, b), "greedy kernel != plain"
    assert int(wa) == wb
    errs["greedy_assign"] = max_diff(a, b)
    print(f"greedy_assign C={C} M={M} ties: assoc identical, "
          f"{int((a >= 0).sum())} assigned in {wb} waves")

    frame_err = 0.0
    for kind in ("lkf", "ekf"):
        model = filters.get_filter(kind)
        obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
        bk = random_bank(rng, model.n, model.m, C, M, obs)
        args = (bk["x"], bk["P"], bk["z"], bk["z_valid"], bk["active"],
                11.34 if model.m == 3 else 13.28, M)
        got = ops.katana_frame(model, *args)
        want = ref.katana_frame_plain(model, *args)
        assert torch.equal(got[2], want[2]), f"{kind}: assoc differs"
        dx, dP = max_diff(got[0], want[0]), max_diff(got[1], want[1])
        assert max(dx, dP) <= TOL[kind], (kind, dx, dP)
        frame_err = max(frame_err, dx, dP)
        print(f"katana_frame {kind} C={C} M={M}: assoc identical "
              f"({int((got[2] >= 0).sum())} assigned), max|dx|={dx:.3g} "
              f"max|dP|={dP:.3g}")
    errs["katana_frame"] = frame_err

    imm_err = 0.0
    imm = filters.make_imm()
    bk = random_bank(rng, 9, 3, C, M, [0, 1, 2], K=4)
    args = (bk["x"], bk["P"], bk["mu"], bk["z"], bk["z_valid"],
            bk["active"], 11.34, M)
    got = ops.katana_imm_frame(imm, *args)
    want = ref.katana_imm_frame_plain(imm, *args)
    assert torch.equal(got[4], want[4]), "imm: assoc differs"
    d = [max_diff(g, w) for g, w in zip(got[:4], want[:4])]
    assert max(d) <= TOL["imm"], d
    imm_err = max(d)
    print(f"katana_imm_frame K=4 C={C} M={M}: assoc identical "
          f"({int((got[4] >= 0).sum())} assigned), max|d| x,P,mu,x_c = "
          + " ".join(f"{v:.3g}" for v in d))
    ekf = filters.get_filter("ekf")
    bk = random_bank(rng, 8, 4, C, M, [0, 1, 2, 4], K=1)
    args = (bk["x"], bk["P"], bk["mu"], bk["z"], bk["z_valid"],
            bk["active"], 13.28, M)
    got = ops.katana_imm_frame(filters.as_imm(ekf), *args)
    want = ref.katana_imm_frame_plain(filters.as_imm(ekf), *args)
    single = ops.katana_frame(ekf, bk["x"][0], bk["P"][0], *args[3:])
    assert torch.equal(got[4], want[4]), "imm K=1: assoc differs"
    assert torch.equal(got[0][0], single[0]) and torch.equal(got[1][0],
                                                               single[1])
    d = [max_diff(g, w) for g, w in zip(got[:4], want[:4])]
    assert max(d) <= TOL["ekf"], d
    imm_err = max(imm_err, *d)
    print(f"katana_imm_frame K=1 (ekf) C={C} M={M}: assoc identical, "
          f"bitwise equal to katana_frame, max|d| vs plain = {max(d):.3g}")
    errs["katana_imm_frame"] = imm_err
    torch.cuda.synchronize()
    return errs


def padded(meas, m, M):
    z = torch.zeros((M, m), dtype=torch.float32)
    v = torch.zeros((M,), dtype=torch.bool)
    k = min(len(meas), M)
    z[:k] = torch.as_tensor(meas[:k], dtype=torch.float32)
    v[:k] = True
    return z.cuda(), v.cuda()


def states(res):
    """The state fields of a FrameResult that the route check compares."""
    out = dict(x=res.bank.x, P=res.bank.P)
    if res.mode_probs is not None:
        out.update(mu=res.mode_probs, x_est=res.x_est)
    return out


def phase_main_path(kind):
    """The engine over the 300-frame scene, each frame held against the
    einsum route on the card (float32 and float64); then the times at
    this shape."""
    model = filters.make_imm() if kind == "imm" else filters.get_filter(kind)
    smodel = filters.get_filter("cv9") if kind == "imm" else model
    assert ops.frame_kernel_supported(model), kind
    cfg = tracker.TrackerConfig(capacity=C_SERVE, max_meas=M_SERVE)
    cfg_e = dataclasses.replace(cfg, fused_frame=False)
    cfg_64 = dataclasses.replace(cfg_e, dtype="float64")
    scene = traj.SceneConfig(T=T_SERVE, max_targets=200, birth_rate=1.0,
                             death_rate=0.002, clutter_rate=20.0,
                             extent=200.0, max_meas=M_SERVE)
    z, valid, _ = traj.mot_scene(smodel, scene, seed=7)
    is_imm = kind == "imm"
    step = tracker.imm_frame_step if is_imm else tracker.frame_step
    init = bank_lib.init_imm_bank if is_imm else bank_lib.init_bank
    name = "katana_imm_frame" if is_imm else "katana_frame"

    eng = TrackingEngine(model, cfg, device="cuda")
    bank_e = eng.bank
    bank_64 = init(model, C_SERVE, dtype=torch.float64, device="cuda")
    # per frame and state field, max_rel of: fused vs einsum32 (gap),
    # fused vs einsum64, einsum32 vs einsum64; the float64 route is
    # compared while its association stays identical
    gap, err_f, err_32 = {}, {}, {}
    lockstep_64 = T_SERVE
    confirmed, assigned = 0, 0
    ops.reset_launches()
    for t in range(T_SERVE):
        meas = z[t][valid[t]].astype(np.float32)
        confirmed += len(eng.submit(meas))
        launches = dict(ops.LAUNCHES)
        zt, vt = padded(meas, model.m, M_SERVE)
        res = step(model, cfg_e, bank_e, zt, vt)
        bank_e = res.bank
        assert torch.equal(eng.last.assoc, res.assoc), (kind, t, "assoc")
        assert torch.equal(eng.bank.track_id, bank_e.track_id), (kind, t)
        assigned += int((res.assoc >= 0).sum())
        s_f, s_32 = states(eng.last), states(res)
        for f in s_f:
            gap.setdefault(f, []).append(max_rel(s_f[f], s_32[f]))
        if t < lockstep_64:
            r64 = step(model, cfg_64, bank_64, zt.double(), vt)
            if not torch.equal(r64.assoc, res.assoc):
                lockstep_64 = t
                continue
            bank_64, s_64 = r64.bank, states(r64)
            for f in s_f:
                err_f.setdefault(f, []).append(max_rel(s_f[f], s_64[f]))
                err_32.setdefault(f, []).append(max_rel(s_32[f], s_64[f]))
    print(f"[{kind}] {T_SERVE} frames: launches {launches}; "
          f"assoc and track ids identical to the einsum route every frame; "
          f"the float64 einsum route's assoc identical for {lockstep_64} "
          "frames")
    assert launches[name] == T_SERVE and launches["greedy_assign"] == T_SERVE
    assert lockstep_64 > 0, kind

    def windows(v):
        return [max(v[i:i + WINDOW]) for i in range(0, len(v), WINDOW)]

    route = {}
    for f in gap:
        route[f] = dict(gap=windows(gap[f]), fused_vs_f64=windows(err_f[f]),
                        einsum_vs_f64=windows(err_32[f]))
        print(f"[{kind}] {f} max|d|/max(1,|ref|) per {WINDOW} frames: "
              + "; ".join(f"{k} " + " ".join(f"{v:.3g}" for v in vs)
                          for k, vs in route[f].items()))
        e_f, e_32 = max(err_f[f]), max(err_32[f])
        assert e_f <= max(TOL[kind], ROUTE_SLACK * e_32), (kind, f, e_f, e_32)
    fps = eng.stats.fps

    # times at this shape on the last frame's inputs (final bank)
    bank = eng.bank
    zt, vt = padded(z[T_SERVE - 1][valid[T_SERVE - 1]], model.m, M_SERVE)
    gate, rounds = tracker.CHI2_99[model.m], min(C_SERVE, M_SERVE)
    n_active, n_valid = int(bank.active.sum()), int(vt.sum())
    if is_imm:
        kargs = (bank.x, bank.P, bank.mu, zt, vt, bank.active, gate, rounds)
        kern = lambda: ops.katana_imm_frame(model, *kargs)  # noqa: E731
        plain = lambda: ref.katana_imm_frame_plain(model, *kargs)  # noqa
        out = ops.katana_imm_frame(model, *kargs, return_waves=True)
        n_assigned, waves = int((out[4] >= 0).sum()), int(out[5])
    else:
        kargs = (bank.x, bank.P, zt, vt, bank.active, gate, rounds)
        kern = lambda: ops.katana_frame(model, *kargs)  # noqa: E731
        plain = lambda: ref.katana_frame_plain(model, *kargs)  # noqa: E731
        out = ops.katana_frame(model, *kargs, return_waves=True)
        n_assigned, waves = int((out[2] >= 0).sum()), int(out[3])
    nb, nops = frame_work(model, C_SERVE, M_SERVE, n_active, n_valid,
                          n_assigned, waves)
    ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    einsum_ms = cuda_ms(lambda: step(model, cfg_e, bank, zt, vt), 3,
                        warmup=1)
    bms, by = bound(nb, nops)
    prof = device_ms(kern)
    greedy_key = [k for k in prof if "greedy_waves_kernel<katana::FrameTile>"
                  in k]
    assert len(greedy_key) == 1, sorted(prof)
    gb, gby = bound(*greedy_work(C_SERVE, n_active, n_valid, waves))
    row = dict(frames=T_SERVE, fps=fps, ms_per_frame=1e3 / fps,
               mean_confirmed=confirmed / T_SERVE,
               mean_assigned=assigned / T_SERVE, kernel_ms=ms,
               plain_ms=plain_ms, einsum_frame_ms=einsum_ms, bound_ms=bms,
               bound_by=by, bytes=nb, operations=nops, waves=waves,
               active_last=n_active, valid_last=n_valid,
               assigned_last=n_assigned, launches=launches[name],
               greedy_launches=launches["greedy_assign"],
               greedy_device_ms=prof[greedy_key[0]], greedy_bound_ms=gb,
               greedy_bound_by=gby, float64_lockstep_frames=lockstep_64,
               route=route, device_ms=prof)
    print(f"[{kind}] fps={fps:.1f} ms/frame={1e3 / fps:.3f} "
          f"mean confirmed={confirmed / T_SERVE:.1f} | {name}: {ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, einsum frame {einsum_ms:.3f} ms, "
          f"bound {bms:.6f} ms by {by}: {nb} B, {nops} ops for "
          f"{n_active} active x {n_valid} valid, {n_assigned} assigned, "
          f"{waves} waves)")
    print(f"[{kind}] device ms per call: " + ", ".join(
        f"{k[:60]}={v:.4f}" for k, v in sorted(prof.items(),
                                                key=lambda kv: -kv[1])))

    greedy = None
    if kind == "lkf":
        # the in-frame greedy's device time is the main path's; beside it
        # the plain greedy and the standalone kernel on this frame's cost
        # (the canonical (C, M) layout of tracker.mahalanobis_cost)
        bank_p, z_pred, _S, Sinv, _ = bank_lib.predict_bank(model, bank)
        cost = tracker.mahalanobis_cost(z_pred, Sinv, zt).contiguous()
        pv = (bank.active[:, None] & vt[None, :]).contiguous()
        a, w = ops.katana_greedy_assign(cost, pv, gate, rounds,
                                        return_waves=True)
        b, wb = ref.greedy_assign_plain(cost, pv, gate, rounds,
                                        return_waves=True)
        assert torch.equal(a, b) and int(w) == wb
        g_ms = cuda_ms(lambda: ops.katana_greedy_assign(cost, pv, gate,
                                                        rounds), 50)
        g_plain = cuda_ms(lambda: ref.greedy_assign_plain(cost, pv, gate,
                                                          rounds), 3,
                          warmup=1)
        greedy = dict(kernel_ms=row["greedy_device_ms"], plain_ms=g_plain,
                      bound_ms=gb, bound_by=gby, waves=waves,
                      standalone_ms=g_ms, standalone_waves=wb)
        print(f"[lkf] greedy_assign in the frame: {greedy['kernel_ms']:.4f} "
              f"ms device (plain {g_plain:.3f} ms, bound {gb:.6f} ms by "
              f"{gby}, {waves} waves); standalone kernel on the (C, M) cost "
              f"{g_ms:.4f} ms")
    return row, greedy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = smi_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} sources "
          "(parallel nvcc)")
    for src, log in logs.items():
        print(f"  {src}:")
        for ln in log["ptxas"]:
            print(f"    {ln}")

    errs = phase_kernels_vs_plain()

    rows, greedy = {}, None
    for kind in ("lkf", "ekf", "imm"):
        rows[kind], g = phase_main_path(kind)
        greedy = greedy or g

    def entry(name, ms, plain_ms, bms, by, launches, extra):
        return dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches,
                    max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None, card=card,
                    **extra)

    lkf, ekf, imm = rows["lkf"], rows["ekf"], rows["imm"]
    kernels = [
        entry("katana_frame", lkf["kernel_ms"], lkf["plain_ms"],
              lkf["bound_ms"], lkf["bound_by"],
              lkf["launches"] + ekf["launches"],
              dict(shape=f"lkf C={C_SERVE} M={M_SERVE}", by_model={
                  k: {f: rows[k][f] for f in ("kernel_ms", "plain_ms",
                                               "bound_ms", "bound_by",
                                               "launches")}
                  for k in ("lkf", "ekf")})),
        entry("katana_imm_frame", imm["kernel_ms"], imm["plain_ms"],
              imm["bound_ms"], imm["bound_by"], imm["launches"],
              dict(shape=f"imm K=4 C={C_SERVE} M={M_SERVE}")),
        entry("greedy_assign", greedy["kernel_ms"], greedy["plain_ms"],
              greedy["bound_ms"], greedy["bound_by"],
              sum(r["greedy_launches"] for r in rows.values()),
              dict(shape=f"in the lkf frame, (M, C) cost tile C={C_SERVE} "
                         f"M={M_SERVE}, {greedy['waves']} waves; ms is "
                         "device time (torch.profiler)",
                   standalone_ms=greedy["standalone_ms"])),
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, rows=rows,
                 greedy=greedy, kernels=kernels,
                 seconds=time.perf_counter() - t_start), indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
