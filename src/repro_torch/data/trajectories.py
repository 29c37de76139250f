"""Synthetic tracking scenarios: ground-truth dynamics + noisy detections.

Seeded numpy generators (the same draws as the JAX package's, so both
see identical arrays for the same seed): single-target sequences per
filter model and batches of them, multi-target MOT scenes with
birth/death and clutter, and maneuvering targets switching between
straight / coordinated-turn / accelerating segments (the IMM workload).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core.filters import FilterModel


def single_target(model: FilterModel, T: int, seed: int = 0,
                  meas_noise: float = None) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the model's own dynamics; returns (truth (T,n), z (T,m))."""
    rng = np.random.default_rng(seed)
    n, m = model.n, model.m
    x = np.array(model.x0, np.float64)
    x[: min(3, n)] += rng.normal(size=min(3, n))  # random start position
    Lq = np.linalg.cholesky(np.asarray(model.Q) + 1e-12 * np.eye(n))
    r = np.sqrt(np.diag(model.R)) if meas_noise is None else meas_noise
    truth = np.zeros((T, n))
    zs = np.zeros((T, m))
    H = np.asarray(model.H)
    for t in range(T):
        if model.is_linear:
            x = np.asarray(model.F) @ x
        else:
            x = model.f_np(x)
        x = x + Lq @ rng.normal(size=n)
        truth[t] = x
        zs[t] = H @ x + r * rng.normal(size=m)
    return truth, zs


def batched_targets(model: FilterModel, T: int, N: int, seed: int = 0):
    """(truth (T, N, n), z (T, N, m)): N independent targets, target k
    drawn by ``single_target`` with seed ``seed * 100003 + k``."""
    truths, zs = [], []
    for k in range(N):
        t, z = single_target(model, T, seed=seed * 100003 + k)
        truths.append(t)
        zs.append(z)
    return np.stack(truths, 1), np.stack(zs, 1)


def maneuvering_target(T: int, dt: float = 1.0 / 30.0, seed: int = 0,
                       speed: float = 3.0, omega: float = 0.7,
                       accel: float = 2.0, meas_noise: float = 0.3,
                       seg_len: int = 40) -> Tuple[np.ndarray, np.ndarray]:
    """One target switching between CV / CT / CA motion segments of
    ~``seg_len`` frames. Returns (truth (T, 9) as [p, v, a],
    z (T, 3) noisy position detections)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5.0, 5.0, 3)
    heading = rng.uniform(0, 2 * np.pi)
    v = np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0])
    truth = np.zeros((T, 9))
    zs = np.zeros((T, 3))
    t = 0
    while t < T:
        mode = rng.choice(["cv", "ct+", "ct-", "ca+", "ca-"])
        dur = int(rng.integers(seg_len // 2, seg_len + seg_len // 2))
        w = omega if mode == "ct+" else -omega
        for _ in range(min(dur, T - t)):
            v_prev = v
            if mode in ("ca+", "ca-"):
                sp = np.linalg.norm(v[:2]) or 1.0
                sign = 1.0 if mode == "ca+" else -1.0
                # accelerate/brake along track (never through zero speed)
                if sign < 0 and sp < 0.5 * speed:
                    sign = 1.0
                v = v + np.append(sign * accel * v[:2] / sp, 0.0) * dt
            elif mode in ("ct+", "ct-"):
                c, s = np.cos(w * dt), np.sin(w * dt)
                v = np.array([c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]])
            p = p + v * dt
            truth[t, :3], truth[t, 3:6] = p, v
            truth[t, 6:9] = (v - v_prev) / dt
            zs[t] = p + meas_noise * rng.normal(size=3)
            t += 1
            if t >= T:
                break
    return truth, zs


def maneuvering_batch(T: int, N: int, seed: int = 0,
                      **kw) -> Tuple[np.ndarray, np.ndarray]:
    """(truth (T, N, 9), z (T, N, 3)): N independent maneuvering
    targets, target k drawn with seed ``seed * 100003 + k``."""
    truths, zs = [], []
    for k in range(N):
        tr, z = maneuvering_target(T, seed=seed * 100003 + k, **kw)
        truths.append(tr)
        zs.append(z)
    return np.stack(truths, 1), np.stack(zs, 1)


@dataclass(frozen=True)
class SceneConfig:
    T: int = 120
    max_targets: int = 12
    birth_rate: float = 0.08     # per-frame probability of a new target
    death_rate: float = 0.005    # per-frame probability a target leaves
    p_detect: float = 0.95
    clutter_rate: float = 1.0    # Poisson mean false alarms per frame
    extent: float = 20.0         # scene half-width
    max_meas: int = 64


def mot_scene(model: FilterModel, cfg: SceneConfig, seed: int = 0):
    """Multi-target scene with birth/death, misses and clutter.

    Returns z (T, max_meas, m) padded measurements, valid (T, max_meas)
    bool, and truth: list[T] of (id, state) lists."""
    rng = np.random.default_rng(seed)
    n, m = model.n, model.m
    H = np.asarray(model.H)
    Lq = np.linalg.cholesky(np.asarray(model.Q) + 1e-12 * np.eye(n))
    r = np.sqrt(np.diag(model.R))

    targets = {}  # id -> state
    next_id = 0
    z_out = np.zeros((cfg.T, cfg.max_meas, m))
    valid = np.zeros((cfg.T, cfg.max_meas), bool)
    truth = []
    for t in range(cfg.T):
        if len(targets) < cfg.max_targets and (
                t == 0 or rng.random() < cfg.birth_rate):
            x = np.array(model.x0, np.float64)
            x[: min(3, n)] = rng.uniform(-cfg.extent, cfg.extent, min(3, n))
            targets[next_id] = x
            next_id += 1
        for tid in [k for k in targets if rng.random() < cfg.death_rate]:
            del targets[tid]
        meas = []
        frame_truth = []
        for tid in list(targets):
            x = targets[tid]
            x = (np.asarray(model.F) @ x) if model.is_linear else model.f_np(x)
            x = x + Lq @ rng.normal(size=n)
            targets[tid] = x
            frame_truth.append((tid, x.copy()))
            if rng.random() < cfg.p_detect:
                meas.append(H @ x + r * rng.normal(size=m))
        for _ in range(rng.poisson(cfg.clutter_rate)):
            meas.append(rng.uniform(-cfg.extent, cfg.extent, m))
        rng.shuffle(meas)
        meas = meas[: cfg.max_meas]
        for j, zz in enumerate(meas):
            z_out[t, j] = zz
            valid[t, j] = True
        truth.append(frame_truth)
    return z_out, valid, truth
