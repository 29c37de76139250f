"""Seeded numpy inputs for the port's tests. JAX-free, so the GPU tests
(which run where JAX is not installed) can use them too."""
from __future__ import annotations

import numpy as np


def spd(rng, batch, n, scale=0.3):
    """(batch..., n, n) symmetric positive-definite float32 matrices."""
    A = rng.normal(size=tuple(batch) + (n, n)) * scale
    P = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)
    return P.astype(np.float32)


def random_frame_inputs(rng, n, m, C, M, obs, K=None, spread=4.0):
    """A bank of C tracks (every other one active) and M measurements,
    most of them near a track's observed coordinates so the gate
    passes, the rest clutter. Returns numpy (x, P, z, z_valid, active)
    plus mu for K."""
    if K is None:
        x = rng.uniform(-spread, spread, (C, n)).astype(np.float32)
        P = spd(rng, (C,), n)
        pos = x[:, obs]
    else:
        x0 = rng.uniform(-spread, spread, (C, n))
        x = (x0[None] + 0.05 * rng.normal(size=(K, C, n))).astype(np.float32)
        P = spd(rng, (K, C), n)
        pos = x0[:, obs]
    active = rng.random(C) < 0.7
    z = rng.uniform(-spread, spread, (M, m))
    near = rng.permutation(C)[:M]
    k = min(M, C) * 2 // 3
    z[:k] = pos[near[:k]] + 0.3 * rng.normal(size=(k, m))
    z = z[rng.permutation(M)].astype(np.float32)
    z_valid = rng.random(M) < 0.85
    if K is None:
        return x, P, z, z_valid, active
    mu = rng.dirichlet(np.ones(K), size=C).astype(np.float32)
    return x, P, mu, z, z_valid, active


def replay_inputs(rng, model, N, T, drop=0.0, extent=20.0):
    """A pre-associated stream for N tracks over T frames: each track
    moves at a constant velocity from a random start within ±``extent``
    and is measured with noise at 30 FPS. Returns numpy (x0 (N, n),
    P0 (N, n, n), zs (T, N, m), valid (T, N)); a ``drop`` share of the
    (frame, track) entries is invalid and holds NaN."""
    n, m = model.n, model.m
    start = rng.uniform(-extent, extent, (N, m))
    vel = rng.normal(size=(N, m))
    t = np.arange(1, T + 1)[:, None, None] / 30.0
    zs = start[None] + vel[None] * t + 0.3 * rng.normal(size=(T, N, m))
    x0 = np.tile(np.asarray(model.x0), (N, 1)) + 0.1 * rng.normal(size=(N, n))
    P0 = np.tile(np.asarray(model.P0), (N, 1, 1))
    valid = rng.random((T, N)) >= drop
    zs[~valid] = np.nan
    return (x0.astype(np.float32), P0.astype(np.float32),
            zs.astype(np.float32), valid)
