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
