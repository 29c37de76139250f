"""numpy oracle of the Kalman and IMM recursions, float64 by default.

The textbook recursion in its clearest form, one track at a time, with
no performance concerns: the ground truth that the kernels, their plain
versions and the replay path are held against (tests, ``chip_smoke.py``).
The serving and replay paths never call it.

Every function takes ``dtype`` (float64 unless asked): the same
recursion run in float32 measures how far plain float32 arithmetic
drifts from exact on a given stream, which is the yardstick for the
kernels' own float32 error. The EKF dynamics ``f_np`` / ``F_jac_np``
evaluate in float64 and are rounded to ``dtype``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.filters import FilterModel


def predict(model: FilterModel, x: np.ndarray, P: np.ndarray,
            dtype=np.float64):
    x = np.asarray(x, dtype)
    P = np.asarray(P, dtype)
    if model.is_linear:
        F = np.asarray(model.F, dtype)
        x_pred = F @ x
    else:
        x_pred = np.asarray(model.f_np(x), dtype)
        F = np.asarray(model.F_jac_np(x), dtype)
    P_pred = F @ P @ F.T + np.asarray(model.Q, dtype)
    return x_pred, P_pred


def update(model: FilterModel, x_pred: np.ndarray, P_pred: np.ndarray,
           z: np.ndarray, dtype=np.float64):
    H = np.asarray(model.H, dtype)
    R = np.asarray(model.R, dtype)
    y = np.asarray(z, dtype) - H @ x_pred
    S = H @ P_pred @ H.T + R
    K = P_pred @ H.T @ np.linalg.inv(S)
    x_new = x_pred + K @ y
    P_new = (np.eye(model.n, dtype=dtype) - K @ H) @ P_pred
    P_new = dtype(0.5) * (P_new + P_new.T)
    return x_new, P_new


def step(model: FilterModel, x: np.ndarray, P: np.ndarray, z: np.ndarray,
         dtype=np.float64):
    return update(model, *predict(model, x, P, dtype), z, dtype)


def run(model: FilterModel, zs: np.ndarray, x0=None, P0=None,
        dtype=np.float64):
    """Filter a (T, m) measurement sequence; returns (states (T, n),
    covariances (T, n, n))."""
    x = np.asarray(model.x0 if x0 is None else x0, dtype)
    P = np.asarray(model.P0 if P0 is None else P0, dtype)
    out = np.zeros((len(zs), model.n), dtype)
    covs = np.zeros((len(zs), model.n, model.n), dtype)
    for t, z in enumerate(zs):
        x, P = step(model, x, P, z, dtype)
        out[t] = x
        covs[t] = P
    return out, covs


def run_batched(model: FilterModel, zs: np.ndarray, x0: np.ndarray,
                P0: np.ndarray, dtype=np.float64):
    """zs: (T, N, m); x0: (N, n); P0: (N, n, n) -> (states (T, N, n),
    final x (N, n), final P (N, n, n))."""
    T, N, _ = zs.shape
    out = np.zeros((T, N, model.n), dtype)
    xs = np.array(x0, dtype)
    Ps = np.array(P0, dtype)
    for t in range(T):
        for k in range(N):
            xs[k], Ps[k] = step(model, xs[k], Ps[k], zs[t, k], dtype)
        out[t] = xs
    return out, xs, Ps


# ---------------------------------------------------------------------------
# IMM (interacting multiple model), one track at a time.
# ---------------------------------------------------------------------------

def imm_step(imm, xs: np.ndarray, Ps: np.ndarray, mu: np.ndarray,
             z: np.ndarray, has_z: bool = True, dtype=np.float64):
    """One IMM cycle for one track.

    xs: (K, n) model-conditioned means; Ps: (K, n, n); mu: (K,) mode
    probabilities; z: (m,). Returns (xs', Ps', mu', x_combined):
    mixing, per-model predict+update, the mode posterior from the
    Gaussian measurement likelihoods, the moment-matched combination.
    With ``has_z=False`` the track coasts: the model-conditioned states
    stay at the prediction and the mode posterior is the
    Markov-predicted cbar (the tracker's no-measurement semantics).
    """
    K = len(imm.models)
    n, m = imm.n, imm.m
    Pi = np.asarray(imm.trans, dtype)
    mu = np.asarray(mu, dtype)
    xs = np.asarray(xs, dtype)
    Ps = np.asarray(Ps, dtype)
    # -- interaction / mixing --
    cbar = Pi.T @ mu                              # (K,) predicted mode probs
    w = Pi * mu[:, None] / cbar[None, :]          # w[i, j] = P(i | j)
    x_mix = np.einsum("ij,id->jd", w, xs)
    P_mix = np.zeros((K, n, n), dtype)
    for j in range(K):
        for i in range(K):
            dx = xs[i] - x_mix[j]
            P_mix[j] += w[i, j] * (Ps[i] + np.outer(dx, dx))
    # -- model-conditioned filtering + likelihoods --
    xs_new = np.zeros((K, n), dtype)
    Ps_new = np.zeros((K, n, n), dtype)
    loglik = np.zeros(K, dtype)
    for k, model in enumerate(imm.models):
        x_pred, P_pred = predict(model, x_mix[k], P_mix[k], dtype)
        if not has_z:
            xs_new[k], Ps_new[k] = x_pred, P_pred
            continue
        H = np.asarray(model.H, dtype)
        R = np.asarray(model.R, dtype)
        y = np.asarray(z, dtype) - H @ x_pred
        S = H @ P_pred @ H.T + R
        loglik[k] = dtype(-0.5) * (y @ np.linalg.solve(S, y)
                                   + np.log(np.linalg.det(S))
                                   + dtype(m * np.log(2.0 * np.pi)))
        xs_new[k], Ps_new[k] = update(model, x_pred, P_pred, z, dtype)
    # -- mode posterior (shift-stable; coasting keeps the prediction) --
    if has_z:
        wk = cbar * np.exp(loglik - loglik.max())
        mu_new = wk / wk.sum()
    else:
        mu_new = cbar
    x_c = mu_new @ xs_new
    return xs_new, Ps_new, mu_new, x_c


def run_imm(imm, zs: np.ndarray, x0=None, P0=None, mu0=None, valid=None,
            dtype=np.float64):
    """IMM-filter a (T, m) measurement sequence.

    ``valid``, if given, is a (T,) boolean mask: False frames coast
    (predict only, mu <- cbar). Returns (combined states (T, n), mode
    probabilities (T, K))."""
    K = len(imm.models)
    x = np.tile(np.asarray(imm.x0 if x0 is None else x0, dtype), (K, 1))
    P = np.tile(np.asarray(imm.P0 if P0 is None else P0, dtype), (K, 1, 1))
    mu = np.asarray(imm.mu0 if mu0 is None else mu0, dtype)
    out = np.zeros((len(zs), imm.n), dtype)
    mus = np.zeros((len(zs), K), dtype)
    for t, z in enumerate(zs):
        has_z = True if valid is None else bool(valid[t])
        x, P, mu, x_c = imm_step(imm, x, P, mu, z, has_z=has_z, dtype=dtype)
        out[t] = x_c
        mus[t] = mu
    return out, mus


def run_imm_batched(imm, zs: np.ndarray, x0: np.ndarray, P0: np.ndarray,
                    valid=None, dtype=np.float64):
    """zs: (T, N, m); x0: (N, n); P0: (N, n, n) -> combined (T, N, n)
    and mode probabilities (T, N, K), each track an independent IMM.
    ``valid``: optional (T, N) boolean coasting mask (see run_imm)."""
    T, N, _ = zs.shape
    K = len(imm.models)
    out = np.zeros((T, N, imm.n), dtype)
    mus = np.zeros((T, N, K), dtype)
    for k in range(N):
        out[:, k], mus[:, k] = run_imm(
            imm, zs[:, k], x0=x0[k], P0=P0[k],
            valid=None if valid is None else valid[:, k], dtype=dtype)
    return out, mus
