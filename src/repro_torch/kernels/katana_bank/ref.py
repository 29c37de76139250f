"""Plain PyTorch versions of the katana_bank kernels: the live frames,
the greedy assignment, the per-frame bank steps and the replay scans.

Each function here computes exactly what its CUDA kernel in ``csrc/``
computes, written as the same entry-wise op stream as the reference
Pallas emit (``repro/kernels/katana_bank/kernel.py``): every state entry
is one (C,) lane tensor, float constants multiply lane tensors, zero
constants are pruned, sums fold left in index order, and the greedy
assignment is a Python ``while`` loop of waves over the gated pairs.
The kernels issue this op stream themselves, from the model set's
compile-time pattern of shared zeros and ones (csrc/pruned.cuh), so they
give its float32 bits when neither side contracts a multiply-add into
an FMA (the kernels build with ``--fmad=false``; PyTorch runs each
elementwise op as its own kernel).

The ops wrappers (``ops.py``) take these only for tensors on the CPU;
``chip_smoke.py`` and the GPU tests call them directly on the card to
hold each kernel against its plain version.

Layouts are the port's canonical ones: x (C, n), P (C, n, n),
z (M, m); IMM x (K, C, n), P (K, C, n, n), mu (C, K); a replay stream
zs (T, N, m) with xs (T, N, n) out.

``symmetrize`` (every function that predicts) picks the reference's two
covariance contracts: True emits the upper triangle of P' = F P Fᵀ + Q,
of the IMM mixing's P_mix, of the updated P and of the coasting select,
mirrors aliased; False emits the full square in the reference kernel's
order (``_emit_FPFt``, then ``_emit_add_Q``; the update's and the mixing's
``for j in range(n)``), so an asymmetry of the float products is carried,
not averaged away.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)
LOG_2PI = float(np.log(2.0 * np.pi))


def selector_rows(H: np.ndarray) -> Optional[List[int]]:
    """If every row of H is a unit vector, return the observed indices."""
    rows = []
    for r in np.asarray(H):
        nz = np.nonzero(r)[0]
        if len(nz) != 1 or abs(r[nz[0]] - 1.0) > 1e-12:
            return None
        rows.append(int(nz[0]))
    return rows


def check_selector(model) -> List[int]:
    obs = selector_rows(np.asarray(model.H))
    if obs is None:
        raise NotImplementedError(
            "the frame kernels require a selector measurement matrix "
            "(every row of H a unit vector); use fused_frame=False")
    return obs


def plan_imm_tables(models):
    """Fold the per-model F/Q/R tables: entries every model agrees on
    stay Python floats (pruned when zero), entries that differ get a
    row of V (E, K). Returns (entries, V) where entries[name][i][j] is
    a float or ("var", e)."""
    entries = {}
    vals = []
    for name in ("F", "Q", "R"):
        Ms = [np.asarray(getattr(mdl, name), np.float64) for mdl in models]
        a, b = Ms[0].shape
        tabl = [[None] * b for _ in range(a)]
        for i in range(a):
            for j in range(b):
                vs = [float(M[i, j]) for M in Ms]
                if all(v == vs[0] for v in vs):
                    tabl[i][j] = vs[0]
                else:
                    tabl[i][j] = ("var", len(vals))
                    vals.append(np.array(vs))
        entries[name] = tabl
    V = np.zeros((max(1, len(vals)), len(models)))
    for e, v in enumerate(vals):
        V[e] = v
    return entries, V


# ---------------------------------------------------------------------------
# The emitted op stream on (lane,) tensors / Python floats.
# ---------------------------------------------------------------------------

def _is_zero(v) -> bool:
    return isinstance(v, float) and v == 0.0


def _bc(v, lane):
    """Broadcast a folded Python float (or a narrower tensor) to a full
    lane tensor."""
    if isinstance(v, (int, float)):
        return torch.full_like(lane, v)
    return v if v.shape == lane.shape else v.expand(lane.shape)


def _dot(row, vec, n):
    """sum_k row[k] * vec[k], zero terms pruned, 1.0 elided, left fold."""
    acc = None
    for k in range(n):
        f = row[k]
        if _is_zero(f) or _is_zero(vec[k]):
            continue
        if isinstance(f, float):
            term = vec[k] if f == 1.0 else f * vec[k]
        else:
            term = f * vec[k]
        acc = term if acc is None else acc + term
    return 0.0 if acc is None else acc


def _matvec(F, xv, n):
    return [_dot(F[i], xv, n) for i in range(n)]


def _predict_cov(F, P, Q, n, symmetrize=True):
    """F P Fᵀ + Q: its upper triangle, mirrors aliased, or with
    ``symmetrize=False`` every entry."""
    FP = [[_dot(F[i], [P[k][j] for k in range(n)], n) for j in range(n)]
          for i in range(n)]
    Pp = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in (range(i, n) if symmetrize else range(n)):
            v = _dot(F[j], FP[i], n)
            if not _is_zero(Q[i][j]):
                v = v + Q[i][j]
            Pp[i][j] = v
            if symmetrize:
                Pp[j][i] = v
    return Pp


def small_inv_lanes(S, m):
    """Cofactor inverse of an m x m matrix of lane tensors (m <= 4)."""
    if m == 1:
        return [[1.0 / S[0][0]]]
    if m == 2:
        det = S[0][0] * S[1][1] - S[0][1] * S[1][0]
        r = 1.0 / det
        return [[S[1][1] * r, -S[0][1] * r], [-S[1][0] * r, S[0][0] * r]]
    if m == 3:
        c00 = S[1][1] * S[2][2] - S[1][2] * S[2][1]
        c01 = S[1][2] * S[2][0] - S[1][0] * S[2][2]
        c02 = S[1][0] * S[2][1] - S[1][1] * S[2][0]
        c10 = S[0][2] * S[2][1] - S[0][1] * S[2][2]
        c11 = S[0][0] * S[2][2] - S[0][2] * S[2][0]
        c12 = S[0][1] * S[2][0] - S[0][0] * S[2][1]
        c20 = S[0][1] * S[1][2] - S[0][2] * S[1][1]
        c21 = S[0][2] * S[1][0] - S[0][0] * S[1][2]
        c22 = S[0][0] * S[1][1] - S[0][1] * S[1][0]
        r = 1.0 / (S[0][0] * c00 + S[0][1] * c01 + S[0][2] * c02)
        return [[c00 * r, c10 * r, c20 * r],
                [c01 * r, c11 * r, c21 * r],
                [c02 * r, c12 * r, c22 * r]]
    if m == 4:
        A = [[S[i][j] for j in range(2)] for i in range(2)]
        B = [[S[i][j + 2] for j in range(2)] for i in range(2)]
        C = [[S[i + 2][j] for j in range(2)] for i in range(2)]
        D = [[S[i + 2][j + 2] for j in range(2)] for i in range(2)]

        def mul2(X, Y):
            return [[X[i][0] * Y[0][j] + X[i][1] * Y[1][j]
                     for j in range(2)] for i in range(2)]

        def sub2(X, Y):
            return [[X[i][j] - Y[i][j] for j in range(2)] for i in range(2)]

        Di = small_inv_lanes(D, 2)
        BDi = mul2(B, Di)
        Si = small_inv_lanes(sub2(A, mul2(BDi, C)), 2)
        DiC = mul2(Di, C)
        TR = [[-(Si[i][0] * BDi[0][j] + Si[i][1] * BDi[1][j])
               for j in range(2)] for i in range(2)]
        BL = [[-(DiC[i][0] * Si[0][j] + DiC[i][1] * Si[1][j])
               for j in range(2)] for i in range(2)]
        BDiT = mul2(DiC, [[-TR[0][0], -TR[0][1]], [-TR[1][0], -TR[1][1]]])
        BR = [[Di[i][j] + BDiT[i][j] for j in range(2)] for i in range(2)]
        out = [[None] * 4 for _ in range(4)]
        for i in range(2):
            for j in range(2):
                out[i][j] = Si[i][j]
                out[i][j + 2] = TR[i][j]
                out[i + 2][j] = BL[i][j]
                out[i + 2][j + 2] = BR[i][j]
        return out
    raise NotImplementedError(m)


def small_det_lanes(S, m):
    """Closed-form determinant of an m x m matrix of lane tensors."""
    if m == 1:
        return S[0][0]
    if m == 2:
        return S[0][0] * S[1][1] - S[0][1] * S[1][0]
    if m == 3:
        return (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
                + S[0][1] * (S[1][2] * S[2][0] - S[1][0] * S[2][2])
                + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    if m == 4:
        A = [[S[i][j] for j in range(2)] for i in range(2)]
        B = [[S[i][j + 2] for j in range(2)] for i in range(2)]
        C = [[S[i + 2][j] for j in range(2)] for i in range(2)]
        D = [[S[i + 2][j + 2] for j in range(2)] for i in range(2)]
        Di = small_inv_lanes(D, 2)
        BDi = [[B[i][0] * Di[0][j] + B[i][1] * Di[1][j]
                for j in range(2)] for i in range(2)]
        Sc = [[A[i][j] - (BDi[i][0] * C[0][j] + BDi[i][1] * C[1][j])
               for j in range(2)] for i in range(2)]
        return small_det_lanes(D, 2) * small_det_lanes(Sc, 2)
    raise NotImplementedError(m)


def _innovation(Pp, R, obs, n, m):
    """S = P̂[obs][obs] + R, its cofactor inverse, and P̂·Hᵀ."""
    S = [[Pp[obs[r]][obs[c]] + R[r][c] if not _is_zero(R[r][c])
          else Pp[obs[r]][obs[c]] for c in range(m)] for r in range(m)]
    PHt = [[Pp[i][obs[r]] for r in range(m)] for i in range(n)]
    return S, small_inv_lanes(S, m), PHt


def _update(xp, Pp, z, obs, n, m, inno, with_loglik, symmetrize=True):
    """Kalman update from the precomputed innovation quantities; the
    posterior covariance upper triangle is emitted, mirrors aliased (with
    ``symmetrize=False`` every entry)."""
    y = [z[r] - xp[obs[r]] for r in range(m)]
    S, Sinv, PHt = inno
    K = [[None] * m for _ in range(n)]
    for i in range(n):
        for r in range(m):
            acc = None
            for c in range(m):
                t = PHt[i][c] * Sinv[c][r]
                acc = t if acc is None else acc + t
            K[i][r] = acc
    xn = []
    for i in range(n):
        acc = xp[i]
        for r in range(m):
            acc = acc + K[i][r] * y[r]
        xn.append(acc)
    Pn = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in (range(i, n) if symmetrize else range(n)):
            acc = Pp[i][j]
            for r in range(m):
                acc = acc - K[i][r] * Pp[obs[r]][j]
            Pn[i][j] = acc
            if symmetrize:
                Pn[j][i] = acc
    if not with_loglik:
        return xn, Pn
    d = None
    for r in range(m):
        Sy = None
        for c in range(m):
            t = Sinv[r][c] * y[c]
            Sy = t if Sy is None else Sy + t
        t = y[r] * Sy
        d = t if d is None else d + t
    loglik = -0.5 * (d + torch.log(small_det_lanes(S, m)) + m * LOG_2PI)
    return xn, Pn, loglik


def _predict_single(model, xv, P, symmetrize=True):
    """Time update of one model: constant F for a linear model, the
    hard-coded CTRA-8 dynamics for a nonlinear one (the reference frame
    kernel ignores ``model.f`` the same way)."""
    n = model.n
    Q = [[float(v) for v in row] for row in np.asarray(model.Q, np.float64)]
    if model.is_linear:
        F = [[float(v) for v in row] for row in np.asarray(model.F,
                                                           np.float64)]
        xp = _matvec(F, xv, n)
    else:
        if n != 8:
            raise NotImplementedError(
                "the nonlinear frame path is the CTRA-8 model (n=8)")
        dt = float(model.dt)
        px, py, pz, v, th, om, a, vz = xv
        c, s = torch.cos(th), torch.sin(th)
        xp = [px + v * c * dt, py + v * s * dt, pz + vz * dt,
              v + a * dt, th + om * dt, om, a, vz]
        F = [[1.0 if i == j else 0.0 for j in range(n)] for i in range(n)]
        F[0][3] = c * dt
        F[0][4] = -v * s * dt
        F[1][3] = s * dt
        F[1][4] = v * c * dt
        F[2][7] = dt
        F[3][6] = dt
        F[4][5] = dt
    return xp, _predict_cov(F, P, Q, n, symmetrize)


def cost_tile(z_pred, Sinv, z, m):
    """(M, C) squared-Mahalanobis tile d[j, c] = yᵀ S_c^{-1} y with
    y = z_j − ẑ_c, contracted S^{-1}·y first, then y·."""
    y = [z[:, r][:, None] - z_pred[r][None, :] for r in range(m)]
    d = None
    for r in range(m):
        Sy = None
        for c in range(m):
            t = Sinv[r][c][None, :] * y[c]
            Sy = t if Sy is None else Sy + t
        t = y[r] * Sy
        d = t if d is None else d + t
    return d


def first_argmin(x, dim):
    """(min, first index of the min) along ``dim`` — ties go to the
    lowest index, independent of the backend's argmin."""
    mn = x.min(dim=dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], device=x.device, dtype=torch.int32)
    shape = [1] * x.ndim
    shape[dim] = -1
    big = torch.iinfo(torch.int32).max
    arg = torch.where(x == mn, idx.view(shape), big).min(dim=dim).values
    return mn.squeeze(dim), arg


def greedy_waves(masked, rounds: int):
    """Wave-scheduled greedy assignment on an (M, C) tile whose invalid
    or out-of-gate pairs already hold F32_MAX. Every wave commits each
    pair that is the first argmin of both its track column and its
    measurement row; the loop ends when a wave commits nothing or after
    ``rounds`` waves. Returns (assoc (C,) int32, waves run). The tile
    schedule of the reference (``_emit_greedy_assign``); the kernels run
    ``greedy_candidates``, which gives the same result and wave count."""
    M, C = masked.shape
    dev = masked.device
    iM = torch.arange(M, device=dev, dtype=torch.int32)[:, None]
    iC = torch.arange(C, device=dev, dtype=torch.int32)[None, :]
    assoc = torch.full((C,), -1, dtype=torch.int32, device=dev)
    big = torch.tensor(F32_MAX, dtype=masked.dtype, device=dev)
    waves = 0
    while waves < rounds:
        tmin, targ = first_argmin(masked, 0)                 # (C,)
        _, marg = first_argmin(masked, 1)                    # (M,)
        hit = (iM == targ[None, :]) & (iC == marg[:, None])
        commit = hit.any(dim=0) & (tmin < big)
        assoc = torch.where(commit, targ, assoc)
        meas_taken = (hit & commit[None, :]).any(dim=1)
        masked = torch.where(commit[None, :] | meas_taken[:, None], big,
                             masked)
        waves += 1
        if not bool(commit.any()):
            break
    return assoc, waves


def ordered_bits(v):
    """The kernels' order-preserving key of float32 values as int64 in
    [0, 2^32): -0 counts as +0, negative values below positive ones."""
    v = torch.where(v == 0, torch.zeros_like(v), v).contiguous()
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)


def greedy_candidates(masked, rounds: int):
    """``greedy_waves`` on the schedule of the kernels (csrc/greedy.cuh):
    only the pairs below F32_MAX (the gated ones) are listed, once; a
    wave takes, over the live pairs, each track's minimum key (float
    bits, j) -- its first-occurrence argmin -- and each measurement's
    (float bits, c), and commits the pairs that are both. Returns
    (assoc (C,) int32, waves run), equal to ``greedy_waves``'."""
    M, C = masked.shape
    dev = masked.device
    j, c = torch.nonzero(masked < F32_MAX, as_tuple=True)
    # the kernel's unsigned 64-bit keys, shifted into int64's order
    high = (ordered_bits(masked[j, c]) - 2 ** 31) * 2 ** 32
    row_key, col_key = high + j, high + c
    none = torch.iinfo(torch.int64).max
    assoc = torch.full((C,), -1, dtype=torch.int32, device=dev)
    row_dead = torch.zeros((M,), dtype=torch.bool, device=dev)
    col_dead = torch.zeros((C,), dtype=torch.bool, device=dev)
    tracks = torch.arange(C, device=dev)
    waves = 0
    while waves < rounds:
        live = ~row_dead[j] & ~col_dead[c]
        rk = torch.full((C,), none, device=dev).scatter_reduce(
            0, c[live], row_key[live], "amin")
        # + one entry that no track wins, for the tracks without a pair
        ck = torch.full((M + 1,), none, device=dev).scatter_reduce(
            0, j[live], col_key[live], "amin")
        has = rk != none
        tj = torch.where(has, rk & 0xFFFFFFFF, M)
        commit = has & ((ck[tj] & 0xFFFFFFFF) == tracks)
        assoc = torch.where(commit, tj.to(torch.int32), assoc)
        col_dead |= commit
        row_dead[tj[commit]] = True
        waves += 1
        if not bool(commit.any()):
            break
    return assoc, waves


def gate_mask(cost, valid, gate: float):
    """The greedy's entry mask: cost where the pair is valid and
    ``cost <= gate`` (gate rounded to float32, NaN fails), else F32_MAX."""
    g = torch.tensor(np.float32(gate), dtype=cost.dtype, device=cost.device)
    return torch.where(valid & (cost <= g), cost,
                       torch.tensor(F32_MAX, dtype=cost.dtype,
                                    device=cost.device))


def greedy_assign_plain(cost, valid, gate: float, rounds: int,
                        return_waves: bool = False):
    """Plain version of the standalone greedy kernel. cost (C, M),
    valid (C, M) bool, canonical layout. Returns assoc (C,) int32."""
    assoc, waves = greedy_candidates(gate_mask(cost.T, valid.T, gate),
                                     rounds)
    return (assoc, waves) if return_waves else assoc


def _frame_lanes(model, xv, P, z, z_valid, active, gate, rounds,
                 symmetrize=True):
    """The single-model frame on lane lists: predict, innovation, cost
    tile, greedy, update, coasting select. Returns (xs, Ps, assoc,
    waves)."""
    n, m = model.n, model.m
    obs = check_selector(model)
    R = [[float(v) for v in row] for row in np.asarray(model.R, np.float64)]
    xp, Pp = _predict_single(model, xv, P, symmetrize)
    inno = _innovation(Pp, R, obs, n, m)
    cost = cost_tile([xp[obs[r]] for r in range(m)], inno[1], z, m)
    masked = gate_mask(cost, active[None, :] & z_valid[:, None], gate)
    assoc, waves = greedy_candidates(masked, rounds)
    zk = [torch.where(assoc >= 0, z[assoc.clamp(0, z.shape[0] - 1).long(),
                                    r], 0.0) for r in range(m)]
    xn, Pn = _update(xp, Pp, zk, obs, n, m, inno, False, symmetrize)
    upd = (assoc >= 0) & active
    lane = xv[0]
    xs = [torch.where(upd, _bc(xn[i], lane), _bc(xp[i], lane))
          for i in range(n)]
    Ps = [[torch.where(upd, _bc(Pn[i][j], lane), _bc(Pp[i][j], lane))
           for j in range(n)] for i in range(n)]
    return xs, Ps, assoc, waves


def _to_lanes(x, P):
    n = x.shape[-1]
    return ([x[..., i] for i in range(n)],
            [[P[..., i, j] for j in range(n)] for i in range(n)])


def _from_lanes(xs, Ps):
    n = len(xs)
    x = torch.stack(xs, dim=-1)
    P = torch.stack([torch.stack(Ps[i], dim=-1) for i in range(n)], dim=-2)
    return x, P


def katana_frame_plain(model, x, P, z, z_valid, active, gate: float,
                       rounds: int, return_waves: bool = False,
                       symmetrize: bool = True):
    """Plain version of the single-model frame kernel. x (C, n),
    P (C, n, n), z (M, m), z_valid (M,) bool, active (C,) bool. Returns
    (x', P', assoc (C,) int32). A fleet of S sensors (every input with a
    leading S) runs as a loop of single-sensor frames, outputs stacked,
    waves a list."""
    if x.dim() == 3:
        outs = [katana_frame_plain(model, x[s], P[s], z[s], z_valid[s],
                                   active[s], gate, rounds, True, symmetrize)
                for s in range(x.shape[0])]
        out = tuple(torch.stack([o[i] for o in outs]) for i in range(3))
        return out + ([o[3] for o in outs],) if return_waves else out
    xv, Pl = _to_lanes(x, P)
    xs, Ps, assoc, waves = _frame_lanes(model, xv, Pl, z, z_valid, active,
                                        gate, rounds, symmetrize)
    x2, P2 = _from_lanes(xs, Ps)
    out = (x2, P2, assoc)
    return out + (waves,) if return_waves else out


def _imm_mix(xv, P, mu, Pi, n, K, tt, sym=True):
    """IMM mixing on model-major (K·tt,) lanes (centred-moment spread
    with model 0 as the reference, tiny-clamped c̄ denominator): P_mix's
    upper triangle, mirrors aliased, or with ``sym=False`` every entry.
    Returns (x_mix, P_mix, cbar_parts)."""
    mu_i = [mu[i * tt:(i + 1) * tt] for i in range(K)]
    x_i = [[xv[d][i * tt:(i + 1) * tt] for i in range(K)] for d in range(n)]
    cbar_parts, w = [], []
    for j in range(K):
        cj = _dot([Pi[i][j] for i in range(K)], mu_i, K)
        cbar_parts.append(cj)
        rden = 1.0 / torch.clamp_min(cj, F32_TINY)
        w.append([0.0 if Pi[i][j] == 0.0 else
                  (mu_i[i] if Pi[i][j] == 1.0 else Pi[i][j] * mu_i[i]) * rden
                  for i in range(K)])
    xt = [[0.0 if i == 0 else x_i[d][i] - x_i[d][0] for i in range(K)]
          for d in range(n)]
    mt = [[_dot(w[j], xt[d], K) for j in range(K)] for d in range(n)]
    x_mix = [torch.cat([_bc(mt[d][j] + x_i[d][0], mu_i[0])
                        for j in range(K)]) for d in range(n)]
    P_mix = [[None] * n for _ in range(n)]
    for r in range(n):
        for c in (range(r, n) if sym else range(n)):
            A_i = [P[r][c][i * tt:(i + 1) * tt] if _is_zero(xt[r][i])
                   or _is_zero(xt[c][i])
                   else P[r][c][i * tt:(i + 1) * tt] + xt[r][i] * xt[c][i]
                   for i in range(K)]
            parts = [_bc(_dot(w[j], A_i, K) - mt[r][j] * mt[c][j], mu_i[0])
                     for j in range(K)]
            P_mix[r][c] = torch.cat(parts)
            if sym:
                P_mix[c][r] = P_mix[r][c]
    return x_mix, P_mix, cbar_parts


def _mode_posterior(cbar_parts, ll, K, tt):
    ll_k = [ll[k * tt:(k + 1) * tt] for k in range(K)]
    mx = ll_k[0]
    for k in range(1, K):
        mx = torch.maximum(mx, ll_k[k])
    ws = [cbar_parts[k] * torch.exp(ll_k[k] - mx) for k in range(K)]
    s = ws[0]
    for k in range(1, K):
        s = s + ws[k]
    r = 1.0 / s
    return [wk * r for wk in ws]


def _imm_tables(imm, tt, like):
    """The K members' F, Q, R on model-major (K·tt,) lanes: entries all
    members share stay Python floats (pruned when zero), entries that
    differ become a lane tensor holding each model's value on its slab."""
    entries, V = plan_imm_tables(imm.models)
    tabv = [torch.cat([torch.full((tt,), float(v), dtype=like.dtype,
                                  device=like.device) for v in row])
            for row in V]
    return ([[cell if isinstance(cell, float) else tabv[cell[1]]
              for cell in row] for row in entries[nm]]
            for nm in ("F", "Q", "R"))


def _markov(imm):
    return [[float(v) for v in row] for row in np.asarray(imm.trans,
                                                          np.float64)]


def _check_imm_linear(imm, what):
    obs = check_selector(imm.models[0])
    for mdl in imm.models:
        if not mdl.is_linear:
            raise NotImplementedError(
                f"multi-model {what} requires linear member models")
        if check_selector(mdl) != obs:
            raise NotImplementedError(
                f"multi-model {what} requires one shared selector H")
    return obs


def katana_imm_frame_plain(imm, x, P, mu, z, z_valid, active, gate: float,
                           rounds: int, return_waves: bool = False,
                           symmetrize: bool = True):
    """Plain version of the IMM frame kernel. x (K, C, n),
    P (K, C, n, n), mu (C, K). Returns (x', P', mu', x_c (C, n), assoc).
    K=1 runs exactly the single-model frame with mu passed through. A
    fleet of S sensors (x (K, S, C, n), P (K, S, C, n, n), mu (S, C, K),
    the rest with a leading S) runs as a loop of single-sensor frames,
    outputs stacked, waves a list."""
    if x.dim() == 4:
        outs = [katana_imm_frame_plain(imm, x[:, s], P[:, s], mu[s], z[s],
                                       z_valid[s], active[s], gate, rounds,
                                       True, symmetrize)
                for s in range(x.shape[1])]
        out = tuple(torch.stack([o[i] for o in outs], dim=1 if i < 2 else 0)
                    for i in range(5))
        return out + ([o[5] for o in outs],) if return_waves else out
    K, C, n = x.shape
    m = imm.m
    if K == 1:
        x2, P2, assoc, waves = katana_frame_plain(
            imm.models[0], x[0], P[0], z, z_valid, active, gate, rounds,
            return_waves=True, symmetrize=symmetrize)
        out = (x2[None], P2[None], mu.clone(), x2.clone(), assoc)
        return out + (waves,) if return_waves else out
    obs = _check_imm_linear(imm, "katana_imm_frame")
    Ftab, Qtab, Rtab = _imm_tables(imm, C, x)
    Pi = _markov(imm)
    L = K * C
    xv = [x[:, :, i].reshape(L) for i in range(n)]
    Pl = [[P[:, :, i, j].reshape(L) for j in range(n)] for i in range(n)]
    mu_f = mu.T.reshape(L)
    x_mix, P_mix, cbar_parts = _imm_mix(xv, Pl, mu_f, Pi, n, K, C,
                                        symmetrize)
    xp = _matvec(Ftab, x_mix, n)
    Pp = _predict_cov(Ftab, P_mix, Qtab, n, symmetrize)
    inno = _innovation(Pp, Rtab, obs, n, m)
    d = cost_tile([xp[obs[r]] for r in range(m)], inno[1], z, m)  # (M, L)
    cost = None
    for k in range(K):
        t = cbar_parts[k][None, :] * d[:, k * C:(k + 1) * C]
        cost = t if cost is None else cost + t
    masked = gate_mask(cost, active[None, :] & z_valid[:, None], gate)
    assoc, waves = greedy_candidates(masked, rounds)
    zk1 = [torch.where(assoc >= 0, z[assoc.clamp(0, z.shape[0] - 1).long(),
                                     r], 0.0) for r in range(m)]
    zk = [torch.cat([q] * K) for q in zk1]
    xn, Pn, ll = _update(xp, Pp, zk, obs, n, m, inno, True, symmetrize)
    mu_parts = _mode_posterior(cbar_parts, ll, K, C)
    upd = (assoc >= 0) & active
    uL = torch.cat([upd] * K)
    proto = mu_f
    xs = [torch.where(uL, _bc(xn[i], proto), _bc(xp[i], proto))
          for i in range(n)]
    Ps = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in (range(i, n) if symmetrize else range(n)):
            Ps[i][j] = torch.where(uL, _bc(Pn[i][j], proto),
                                   _bc(Pp[i][j], proto))
            if symmetrize:
                Ps[j][i] = Ps[i][j]
    lane1 = mu_f[:C]
    mu_sel = [torch.where(upd, _bc(mu_parts[k], lane1),
                          _bc(cbar_parts[k], lane1)) for k in range(K)]
    xc = [_dot(mu_sel, [u[k * C:(k + 1) * C] for k in range(K)], K)
          for u in xs]
    x2 = torch.stack(xs, dim=-1).reshape(K, C, n)
    P2 = torch.stack([torch.stack(Ps[i], dim=-1) for i in range(n)],
                     dim=-2).reshape(K, C, n, n)
    mu2 = torch.stack(mu_sel, dim=-1)
    xc2 = torch.stack([_bc(v, lane1) for v in xc], dim=-1)
    out = (x2, P2, mu2, xc2, assoc)
    return out + (waves,) if return_waves else out


# ---------------------------------------------------------------------------
# Per-frame bank steps and replay scans (no association: lane t of a
# stream is measured by z[t, lane]).
# ---------------------------------------------------------------------------

def _step_lanes(model, xv, P, z, with_loglik=False, symmetrize=True):
    """One predict+update of one model on lane lists. Returns (x̂, P̂,
    update) with update = (x', P'[, loglik])."""
    n, m = model.n, model.m
    obs = check_selector(model)
    R = [[float(v) for v in row] for row in np.asarray(model.R, np.float64)]
    xp, Pp = _predict_single(model, xv, P, symmetrize)
    inno = _innovation(Pp, R, obs, n, m)
    return xp, Pp, _update(xp, Pp, z, obs, n, m, inno, with_loglik,
                           symmetrize)


def _coast_select(v, xn, Pn, xp, Pp, symmetrize=True):
    """The replay scans' validity select, as the reference's mul/add
    (no branch): v·updated + (1 − v)·predicted, v a 0/1 lane tensor;
    the covariance's upper triangle, mirrors aliased (with
    ``symmetrize=False`` every entry)."""
    nv = 1.0 - v
    n = len(xn)
    xs = [v * a + nv * b for a, b in zip(xn, xp)]
    Ps = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in (range(i, n) if symmetrize else range(n)):
            Ps[i][j] = v * Pn[i][j] + nv * Pp[i][j]
            if symmetrize:
                Ps[j][i] = Ps[i][j]
    return xs, Ps


def _full(xs, Ps, lane):
    return ([_bc(u, lane) for u in xs],
            [[_bc(u, lane) for u in row] for row in Ps])


def katana_bank_step_plain(model, x, P, z, symmetrize=True):
    """Plain version of the per-frame bank kernel: one predict+update
    per lane. x (N, n), P (N, n, n), z (N, m). Returns (x', P')."""
    xv, Pl = _to_lanes(x, P)
    _, _, (xn, Pn) = _step_lanes(model, xv, Pl,
                                 [z[:, r] for r in range(model.m)],
                                 symmetrize=symmetrize)
    return _from_lanes(*_full(xn, Pn, x[:, 0]))


def katana_bank_imm_step_plain(imm, x, P, z, symmetrize=True):
    """Plain version of the per-frame IMM bank kernel: each of the K·N
    (model, track) lanes, model-major, takes one predict+update of its
    model with the track's measurement, plus the measurement
    log-likelihood. x (K, N, n), P (K, N, n, n), z (N, m). Returns
    (x' (K, N, n), P' (K, N, n, n), loglik (K, N)). K=1 is the
    single-model step (nonlinear members included) with its loglik."""
    K, N, n = x.shape
    m = imm.m
    L = K * N
    xv = [x[:, :, i].reshape(L) for i in range(n)]
    Pl = [[P[:, :, i, j].reshape(L) for j in range(n)] for i in range(n)]
    z = [torch.cat([z[:, r]] * K) for r in range(m)]
    if K == 1:
        _, _, (xn, Pn, ll) = _step_lanes(imm.models[0], xv, Pl, z, True,
                                         symmetrize)
    else:
        obs = _check_imm_linear(imm, "katana_bank_imm")
        Ftab, Qtab, Rtab = _imm_tables(imm, N, x)
        xp = _matvec(Ftab, xv, n)
        Pp = _predict_cov(Ftab, Pl, Qtab, n, symmetrize)
        inno = _innovation(Pp, Rtab, obs, n, m)
        xn, Pn, ll = _update(xp, Pp, z, obs, n, m, inno, True, symmetrize)
    x2, P2 = _from_lanes(*_full(xn, Pn, xv[0]))
    return (x2.reshape(K, N, n), P2.reshape(K, N, n, n),
            _bc(ll, xv[0]).reshape(K, N))


def katana_bank_scan_plain(model, x, P, zs, valid=None, symmetrize=True):
    """Plain version of the single-model replay scan: T predict+updates
    per lane with the state carried. x (N, n), P (N, n, n),
    zs (T, N, m); ``valid`` (T, N) bool, optional: a False frame keeps
    the lane's prediction (the K=1 IMM replay). Returns (xs (T, N, n),
    x_T (N, n), P_T (N, n, n))."""
    T, N, m = zs.shape
    n = model.n
    xv, Pl = _to_lanes(x, P)
    lane = x[:, 0]
    out = []
    for t in range(T):
        xp, Pp, (xn, Pn) = _step_lanes(model, xv, Pl,
                                       [zs[t, :, r] for r in range(m)],
                                       symmetrize=symmetrize)
        if valid is not None:
            xn, Pn = _coast_select(valid[t].to(x.dtype), xn, Pn, xp, Pp,
                                   symmetrize)
        xv, Pl = _full(xn, Pn, lane)
        out.append(torch.stack(xv, dim=-1))
    xs = torch.stack(out) if out else x.new_empty((0, N, n))
    return (xs,) + _from_lanes(xv, Pl)


def katana_bank_imm_scan_plain(imm, x, P, mu, zs, valid=None,
                               symmetrize=True):
    """Plain version of the IMM replay scan: per frame the mixing, the
    K predict+updates with their log-likelihoods, the mode posterior
    and the combined estimate, on model-major (K·N,) lanes. x (K, N, n),
    P (K, N, n, n), mu (N, K), zs (T, N, m), ``valid`` (T, N) bool or
    None: a False frame coasts (x̂/P̂ kept, mu <- cbar). Returns
    (xs (T, N, n) combined estimates, x_T, P_T, mu_T (N, K)). K=1 is
    the single-model scan with mu passed through."""
    K, N, n = x.shape
    T, _, m = zs.shape
    if K == 1:
        xs, xf, Pf = katana_bank_scan_plain(imm.models[0], x[0], P[0], zs,
                                            valid, symmetrize)
        return xs, xf[None], Pf[None], mu.clone()
    obs = _check_imm_linear(imm, "katana_imm_sequence")
    Ftab, Qtab, Rtab = _imm_tables(imm, N, x)
    Pi = _markov(imm)
    L = K * N
    xv = [x[:, :, i].reshape(L) for i in range(n)]
    Pl = [[P[:, :, i, j].reshape(L) for j in range(n)] for i in range(n)]
    mu_f = mu.T.reshape(L)
    out = []
    for t in range(T):
        z = [torch.cat([zs[t, :, r]] * K) for r in range(m)]
        x_mix, P_mix, cbar = _imm_mix(xv, Pl, mu_f, Pi, n, K, N, symmetrize)
        xp = _matvec(Ftab, x_mix, n)
        Pp = _predict_cov(Ftab, P_mix, Qtab, n, symmetrize)
        inno = _innovation(Pp, Rtab, obs, n, m)
        xn, Pn, ll = _update(xp, Pp, z, obs, n, m, inno, True, symmetrize)
        mu_parts = _mode_posterior(cbar, ll, K, N)
        if valid is not None:
            v = valid[t].to(x.dtype)
            xn, Pn = _coast_select(torch.cat([v] * K), xn, Pn, xp, Pp,
                                   symmetrize)
            nv = 1.0 - v
            mu_parts = [v * a + nv * b for a, b in zip(mu_parts, cbar)]
        xv, Pl = _full(xn, Pn, mu_f)
        mu_f = torch.cat(mu_parts)
        xc = [_dot(mu_parts, [u[k * N:(k + 1) * N] for k in range(K)], K)
              for u in xv]
        out.append(torch.stack(xc, dim=-1))
    xs = torch.stack(out) if out else x.new_empty((0, N, n))
    x2, P2 = _from_lanes(xv, Pl)
    return (xs, x2.reshape(K, N, n), P2.reshape(K, N, n, n),
            mu_f.reshape(K, N).T.contiguous())
