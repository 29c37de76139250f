"""KATANA's graph rewrites (the paper's stage ladder) and their small-
matrix algebra, on torch tensors.

Eight stages, the reference's ``repro/core/rewrites.py`` on the card:

  ``baseline``          naive export: runtime Subtract and Transposes of
                        system matrices passed as runtime tensors, dummy
                        batch axes, the generic ``torch.linalg.inv_ex``.
  ``opt1``              Subtract elimination (paper §IV-B): ``H_neg``
                        turns every innovation / covariance subtraction
                        into a GEMM + Add.
  ``opt2``              Static tensor fusion (paper §IV-C): folded
                        constants, no dummy axes, closed-form cofactor
                        inversion.
  ``batched_blockdiag`` Paper §IV-D: N filters as one (N·n)x(N·n)
                        block-diagonal system of dense GEMMs (cuBLAS on
                        the card), its N^2 FLOP expansion kept.
  ``batched_lanes``     The filter index as a batch axis, the per-filter
                        n x n algebra as einsums: the same numbers at ~N^2
                        less compute.
  ``fused_scan``        ``katana_bank`` a step; ``run_sequence`` runs the
                        whole (T, N, m) stream as ``katana_bank_sequence``
                        (csrc/scan.cu: one launch).
  ``imm_bank``          K motion hypotheses as stacked lanes of
                        ``katana_bank_imm`` (csrc/imm_step.cu), the mixing
                        and mode posterior (below) between the launches.
  ``imm_scan``          ``katana_imm_sequence``: the whole IMM recursion
                        in one launch; K=1 is ``fused_scan``'s scan.

Every stage is the same filter; ``symmetrize`` (False by default, as in
the reference) picks the covariance contract. The stages take an explicit
``device`` (default ``"cuda"``, through ``repro_torch.resolve_device``);
``run_sequence`` loops over T on the host without synchronising.

The algebra: closed-form cofactor / Schur inversion and determinants for
m <= 4 (pure mul/add plus one reciprocal), the upper-triangle packing plan
for exactly symmetric covariance products, the IMM mixing /
mode-posterior / combination algebra, the Gaussian log-likelihood from a
precomputed S^{-1}, and the per-model constants the einsum route folds
in. Everything works on (..., m, m) batches in the reference's
(K, B, ...) model-major layout.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.filters import FilterModel, as_imm, device_const

STAGES = ("baseline", "opt1", "opt2", "batched_blockdiag", "batched_lanes",
          "fused_scan", "imm_bank", "imm_scan")


def inv1(M):
    return 1.0 / M


def inv2(M):
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    rdet = 1.0 / (a * d - b * c)
    row0 = torch.stack([d * rdet, -b * rdet], dim=-1)
    row1 = torch.stack([-c * rdet, a * rdet], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def inv3(M):
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    c10 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
    c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
    c12 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
    c20 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c21 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
    c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    rdet = 1.0 / (m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02)
    rows = [
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ]
    return torch.stack(rows, dim=-2) * rdet[..., None, None]


def inv4(M):
    """2x2-block Schur-complement inversion; mul/add + inv2 reciprocals."""
    A = M[..., :2, :2]
    B = M[..., :2, 2:]
    C = M[..., 2:, :2]
    D = M[..., 2:, 2:]
    Di = inv2(D)
    BDi = B @ Di
    S = A - BDi @ C  # Schur complement
    Si = inv2(S)
    SiBDi = Si @ BDi
    DiC = Di @ C
    top = torch.cat([Si, -SiBDi], dim=-1)
    bot = torch.cat([-DiC @ Si, Di + DiC @ SiBDi], dim=-1)
    return torch.cat([top, bot], dim=-2)


_SMALL_INV = {1: inv1, 2: inv2, 3: inv3, 4: inv4}


@functools.lru_cache(maxsize=None)
def triu_pack(n: int):
    """Upper-triangle packing plan: (rows, cols, mirror) where
    rows/cols index the packed (i <= j) entries and ``mirror[i, j]`` is
    the packed index of (min(i,j), max(i,j)) — ``tri[..., mirror]``
    unpacks a (..., T) triangle into the (..., n, n) symmetric matrix
    with aliased (exactly equal) mirrors."""
    rows, cols = np.triu_indices(n)
    mirror = np.zeros((n, n), np.int64)
    for t, (i, j) in enumerate(zip(rows, cols)):
        mirror[i, j] = mirror[j, i] = t
    return rows, cols, mirror


def triu_index(n: int, device):
    """``triu_pack(n)``'s (rows, cols) as index tensors on ``device``,
    made once per (n, device) (``filters.device_const``)."""
    rows, cols, _ = triu_pack(n)
    return (device_const(None, f"triu{n} rows", rows, torch.int64, device),
            device_const(None, f"triu{n} cols", cols, torch.int64, device))


def sym_unpack(tri, n: int):
    """(..., n(n+1)/2) packed upper triangle -> (..., n, n)."""
    idx = device_const(None, f"triu{n} mirror", lambda: triu_pack(n)[2],
                       torch.int64, tri.device)
    return tri[..., idx]


def small_inv(M, dim: int):
    if dim in _SMALL_INV:
        return _SMALL_INV[dim](M)
    return torch.linalg.inv(M)


def small_det(M, dim: int):
    """Closed-form determinant of a (..., dim, dim) batch, dim <= 4."""
    if dim == 1:
        return M[..., 0, 0]
    if dim == 2:
        return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    if dim == 3:
        m = [[M[..., i, j] for j in range(3)] for i in range(3)]
        return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
                + m[0][1] * (m[1][2] * m[2][0] - m[1][0] * m[2][2])
                + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if dim == 4:
        D = M[..., 2:, 2:]
        S = M[..., :2, :2] - M[..., :2, 2:] @ inv2(D) @ M[..., 2:, :2]
        return small_det(D, 2) * small_det(S, 2)
    return torch.linalg.det(M)


_LOG_2PI = float(np.log(2.0 * np.pi))


def imm_mix(x, P, mu, Pi):
    """IMM interaction (mixing). x: (K, B, n); P: (K, B, n, n);
    mu: (B, K); Pi: (K, K). Returns (x_mix (K, B, n), P_mix (K, B, n, n),
    cbar (B, K)) with cbar = mu @ Pi; the tiny-clamped denominator keeps
    an unreachable mode's 0/0 finite."""
    cbar = mu @ Pi                                           # (B, K)
    cbar_safe = torch.clamp_min(cbar, torch.finfo(cbar.dtype).tiny)
    w = mu[:, :, None] * Pi[None, :, :] / cbar_safe[:, None, :]  # (B, i, j)
    x_mix = torch.einsum("bij,ibd->jbd", w, x)
    dx = x[:, None] - x_mix[None, :]                         # (i, j, B, n)
    P_mix = (torch.einsum("bij,ibuv->jbuv", w, P)
             + torch.einsum("bij,ijbu,ijbv->jbuv", w, dx, dx))
    return x_mix, P_mix, cbar


def imm_mode_posterior(cbar, loglik):
    """mu'_k ∝ cbar_k exp(loglik_k - max loglik). cbar: (B, K);
    loglik: (K, B). Returns (B, K), rows summing to 1."""
    ll = loglik.transpose(0, 1)                              # (B, K)
    w = cbar * torch.exp(ll - ll.max(dim=1, keepdim=True).values)
    return w / w.sum(dim=1, keepdim=True)


def imm_combine(x, P, mu):
    """Moment-matched combined estimate. x: (K, B, n); P: (K, B, n, n);
    mu: (B, K) -> (x_c (B, n), P_c (B, n, n))."""
    x_c = torch.einsum("bk,kbd->bd", mu, x)
    dx = x - x_c[None]                                       # (K, B, n)
    P_c = (torch.einsum("bk,kbuv->buv", mu, P)
           + torch.einsum("bk,kbu,kbv->buv", mu, dx, dx))
    return x_c, P_c


def gaussian_loglik(y, Sinv, logdetS, m: int):
    """log N(y; 0, S) from the innovation y (..., m), the precomputed
    S^{-1} (..., m, m) and log det S (...)."""
    d = torch.einsum("...u,...uv,...v->...", y, Sinv, y)
    return -0.5 * (d + logdetS + m * _LOG_2PI)


@dataclass(frozen=True)
class StageConstants:
    """Per-model constants the einsum route folds in."""

    F: torch.Tensor
    H: torch.Tensor
    H_neg: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor


def stage_constants(model: FilterModel, dtype=torch.float32,
                    device="cpu") -> StageConstants:
    """The model's constants on ``device``, made once per (model, dtype,
    device) by ``filters.device_const`` and shared (never written
    into)."""
    def t(name, a):
        return device_const(model, name, a, dtype, device)

    return StageConstants(F=t("F", model.F), H=t("H", model.H),
                          H_neg=t("-H", lambda: -np.asarray(model.H)),
                          Q=t("Q", model.Q), R=t("R", model.R))


def block_diag_batched(blocks: torch.Tensor) -> torch.Tensor:
    """(N, a, b) -> (N*a, N*b) block-diagonal (paper §IV-D expansion)."""
    N, a, b = blocks.shape
    out = blocks.new_zeros((N, a, N, b))
    idx = torch.arange(N, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(N * a, N * b)


def block_diag_const(M: np.ndarray, N: int) -> np.ndarray:
    """kron(I_N, M): replicate one block N times on the diagonal."""
    return np.kron(np.eye(N), M)


def extract_diag_blocks(M: torch.Tensor, N: int, b: int) -> torch.Tensor:
    """(N*b, N*b) -> (N, b, b) diagonal blocks."""
    M4 = M.reshape(N, b, N, b)
    idx = torch.arange(N, device=M.device)
    return M4[idx, :, idx, :]


# ---------------------------------------------------------------------------
# Stage builders. Each returns (step, meta): step(x, P, z) -> (x, P) in the
# stage's layout (the IMM stages: step(x, P, z, mu) -> (x, P, mu)).
# ---------------------------------------------------------------------------

def build_baseline(model: FilterModel, dtype=torch.float32,
                   symmetrize: bool = False,
                   device="cuda") -> Tuple[Callable, Dict]:
    """Naive export. State: x (1, n, 1); P (1, n, n); z (1, m, 1).

    System matrices are runtime tensors (like un-folded initializers), so
    the Transposes, Subtracts and the generic inversion are real ops: the
    graph the paper's Fig. 3 calls Baseline."""
    n, m = model.n, model.m
    C = stage_constants(model, dtype, resolve_device(device))
    sys = dict(F=C.F, H=C.H, Q=C.Q, R=C.R)

    def step(x, P, z, sys=sys):
        F, H, Q, R = sys["F"], sys["H"], sys["Q"], sys["R"]
        # exporter-style shape bookkeeping (Squeeze / Unsqueeze / Reshape)
        xs = torch.reshape(x, (1, n))
        if model.is_linear:
            x_pred = torch.matmul(F, xs.unsqueeze(-1))   # (n,n)@(1,n,1)
        else:
            x_pred = model.predict_mean(xs).unsqueeze(-1)
        Fk = model.jacobian(xs)                          # (1, n, n)
        P_pred = torch.matmul(torch.matmul(Fk, P), Fk.transpose(1, 2)) + Q
        # innovation with a runtime Subtract (the op the NPU's DSP eats)
        y = z - torch.matmul(H, x_pred)
        S = torch.matmul(torch.matmul(H, P_pred), H.T) + R
        # the generic inversion; inv_ex leaves out inv's check of the
        # result on the host, which would synchronise every step
        K = torch.matmul(torch.matmul(P_pred, H.T), torch.linalg.inv_ex(S)[0])
        x_new = x_pred + torch.matmul(K, y)
        I = torch.eye(n, dtype=dtype, device=x.device)
        P_new = torch.matmul(I - torch.matmul(K, H), P_pred)
        if symmetrize:
            P_new = 0.5 * (P_new + P_new.transpose(1, 2))
        return torch.reshape(x_new, (1, n, 1)), P_new

    meta = dict(stage="baseline", layout="dummy-batch", n=n, m=m)
    return step, meta


def build_opt1(model: FilterModel, dtype=torch.float32,
               symmetrize: bool = False,
               device="cuda") -> Tuple[Callable, Dict]:
    """Subtract elimination (paper §IV-B). Same layout as baseline, but
    every ``a - b`` becomes ``a + neg(b)`` with the negation folded into
    a precomputed constant: H_neg for the innovation, and the covariance
    update rewritten ``P = P_pred + K (H_neg P_pred)``."""
    n, m = model.n, model.m
    C = stage_constants(model, dtype, resolve_device(device))
    sys = dict(F=C.F, H=C.H, H_neg=C.H_neg, Q=C.Q, R=C.R)

    def step(x, P, z, sys=sys):
        F, H, H_neg = sys["F"], sys["H"], sys["H_neg"]
        Q, R = sys["Q"], sys["R"]
        xs = torch.reshape(x, (1, n))
        if model.is_linear:
            x_pred = torch.matmul(F, xs.unsqueeze(-1))
        else:
            x_pred = model.predict_mean(xs).unsqueeze(-1)
        Fk = model.jacobian(xs)
        P_pred = torch.matmul(torch.matmul(Fk, P), Fk.transpose(1, 2)) + Q
        # subtract-free innovation: z + H_neg x̂
        y = z + torch.matmul(H_neg, x_pred)
        S = torch.matmul(torch.matmul(H, P_pred), H.T) + R
        K = torch.matmul(torch.matmul(P_pred, H.T), torch.linalg.inv_ex(S)[0])
        x_new = x_pred + torch.matmul(K, y)
        # subtract-free covariance: P + K (H_neg P)
        P_new = P_pred + torch.matmul(K, torch.matmul(H_neg, P_pred))
        if symmetrize:
            P_new = 0.5 * (P_new + P_new.transpose(1, 2))
        return torch.reshape(x_new, (1, n, 1)), P_new

    meta = dict(stage="opt1", layout="dummy-batch", n=n, m=m)
    return step, meta


def build_opt2(model: FilterModel, dtype=torch.float32,
               symmetrize: bool = False,
               device="cuda") -> Tuple[Callable, Dict]:
    """Static tensor fusion (paper §IV-C). State: x (n,); P (n, n);
    z (m,). The system matrices and their transposes are folded
    constants; no dummy axes; cofactor inversion. The steady-state graph
    is dot/add/mul only."""
    n, m = model.n, model.m
    C = stage_constants(model, dtype, resolve_device(device))
    FT, HT = C.F.T.contiguous(), C.H.T.contiguous()

    def step(x, P, z):
        if model.is_linear:
            x_pred = C.F @ x
            P_pred = C.F @ P @ FT + C.Q
        else:
            x_pred = model.predict_mean(x)
            Fk = model.jacobian(x)
            P_pred = Fk @ P @ Fk.transpose(-1, -2) + C.Q
        y = z + C.H_neg @ x_pred
        PHt = P_pred @ HT
        S = C.H @ PHt + C.R
        K = PHt @ small_inv(S, m)
        x_new = x_pred + K @ y
        P_new = P_pred + K @ (C.H_neg @ P_pred)
        if symmetrize:
            P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
        return x_new, P_new

    meta = dict(stage="opt2", layout="flat", n=n, m=m)
    return step, meta


def build_batched_blockdiag(model: FilterModel, N: int, dtype=torch.float32,
                            symmetrize: bool = False,
                            device="cuda") -> Tuple[Callable, Dict]:
    """Paper §IV-D, faithful: every per-filter matrix expanded into an
    (N·n)x(N·n) block-diagonal system matrix, ONE dense GEMM chain per
    step. State: x (N*n,); P (N*n, N*n); z (N*m,).

    For the LKF every block-diagonal system matrix is a constant; for the
    EKF the Jacobian blocks are rebuilt each step and scattered onto the
    diagonal, as the paper rebuilds its per-frame Jacobians. S is
    inverted blockwise (cofactor) and scattered back to dense: exact,
    where a dense (N·m) inversion would change the numerics class."""
    n, m = model.n, model.m
    Nn = N * n
    dev = resolve_device(device)

    def bd(M):
        return torch.as_tensor(block_diag_const(M, N), dtype=dtype,
                               device=dev)

    F_bd, H_bd, Q_bd = bd(model.F), bd(model.H), bd(model.Q)
    FT_bd, HT_bd = F_bd.T.contiguous(), H_bd.T.contiguous()
    Hneg_bd = -H_bd
    R = torch.as_tensor(np.asarray(model.R), dtype=dtype, device=dev)
    R_bd = block_diag_batched(R.expand(N, m, m))

    def step(x, P, z):
        if model.is_linear:
            x_pred = F_bd @ x
            # dense (Nn)^3 GEMMs: the paper's N^2 FLOP expansion, kept
            P_pred = F_bd @ P @ FT_bd + Q_bd
        else:
            xs = x.reshape(N, n)
            x_pred = model.predict_mean(xs).reshape(Nn)
            Fk_bd = block_diag_batched(model.jacobian(xs))
            P_pred = Fk_bd @ P @ Fk_bd.T + Q_bd
        y = z + Hneg_bd @ x_pred
        PHt = P_pred @ HT_bd
        S = H_bd @ PHt + R_bd  # (Nm, Nm), block-diagonal by construction
        S_blocks = extract_diag_blocks(S, N, m)
        Sinv_bd = block_diag_batched(small_inv(S_blocks, m))
        K = PHt @ Sinv_bd
        x_new = x_pred + K @ y
        P_new = P_pred + K @ (Hneg_bd @ P_pred)
        if symmetrize:
            P_new = 0.5 * (P_new + P_new.T)
        return x_new, P_new

    meta = dict(stage="batched_blockdiag", layout="blockdiag", n=n, m=m, N=N)
    return step, meta


def build_batched_lanes(model: FilterModel, N: int, dtype=torch.float32,
                        symmetrize: bool = False,
                        device="cuda") -> Tuple[Callable, Dict]:
    """The filter index as a batch axis, the per-filter n x n algebra as
    einsums. State: x (N, n); P (N, n, n); z (N, m). The numbers of
    ``batched_blockdiag`` at ~N^2 less covariance compute; the semantics
    of the ``katana_bank`` kernels.

    Under ``symmetrize`` the covariance products are emitted upper
    triangle only with aliased mirrors (``triu_pack``), the kernels'
    symmetrize=True contract; ``symmetrize=False`` keeps the full square
    (an asymmetry of the float products is kept)."""
    n, m = model.n, model.m
    dev = resolve_device(device)
    C = stage_constants(model, dtype, dev)
    iu, ju = triu_index(n, dev)

    def step(x, P, z):
        if model.is_linear:
            x_pred = torch.einsum("ij,kj->ki", C.F, x)
            FP = torch.einsum("ij,kjl->kil", C.F, P)
            if symmetrize:
                P_pred = sym_unpack(
                    torch.einsum("ktl,tl->kt", FP[:, iu, :], C.F[ju, :])
                    + C.Q[iu, ju], n)
            else:
                P_pred = torch.einsum("kil,jl->kij", FP, C.F) + C.Q
        else:
            x_pred = model.predict_mean(x)
            Fk = model.jacobian(x)  # (N, n, n)
            FP = torch.einsum("kij,kjl->kil", Fk, P)
            if symmetrize:
                P_pred = sym_unpack(
                    torch.einsum("ktl,ktl->kt", FP[:, iu, :], Fk[:, ju, :])
                    + C.Q[iu, ju], n)
            else:
                P_pred = torch.einsum("kil,kjl->kij", FP, Fk) + C.Q
        y = z + torch.einsum("mi,ki->km", C.H_neg, x_pred)
        PHt = torch.einsum("kij,mj->kim", P_pred, C.H)
        S = torch.einsum("mi,kij,nj->kmn", C.H, P_pred, C.H) + C.R
        K = torch.einsum("kim,kmn->kin", PHt, small_inv(S, m))
        x_new = x_pred + torch.einsum("kin,kn->ki", K, y)
        HnP = torch.einsum("mi,kij->kmj", C.H_neg, P_pred)
        if symmetrize:
            P_new = sym_unpack(
                P_pred[:, iu, ju]
                + torch.einsum("ktm,kmt->kt", K[:, iu, :], HnP[:, :, ju]), n)
        else:
            P_new = P_pred + torch.einsum("kim,kmj->kij", K, HnP)
        return x_new, P_new

    meta = dict(stage="batched_lanes", layout="batched", n=n, m=m, N=N)
    return step, meta


def build_fused_scan(model: FilterModel, N: int, dtype=torch.float32,
                     symmetrize: bool = False,
                     device="cuda") -> Tuple[Callable, Dict]:
    """The ``katana_bank`` kernel as a stage (csrc/imm_step.cu at K = 1).
    State: x (N, n); P (N, n, n); z (N, m), the canonical layout of
    batched_lanes. The sequence view (``run_sequence``) launches the scan
    kernel once for the whole stream (``katana_bank_sequence``). The
    kernel computes in float32 whatever ``dtype``; its device is its
    tensors'."""
    from repro_torch.kernels.katana_bank import ops

    n, m = model.n, model.m

    def step(x, P, z):
        return ops.katana_bank(model, x, P, z, symmetrize=symmetrize)

    meta = dict(stage="fused_scan", layout="batched", n=n, m=m, N=N)
    return step, meta


def build_imm_bank(model, N: int, dtype=torch.float32,
                   symmetrize: bool = True,
                   device="cuda") -> Tuple[Callable, Dict]:
    """The IMM multi-model bank as a stage; a plain FilterModel is a
    degenerate K=1 IMM (``as_imm``). The step carries the mode
    probabilities: ``step(x (K, N, n), P (K, N, n, n), z (N, m),
    mu (N, K)) -> (x', P', mu')``, one IMM cycle: mix -> the multi-model
    kernel (``katana_bank_imm``: predict+update+log-likelihood, stacked
    lanes) -> mode posterior. ``run_sequence`` adapts it to the canonical
    (N, n) layout by combining the per-model estimates each frame."""
    from repro_torch.kernels.katana_bank import ops

    imm = as_imm(model)
    Pi = torch.as_tensor(np.asarray(imm.trans), dtype=dtype,
                         device=resolve_device(device))

    def step(x, P, z, mu):
        x_mix, P_mix, cbar = imm_mix(x, P, mu, Pi)
        x_new, P_new, loglik = ops.katana_bank_imm(
            imm, x_mix.contiguous(), P_mix.contiguous(), z,
            symmetrize=symmetrize)
        mu_new = imm_mode_posterior(cbar, loglik)
        return x_new, P_new, mu_new

    meta = dict(stage="imm_bank", layout="model-major", n=imm.n, m=imm.m,
                N=N, K=imm.K)
    return step, meta


def build_imm_scan(model, N: int, dtype=torch.float32,
                   symmetrize: bool = True,
                   device="cuda") -> Tuple[Callable, Dict]:
    """The fused IMM scan as a stage: ``imm_bank``'s step signature, but
    the whole cycle (mixing, the K predict+updates, the mode posterior)
    is one ``katana_imm_sequence`` launch (at T=1 here; ``run_sequence``
    launches the whole stream at once). K=1 is ``fused_scan``'s scan."""
    from repro_torch.kernels.katana_bank import ops

    imm = as_imm(model)

    def step(x, P, z, mu):
        _, (x2, P2, mu2) = ops.katana_imm_sequence(
            imm, z[None], x, P, mu0=mu, symmetrize=symmetrize,
            return_final=True)
        return x2, P2, mu2

    meta = dict(stage="imm_scan", layout="model-block", n=imm.n, m=imm.m,
                N=N, K=imm.K)
    return step, meta


def build_stage(model: FilterModel, stage: str, N: Optional[int] = None,
                dtype=torch.float32, symmetrize: bool = False,
                device="cuda"):
    """Uniform entry point; returns (step, meta)."""
    if stage == "baseline":
        return build_baseline(model, dtype, symmetrize, device)
    if stage == "opt1":
        return build_opt1(model, dtype, symmetrize, device)
    if stage == "opt2":
        return build_opt2(model, dtype, symmetrize, device)
    builders = dict(batched_blockdiag=build_batched_blockdiag,
                    batched_lanes=build_batched_lanes,
                    fused_scan=build_fused_scan, imm_bank=build_imm_bank,
                    imm_scan=build_imm_scan)
    if stage in builders:
        assert N is not None
        return builders[stage](model, N, dtype, symmetrize, device)
    raise KeyError(f"unknown stage {stage!r}; known: {STAGES}")


# ---------------------------------------------------------------------------
# Layout adapters: every stage runs under run_sequence() in the canonical
# (N, n) / (N, n, n) layout.
# ---------------------------------------------------------------------------

def canonical_to_stage(stage: str, x, P, z, n: int, m: int):
    if stage in ("baseline", "opt1"):
        return x.reshape(1, n, 1), P.reshape(1, n, n), z.reshape(1, m, 1)
    if stage == "opt2":
        return x.reshape(n), P.reshape(n, n), z.reshape(m)
    if stage == "batched_blockdiag":
        N = x.shape[0]
        return x.reshape(N * n), block_diag_batched(P), z.reshape(N * m)
    return x, P, z  # batched_lanes / fused_scan are canonical


def stage_to_canonical(stage: str, x, P, n: int, m: int, N: int):
    if stage in ("baseline", "opt1", "opt2"):
        return x.reshape(1, n), P.reshape(1, n, n)
    if stage == "batched_blockdiag":
        return x.reshape(N, n), extract_diag_blocks(P, N, n)
    return x, P


def run_sequence(model: FilterModel, stage: str, zs, x0, P0,
                 dtype=torch.float32, symmetrize: bool = False,
                 device="cuda"):
    """Drive a stage over a (T, N, m) measurement sequence (numpy or
    torch). x0: (N, n); P0: (N, n, n). N must be 1 for the single-filter
    stages. Returns the (T, N, n) filtered states on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    zs, x0, P0 = t(zs), t(x0), t(P0)
    T, N, m = zs.shape
    n = model.n
    if stage in ("baseline", "opt1", "opt2"):
        assert N == 1, f"stage {stage} is single-filter"
    if stage == "fused_scan":
        # sequence-native: one scan launch for the whole stream
        from repro_torch.kernels.katana_bank import ops

        return ops.katana_bank_sequence(model, zs, x0, P0,
                                        symmetrize=symmetrize)
    if stage == "imm_bank":
        # (x0, P0) seed every mode alike; the track is the moment-matched
        # combined estimate
        from repro_torch.kernels.katana_bank import ops

        return ops.imm_bank_sequence(as_imm(model), zs, x0, P0,
                                     symmetrize=symmetrize)
    if stage == "imm_scan":
        # the whole stream, mixing and mode posterior included, in one
        # launch
        from repro_torch.kernels.katana_bank import ops

        return ops.katana_imm_sequence(as_imm(model), zs, x0, P0,
                                       symmetrize=symmetrize)
    step, _ = build_stage(model, stage, N=N, dtype=dtype,
                          symmetrize=symmetrize, device=dev)
    x, P, _ = canonical_to_stage(stage, x0, P0, zs.new_zeros((N, m)), n, m)
    # canonical_to_stage's layout of z alone
    z_shape = {"baseline": (1, m, 1), "opt1": (1, m, 1), "opt2": (m,),
               "batched_blockdiag": (N * m,)}.get(stage, (N, m))
    out = []
    for z_t in zs:
        x, P = step(x, P, z_t.reshape(z_shape))
        out.append(stage_to_canonical(stage, x, P, n, m, N)[0])
    return torch.stack(out) if out else zs.new_empty((0, N, n))
