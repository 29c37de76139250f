"""Small-matrix algebra of the KATANA rewrites, on torch tensors.

Closed-form cofactor / Schur inversion and determinants for m <= 4
(pure mul/add plus one reciprocal), the upper-triangle packing plan for
exactly symmetric covariance products, the IMM mixing / mode-posterior /
combination algebra, the Gaussian log-likelihood from a precomputed
S^{-1}, and the per-model constants the einsum route folds in.
Everything works on (..., m, m) batches in the reference's
(K, B, ...) model-major layout.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.filters import FilterModel


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


def sym_unpack(tri, n: int):
    """(..., n(n+1)/2) packed upper triangle -> (..., n, n)."""
    _, _, mirror = triu_pack(n)
    idx = torch.as_tensor(mirror, device=tri.device)
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
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    F = t(model.F)
    H = t(model.H)
    return StageConstants(F=F, H=H, H_neg=-H, Q=t(model.Q), R=t(model.R))
